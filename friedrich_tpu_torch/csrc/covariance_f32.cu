// float32 instantiations of the covariance-tile kernel (covariance.cuh): a
// file of its own, so that nvcc builds it in parallel with the others.

#include "covariance.cuh"

namespace friedrich {

template int launch_method<float, GRAM>(const CovArgs<float>&, int,
                                        const LeafConsts&, const CovProgram&,
                                        cudaStream_t);
template int launch_method<float, GRAM_BF16>(const CovArgs<float>&, int,
                                             const LeafConsts&,
                                             const CovProgram&, cudaStream_t);
template int launch_method<float, DIRECT>(const CovArgs<float>&, int,
                                          const LeafConsts&, const CovProgram&,
                                          cudaStream_t);

}  // namespace friedrich

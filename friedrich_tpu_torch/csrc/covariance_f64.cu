// float64 instantiations of the covariance-tile kernel (covariance.cuh): a
// file of its own, so that nvcc builds it in parallel with the others.

#include "covariance.cuh"

namespace friedrich {

template int launch_method<double, GRAM>(const CovArgs<double>&, int,
                                         const LeafConsts&, const CovProgram&,
                                         cudaStream_t);
template int launch_method<double, GRAM_BF16>(const CovArgs<double>&, int,
                                              const LeafConsts&,
                                              const CovProgram&, cudaStream_t);
template int launch_method<double, DIRECT>(const CovArgs<double>&, int,
                                           const LeafConsts&,
                                           const CovProgram&, cudaStream_t);

}  // namespace friedrich

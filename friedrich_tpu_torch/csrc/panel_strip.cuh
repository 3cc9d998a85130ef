// Panel-strip kernel for NVIDIA Hopper (sm_90a): the kernels, instantiated
// by panel_strip.cu (float32 3xTF32, float64), panel_strip_1pass.cu (float32
// under the factor precision "bf16") and panel_strip_bf16.cu (a bfloat16
// prefix), each built by its own nvcc.
//
// Replaces the Pallas TPU kernel `_fused_panel_strip_impl` with its body
// `_fused_body` (friedrich_tpu/ops/pallas/panel_fused.py:51-177). For the
// panel at column offset j0 and width B of the left-looking streamed
// Cholesky (friedrich_tpu_torch/ops/streamed.py), one launch writes the
// (cap - j0, B) pre-factor strip
//
//   S = K(X[j0:], X[j0:j0+B])  -  L[j0:, :j0] . L[j0:j0+B, :j0]^T
//
// where K is the padded training covariance: the kernel map (program.cuh),
// the analytic diagonal k(x, x) + noise^2 from diagonal features
// (sqdist = dist = 0, dot = |x|^2), and the identity outside the live
// n x n block, decided from the global indices row0 + i and col0 + j.
//
// Bound. Per launch the downdate is 2 (cap - j0) B j0 operations against
// ((cap - j0) j0 + B j0 + (cap - j0) B) elements moved: thousands of
// operations per byte at the main-path shapes (cap 100,512, B ~ 1,400), so
// the kernel is bound by arithmetic. Summed over a factorization the
// downdates are about cap^3 / 3 operations.
//
// Accumulation. The tensor cores' own accumulation keeps fewer bits than
// float32: on an H100, one accumulator chained through the whole
// contraction gave errors growing as j0^2. So every float32 tensor-core
// kernel here sums a bounded run of products in a fresh tensor-core
// accumulator and adds it into a float32 register accumulator on the CUDA
// cores (a "promotion").
//
// float32: 3xTF32 (panel_strip_tf32x3_kernel). The float32 SIMT rate (67
// TFLOP/s) caps a CUDA-core loop well below cuBLAS; the tensor cores give
// 495 TFLOP/s in TF32, which keeps 10 mantissa bits. Each operand is split
// as a = a_hi + a_lo, a_hi = tf32(a), a_lo = tf32(a - a_hi), both rounded to
// nearest (cvt.rna), and the product is a_lo b_hi + a_hi b_lo + a_hi b_hi,
// small terms first. Per product the dropped a_lo b_lo and the rounding of
// the low parts leave at most 3 * 2^-22 (1 + 2^-11)^2 |a b| < 2^-20 |a b|
// (|a - a_hi| <= 2^-11 |a|, |a - a_hi - a_lo| <= 2^-22 |a|), on top of
// float32 accumulation: the tolerance the kernel is held to adds
// 2^-20 (|L_tail| |L_rows|^T). Both parts are written explicitly, so
// nothing depends on how the tensor cores read the low 13 bits of a
// float32. Each 32-deep stage (96 products) is promoted. Tensor-core bound:
// three TF32 products, 3 * 2 (cap - j0) B j0 / 495 TFLOP/s.
//
// Design of the 3xTF32 kernel. One block per 128 x 128 output tile, 256
// threads: two warpgroups of 64 rows each. Both operands are row blocks of
// the row-major factor with the contraction along a row, i.e. K-major as
// they stand, which is the only layout TF32 wgmma takes, so they load
// straight from L into a ring of 6 stages, each with a full mbarrier:
// - TMA (capacity % 4 == 0): one tensor map over the strip's rows
//   L[j0:cap, 0:j0], built on the host per launch, 128 x 32 boxes with the
//   128-byte swizzle, issued by thread 0. The column extent is clipped to
//   j0, so TMA's out-of-bounds zero fill is the contraction mask (columns
//   >= j0, which a reused factor buffer may hold, are never read), and the
//   row extent to cap - j0 zero-fills the ragged rows.
// - cp.async (any other capacity, whose rows are not 16-byte aligned):
//   every thread copies its share into the same swizzled layout with zero
//   fill and arrives on the same barrier; the multiply does not know which
//   path fed it.
// A slot is refilled, STAGES stages ahead, right after the named barrier
// at which both warpgroups have retired it. No separate producer warp: the
// register file is split over the SM's four sub-partitions (16,384 each),
// so a ninth warp puts three warps on one of them and caps every thread at
// 168 registers, where the two accumulators and the A fragments need ~200
// (they spilled; asking for more registers got the launch refused).
// Shared memory, not the tensor cores, bounds a design that splits both
// operands in shared memory and feeds wgmma from there: the split's writes
// and wgmma's operand reads together saturate it. So A comes from
// registers: each thread loads its own wgmma A fragment from the raw stage
// and splits it in registers; only B, which both warpgroups read, is split
// in shared memory (b_hi in place, b_lo into one of two low-part buffers,
// flat float4 passes: the split is elementwise, so the swizzle carries
// over). Per stage: issue the stage's 12 wgmma.mma_async m64n128k8 tf32 (4
// k-steps of 8, three products each) as one group; while it runs, prepare
// the next stage (wait for it, split its B, load its A fragments); retire
// the group, add it into the float32 accumulator, split the next A
// fragments, meet the other warpgroup at a named barrier, and refill the
// retired slot. 6 x 32 KB + 2 x 16 KB of shared memory. Epilogue: the
// accumulator tile goes to shared memory; a rolled loop over it computes
// each entry's features, kernel map and diagonal and identity rules, and
// stores `map - acc` once, masking rows and columns past the strip,
// consecutive threads on consecutive columns. j0 = 0 is the same kernel
// with no mainloop.
//
// bfloat16 products (panel_strip_ws_kernel): the factor storage "bf16" (a
// bfloat16 prefix, FEED_BF16) and the factor precision "bf16" (a float32
// prefix whose operands are rounded to bfloat16, round to nearest even,
// FEED_F32). Each product of two bfloat16 values is exact in float32 and
// the sums are float32, so both are wgmma.mma_async m64n128k16 bf16 with a
// float32 accumulator. Tensor-core bound: one bf16 product, 2 (cap - j0) B
// j0 / 989 TFLOP/s. What holds a 128 x 128 tile short of that is the
// operands' way in, not the multiply: at 989 TFLOP/s the blocks would pull
// ~15 TB/s of operand tiles out of L2, and the kernel's measured rate, ~370
// TFLOP/s at the middle panels, is ~5.6 TB/s of them (PERF.md). The design:
// - Warp specialization: 384 threads, two consumer warpgroups (64 rows of
//   the tile each) and one producer warpgroup; setmaxnreg gives the
//   consumers 232 registers and the producer 40 (224 and 56 where the
//   producer does plain loads; the block must start at 168 a thread, which
//   chip_smoke.py checks in ptxas's report and the launch checks). A ring of
//   stages has a full and an empty mbarrier per slot; a consumer warpgroup
//   releases a slot by arriving on its empty barrier once the wgmma group
//   that read it has retired, and the producer refills it when both have.
//   No block-wide barrier in the mainloop.
// - Overlap: one wgmma group stays in flight (wait_group 1), so the issue
//   of the next stage and the release of the last overlap the tensor
//   cores' work. ptxas serializes every wgmma of a kernel (a wait after
//   each k-step) when it inserts one of its own waits in what it takes for
//   a divergent path. So nothing around a wgmma or its accumulator
//   branches on the thread: the warpgroup index comes through __shfl_sync,
//   the barrier waits are PTX loops, the arrivals predicated, and the
//   promotion follows a loop over a chunk of PROMOTE stages instead of
//   sitting under a condition. (The FEED_F32 instantiations are still
//   serialized, C7513: ptxas takes the conversion of the next stage's A
//   fragments, which overlaps the group in flight, for a write to a wgmma's
//   input.)
// - SERIAL: the same mainloop with its promotion under a condition, the two
//   warpgroups' intervals half an interval apart, which ptxas serializes
//   (C7518): one k-step in flight per warpgroup. On the card it is
//   1.15-1.25x faster than the asynchronous loop (and the previous design)
//   on a bfloat16 factor read in place at capacities of 130,512 and more,
//   and 1.1-1.2x slower at 120,512 and below and on explicit prefixes
//   (PERF.md); why is not known (a contiguous copy of the B rows, a drain
//   after every k-step and 6 stages did not reproduce it). launch_ws takes
//   it for a bfloat16 factor whose row stride is SERIAL_MIN_LD or more.
// - Promotion: each chunk of PROMOTE = 8 stages (512 products) is summed
//   in a fresh tensor-core accumulator and added into the float32 one.
//   Against float64 on the card (PERF.md), 128 and 256 products give less
//   error in the same time; one accumulator through the whole contraction,
//   hundreds of times more.
// - No clusters: 2-block clusters multicasting the B tile ran 1.1-1.7x
//   slower than single blocks on the card (PERF.md). The grid is 1-D, a
//   row tile with all its column tiles, then the next, so that the blocks
//   in flight share their A rows in L2.
// - Feeds. FEED_BF16: both operands bfloat16 TMA boxes of 128 x 64 with
//   the 128-byte swizzle, fed to wgmma from shared memory; 5 stages of 32
//   KB. FEED_F32: shared-memory bandwidth binds a design that converts
//   operands in shared memory (the conversion's reads and writes come on
//   top of TMA's writes and wgmma's reads), so A, the float32 rows of the
//   strip, arrives by TMA as two 128 x 32 float32 boxes per stage and each
//   thread converts its own wgmma A fragment in registers
//   (cvt.rn.bf16x2.f32, the value __float2bfloat16_rn gives), fed to wgmma
//   from registers; 3 stages of 48 KB. RING_BYTES leaves the rest of the
//   SM's shared memory to L1, which holds the epilogue's input rows.
// - Plain loads: where TMA cannot take the row stride (bfloat16 not a
//   multiple of 8 elements, float32 not of 4) the producer warpgroup loads
//   both operands with plain loads into FEED_BF16's swizzled layout,
//   rounding a float32 A to bfloat16 on the way, then arrives on the full
//   barrier; the consumers take A from shared memory for either feed (A
//   fragments in registers next to the plain-load producer spilled).
// - mbar_wait traps on a barrier stuck for seconds, so that a broken
//   pipeline fails the launch instead of hanging the card.
// The epilogue is the 3xTF32 kernel's (store_strip), after the consumers
// meet at a named barrier (the ring is then free).
//
// float64 (panel_strip_f64_kernel) replaces the Pallas kernel above in
// float64, the precision of the reference's f64 models and of the port's
// parity mode. Bound: the FP64 tensor cores, 2 (cap - j0) B j0 / 67 TFLOP/s
// on an H100 SXM (NVIDIA's data sheet; the CUDA cores give half that).
// wgmma has no float64 form; the FP64 tensor cores are reached by the
// warp-level mma.sync.m16n8k16.row.col.f64, each product an IEEE float64
// FMA, the sums float64, so no promotion: only the summation order differs
// from the plain version. Both operands are row blocks of the factor with
// the contraction along a row, which is the instruction's row.col form as
// they stand: no transpose. The design:
// - One 256-thread block per 128 x 128 output tile, eight warps of 64 x 32
//   (4 x 4 instructions of 16 x 8): 64 float64 accumulators, 128 registers,
//   a thread (four warps would need 256). A 1-D grid, a row tile with all
//   its column tiles, then the next, so that the blocks in flight share
//   their A rows in L2.
// - The feed: a ring of 3 stages of 64 KB, each two 128 x 16 boxes (one
//   128-byte row each) per operand in the 128-byte swizzle, with a full
//   mbarrier per slot. TMA (a float64 map, base and row stride 16-byte
//   aligned) from thread 0, the map's extents zero-filling rows past the
//   strip and columns past kdim (never read: a reused buffer holds an old
//   factor there); elsewhere (an odd capacity, an explicit prefix of odd
//   width) 8-byte cp.async from every thread into the same layout, zero
//   filled there too. A slot is refilled, 3 stages ahead, after the block
//   barrier at which every warp has read it.
// - The fragments: the contraction's order is free, so the instruction's k
//   index t + 4 j of thread t maps to box column 4 t + j in both operands:
//   each fragment row is four consecutive doubles, two 16-byte shared loads
//   that the swizzle keeps free of bank conflicts (ldmatrix moves 16-bit
//   elements only). Per 16-deep box a warp loads 24 x 16 bytes a thread and
//   issues 16 instructions.
// - The epilogue: the accumulators go to shared memory and strip_from_tile
//   computes the map, as in the float32 kernels.

#include <cuda.h>  // CUtensorMap and its enums only; the encoder comes from cudart

#include <cstdint>
#include <cstring>

#include "program.cuh"

namespace {

// Features of one (row, column) entry, as ops/distance.py computes them:
// gram: max(|a|^2 + |b|^2 - 2 a.b, 0); gram_bf16: the same with a.b from
// bfloat16-rounded products accumulated in float32; direct: sum (a - b)^2.
template <typename T, int METHOD>
__device__ __forceinline__ void entry_features(const T* __restrict__ a,
                                               const T* __restrict__ b, int d,
                                               bool need_sq, bool need_dist,
                                               T& dot, T& sq, T& dist) {
  T na = T(0), nb = T(0), dd = T(0), dsq = T(0);
  float dbf = 0.0f;
  for (int k = 0; k < d; ++k) {
    const T av = __ldg(a + k);
    const T bv = __ldg(b + k);
    if (METHOD == DIRECT) {
      const T diff = av - bv;
      dsq += diff * diff;
      dd += av * bv;
    } else {
      na += av * av;
      nb += bv * bv;
      if (METHOD == GRAM_BF16) {
        dbf += to_bf16_float(av) * to_bf16_float(bv);
      } else {
        dd += av * bv;
      }
    }
  }
  if (METHOD == GRAM_BF16) dd = static_cast<T>(dbf);
  dot = dd;
  sq = T(0);
  dist = T(0);
  if (need_sq) {
    sq = (METHOD == DIRECT) ? dsq : m_max0(na + nb - T(2) * dd);
    if (need_dist) dist = m_sqrt(sq);
  }
}

// One entry of the padded covariance at global (gr, gc): the identity
// outside the live block, the analytic diagonal plus noise^2 on it, the
// kernel map elsewhere.
template <typename T, int METHOD>
__device__ __forceinline__ T covariance_entry(const T* __restrict__ xr,
                                              const T* __restrict__ xc, int d,
                                              long long gr, long long gc, long long n,
                                              T noise2, int needs, int n_ops,
                                              const int* sops, const int* soffs,
                                              const T* sprm) {
  const bool diag = gr == gc;
  if (gr >= n || gc >= n) return diag ? T(1) : T(0);
  T dot, sq, dist;
  if (diag) {
    // diagonal features: dot = |x|^2, sqdist = dist = 0
    T nc = T(0);
    for (int k = 0; k < d; ++k) nc += __ldg(xc + k) * __ldg(xc + k);
    dot = nc;
    sq = T(0);
    dist = T(0);
  } else {
    entry_features<T, METHOD>(xr, xc, d, (needs & (NEED_SQ | NEED_DIST)) != 0,
                              (needs & NEED_DIST) != 0, dot, sq, dist);
  }
  T v = run_program<T>(n_ops, sops, soffs, sprm, dot, sq, dist);
  if (diag) v += noise2;
  return v;
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 wgmma fed by TMA or cp.async
// ---------------------------------------------------------------------------

namespace tc {
constexpr int BM = 128;                         // tile rows: two warpgroups of 64
constexpr int BN = 128;                         // tile columns: the wgmma N
constexpr int BK = 32;                          // contraction per stage: one 128-byte row
constexpr int STAGES = 6;                       // ring of loaded stages
constexpr int LO_BUFS = 2;                      // low parts of B
constexpr int THREADS = 256;                    // two warpgroups
constexpr int TILE_BYTES = BM * BK * 4;         // one operand of one stage, 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;     // A then B
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + LO_BUFS * TILE_BYTES + 1024;  // + alignment
static_assert(BM == BN, "one box shape serves both operands");
static_assert(BK * 4 == 128, "a stage row is one 128-byte swizzle row");
}  // namespace tc

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Waits for the phase of `bar` with the given parity. A wait of more than
// 2^34 cycles (seconds; a stage takes microseconds) traps, so that a broken
// pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  uint32_t done;
  do {
    if (clock64() - start > (1LL << 34)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// TMA: the (c0, c1) box of `map` (c0 along the contraction) into `dst`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// cp.async of one float, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (the stride
// byte offset); the leading byte offset is unused in this layout.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

// Keep the compiler from moving accumulator reads or writes, or reusing the
// A fragments' registers, across the asynchronous wgmma.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int j = 0; j < 64; ++j) asm volatile("" : "+f"(d[j])::"memory");
}

__device__ __forceinline__ void fence_frag(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[ks][i])::"memory");
}

// d = A (64 x 8, tf32) . B (128 x 8, tf32)^T (+ d if `accumulate`): A from
// registers (this thread's fragment, see `load_a`), B from shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// This thread's A fragments of one stage, as float32: for k-step ks,
// a[ks][0..3] = A[r][c], A[r + 8][c], A[r][c + 4], A[r + 8][c + 4] with
// r = 16 w + l / 4 of warp w of the warpgroup's 64 rows and c = 8 ks + l % 4
// (the wgmma tf32 A register layout), read from the 128-byte-swizzled tile:
// 16-byte chunk q of row r sits at chunk q ^ (r % 8).
__device__ __forceinline__ void load_a(const unsigned char* a_tile, int tid, float (&a)[4][4]) {
  const int w = (tid % 128) / 32, l = tid % 32;
  const int r = (tid / 128) * 64 + w * 16 + (l >> 2);
  const float* row0 = reinterpret_cast<const float*>(a_tile + r * 128);
  const float* row8 = reinterpret_cast<const float*>(a_tile + (r + 8) * 128);
  const int sw = r & 7, e = l & 3;  // rows r and r + 8 share the swizzle
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int q0 = ((2 * ks) ^ sw) * 4 + e, q1 = ((2 * ks + 1) ^ sw) * 4 + e;
    a[ks][0] = row0[q0];
    a[ks][1] = row8[q0];
    a[ks][2] = row0[q1];
    a[ks][3] = row8[q1];
  }
}

// Splits a loaded B tile: b_hi = tf32(b) in place, b_lo = tf32(b - b_hi) at
// the same offset of `lo`. Elementwise, so the swizzled layout carries over.
__device__ __forceinline__ void split_b(unsigned char* tile, unsigned char* lo, int tid) {
  float4* hi4 = reinterpret_cast<float4*>(tile);
  float4* lo4 = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int i = tid; i < tc::TILE_BYTES / 16; i += tc::THREADS) {
    const float4 v = hi4[i];
    float4 h, l;
    h.x = tf32_rna(v.x);
    h.y = tf32_rna(v.y);
    h.z = tf32_rna(v.z);
    h.w = tf32_rna(v.w);
    l.x = tf32_rna(v.x - h.x);
    l.y = tf32_rna(v.y - h.y);
    l.z = tf32_rna(v.z - h.z);
    l.w = tf32_rna(v.w - h.w);
    hi4[i] = h;
    lo4[i] = l;
  }
  // the generic writes, visible to wgmma's async-proxy reads
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Starts the load of stage k into its ring slot: TMA from thread 0 (the
// slot's full barrier expects the bytes; A through `amap`, B through
// `bmap`), or cp.async from every thread (each arrives once its copies have
// landed; A from `la`, row stride ldl, B from `lb`, row stride ldb).
template <bool TMA>
__device__ __forceinline__ void load_stage(unsigned char* smem, uint64_t* full_bar, int k,
                                           int tid, const CUtensorMap* amap,
                                           const CUtensorMap* bmap,
                                           const float* __restrict__ la,
                                           const float* __restrict__ lb, int m1, int m2,
                                           long long ldl, long long ldb, int kdim, int rbase,
                                           int cbase) {
  using namespace tc;
  const int s = k % STAGES;
  unsigned char* stage = smem + s * STAGE_BYTES;
  if (TMA) {
    if (tid == 0) {
      mbar_expect_tx(&full_bar[s], STAGE_BYTES);
      tma_load(stage, amap, &full_bar[s], k * BK, rbase);
      tma_load(stage + TILE_BYTES, bmap, &full_bar[s], k * BK, cbase);
    }
  } else {
    // the layout TMA writes: 16-byte chunk c / 4 of row r at chunk (c / 4) ^ (r % 8)
    const int k0 = k * BK;
    for (int e = tid; e < 2 * BM * BK; e += THREADS) {
      const int op = e / (BM * BK);
      const int r = (e / BK) % BM;
      const int c = e % BK;
      const int row = (op ? cbase : rbase) + r;
      const int kk = k0 + c;
      const bool valid = row < (op ? m2 : m1) && kk < kdim;
      const float* src = valid ? (op ? lb + (long long)row * ldb : la + (long long)row * ldl) + kk
                               : la;
      const int off = r * 128 + ((((c >> 2) ^ (r & 7)) << 4) | ((c & 3) << 2));
      cp_async4(stage + op * TILE_BYTES + off, src, valid);
    }
    cp_async_arrive(&full_bar[s]);
  }
}

__device__ __forceinline__ void split_a(const float (&a)[4][4], uint32_t (&hi)[4][4],
                                        uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float h = tf32_rna(a[ks][i]);
      hi[ks][i] = __float_as_uint(h);
      lo[ks][i] = __float_as_uint(tf32_rna(a[ks][i] - h));
    }
}

// Stage k ready for the multiply: waits for its load, splits its B in
// shared memory and loads this thread's A fragments.
__device__ __forceinline__ void prepare_stage(unsigned char* smem, uint64_t* full_bar, int k,
                                              int tid, float (&a)[4][4]) {
  using namespace tc;
  unsigned char* stage = smem + (k % STAGES) * STAGE_BYTES;
  mbar_wait(&full_bar[k % STAGES], (k / STAGES) & 1);
  split_b(stage + TILE_BYTES, smem + STAGES * STAGE_BYTES + (k % LO_BUFS) * TILE_BYTES, tid);
  load_a(stage, tid, a);
}

// The rolled loop of every epilogue: `tile` holds a BM x BN downdate in
// shared memory (row stride BN + 1); each entry's covariance (features,
// kernel map, diagonal and identity rules) minus it is stored once, masked
// to the strip, consecutive threads on consecutive columns. Rolled, so that
// no call and no live accumulator holds registers.
template <typename T, int METHOD, int BM, int BN, int THREADS>
__device__ __forceinline__ void strip_from_tile(const T* tile, int tid, int rbase, int cbase,
                                                const T* __restrict__ x1, const T* __restrict__ x2,
                                                T* __restrict__ out, int m1, int m2, int d,
                                                long long row0, long long col0, long long n,
                                                T noise, int needs, int n_ops, const int* sops,
                                                const int* soffs, const T* sprm) {
  const T noise2 = noise * noise;
#pragma unroll 1
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = rbase + e / BN, c = cbase + e % BN;
    if (r < m1 && c < m2) {
      const T v = covariance_entry<T, METHOD>(x1 + (long long)r * d, x2 + (long long)c * d, d,
                                              row0 + r, col0 + c, n, noise2, needs, n_ops, sops,
                                              soffs, sprm);
      out[(long long)r * m2 + c] = v - tile[(e / BN) * (BN + 1) + e % BN];
    }
  }
}

// Epilogue of the wgmma kernels. The accumulator tile goes to shared
// memory (the ring is free: every stage was consumed), accumulator j of
// thread (warp w, lane l) of warpgroup g at row 64 g + 16 w + l / 4 (+ 8
// for j % 4 >= 2), column 8 (j / 4) + 2 (l % 4) + j % 2; then
// strip_from_tile.
template <int METHOD>
__device__ __forceinline__ void store_strip(unsigned char* smem, const float (&acc)[64], int tid,
                                            int rbase, int cbase, const float* __restrict__ x1,
                                            const float* __restrict__ x2, float* __restrict__ out,
                                            int m1, int m2, int d, long long row0,
                                            long long col0, long long n, float noise,
                                            int needs, int n_ops, const int* sops,
                                            const int* soffs, const float* sprm) {
  using namespace tc;
  float* tile = reinterpret_cast<float*>(smem);  // BM x (BN + 1)
  {
    const int g = tid / 128, w = (tid % 128) / 32, l = tid % 32;
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int r = g * 64 + w * 16 + (l >> 2) + ((j & 2) ? 8 : 0);
      const int c = (j >> 2) * 8 + (l & 3) * 2 + (j & 1);
      tile[r * (BN + 1) + c] = acc[j];
    }
  }
  asm volatile("bar.sync 1, 256;" ::: "memory");
  strip_from_tile<float, METHOD, BM, BN, THREADS>(tile, tid, rbase, cbase, x1, x2, out, m1, m2, d,
                                                  row0, col0, n, noise, needs, n_ops, sops, soffs,
                                                  sprm);
}

// `amap` covers the strip's rows (A: m1 rows, row stride ldl, the first
// kdim columns) and `bmap` the panel's rows (B: m2 rows, row stride ldb),
// for the TMA path; `la` and `lb` point at their first elements (cp.async
// path). In the streamed factorization B is A's first m2 rows and both maps
// are one; a rank of the distributed factorization below the panel passes
// the panel's rows as their own operand.
template <int METHOD, bool TMA>
__global__ void __launch_bounds__(tc::THREADS, 1)
    panel_strip_tf32x3_kernel(const __grid_constant__ CUtensorMap amap,
                              const __grid_constant__ CUtensorMap bmap,
                              const float* __restrict__ x1, const float* __restrict__ x2,
                              const float* __restrict__ la, const float* __restrict__ lb,
                              float* __restrict__ out, int m1, int m2, int d, long long ldl,
                              long long ldb, int kdim, long long row0, long long col0,
                              long long n, float noise, int needs,
                              const __grid_constant__ CovProgram prog) {
  using namespace tc;
  extern __shared__ unsigned char smem_dyn[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ float sprm[MAX_PARAMS];
  __shared__ int sops[MAX_OPS];
  __shared__ int soffs[MAX_OPS];

  // stages and low-part buffers on 1024-byte boundaries (the swizzle atom)
  unsigned char* smem = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int rbase = blockIdx.y * BM;
  const int cbase = blockIdx.x * BN;
  const int num_k = (kdim + BK - 1) / BK;

  if (tid < MAX_PARAMS) sprm[tid] = static_cast<float>(prog.params[tid]);
  if (tid < MAX_OPS) {
    sops[tid] = prog.ops[tid];
    soffs[tid] = prog.offs[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full_bar[s], TMA ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int k = 0; k < STAGES && k < num_k; ++k) {
    load_stage<TMA>(smem, full_bar, k, tid, &amap, &bmap, la, lb, m1, m2, ldl, ldb, kdim, rbase,
                    cbase);
  }

  // Each stage's 32-deep product goes into a fresh tensor-core
  // accumulator `part` (the first wgmma of the stage does not
  // accumulate), which is then added into `acc` on the CUDA cores in
  // float32: the tensor cores' own accumulation keeps fewer bits than
  // float32 (errors grew as j0^2 when one accumulator ran through the
  // whole contraction), so it only ever sums 96 products.
  float acc[64], part[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    acc[j] = 0.0f;
    part[j] = 0.0f;
  }
  uint32_t a_hi[4][4], a_lo[4][4];  // this stage's A fragments, split
  float a_next[4][4];               // the next stage's, as loaded
  if (num_k > 0) {
    prepare_stage(smem, full_bar, 0, tid, a_next);
    split_a(a_next, a_hi, a_lo);
    asm volatile("bar.sync 1, 256;" ::: "memory");
  }
  for (int kb = 0; kb < num_k; ++kb) {
    const int s = kb % STAGES;
    unsigned char* b_tile = smem + s * STAGE_BYTES + TILE_BYTES;
    unsigned char* b_lo_tile = smem + STAGES * STAGE_BYTES + (kb % LO_BUFS) * TILE_BYTES;
    fence_acc(part);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const uint64_t b_hi = smem_desc(b_tile + ks * 32), b_lo = smem_desc(b_lo_tile + ks * 32);
      wgmma_tf32(part, a_lo[ks], b_hi, ks > 0);  // small terms first
      wgmma_tf32(part, a_hi[ks], b_lo, 1);
      wgmma_tf32(part, a_hi[ks], b_hi, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(part);
    fence_frag(a_hi);
    fence_frag(a_lo);
    // prepare the next stage while this one multiplies; its B low parts go
    // to the buffer the previous stage (retired in both warpgroups) used
    if (kb + 1 < num_k) prepare_stage(smem, full_bar, kb + 1, tid, a_next);
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(part);
    fence_frag(a_hi);
    fence_frag(a_lo);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += part[j];
    if (kb + 1 < num_k) split_a(a_next, a_hi, a_lo);  // the retired group no longer reads them
    // the next stage is split in both warpgroups, and this one retired:
    // its slot takes the stage STAGES ahead
    asm volatile("bar.sync 1, 256;" ::: "memory");
    if (kb + STAGES < num_k) {
      load_stage<TMA>(smem, full_bar, kb + STAGES, tid, &amap, &bmap, la, lb, m1, m2, ldl, ldb,
                      kdim, rbase, cbase);
    }
  }

  store_strip<METHOD>(smem, acc, tid, rbase, cbase, x1, x2, out, m1, m2, d, row0, col0, n,
                      noise, needs, prog.n_ops, sops, soffs, sprm);
}

// ---------------------------------------------------------------------------
// bfloat16 products: one warp-specialized wgmma mainloop, two operand feeds
// ---------------------------------------------------------------------------

namespace ws {
constexpr int BM = 128;               // tile rows: two consumer warpgroups of 64
constexpr int BN = 128;               // tile columns: the wgmma N
constexpr int BK = 64;                // bfloat16 per stage row: one 128-byte swizzle row
constexpr int CONSUMERS = 256;        // threads 0..255 multiply, 256..383 load
constexpr int THREADS = 384;
constexpr int B_BYTES = BN * BK * 2;  // the bfloat16 B tile of a stage
constexpr int START_REGS = 168;       // a thread's registers at launch: 384 x 168 <= 65,536
// setmaxnreg's split of the block's 384 x 168: a producer issuing TMA from
// one thread needs few; one doing plain loads needs more (with 40 its
// address arithmetic spilled)
constexpr int TMA_PRODUCER_REGS = 40, PLAIN_PRODUCER_REGS = 56;
// the consumers' share: 232 and 224, multiples of 8 as setmaxnreg needs
constexpr int consumer_regs(int producer) { return (THREADS * START_REGS - 128 * producer) / 256; }
static_assert(consumer_regs(TMA_PRODUCER_REGS) == 232 && consumer_regs(PLAIN_PRODUCER_REGS) == 224,
              "setmaxnreg counts are multiples of 8");
// Stages (64 products each) per fresh tensor-core accumulator: the longest
// interval whose downdate error against float64 stayed within twice that of
// the previous design's 128 products on the card (PERF.md).
constexpr int PROMOTE = 8;
// Bytes of the stage ring: 5 bfloat16 stages of 32 KB, 3 float32-fed ones
// of 48 KB. The shared memory left to the SM's L1, which holds the
// epilogue's input rows, beat a deeper ring on the card (PERF.md).
constexpr int RING_BYTES = 160 * 1024;
// Row stride (elements) of an in-place bfloat16 factor from which the
// serialized consumer loop runs: faster from capacity 130,512 up, slower at
// 120,512 and below and on explicit prefixes, on the card (PERF.md).
constexpr long long SERIAL_MIN_LD = 125000;
static_assert(BM == tc::BM && BN == tc::BN, "the epilogue is the 3xTF32 kernel's");
static_assert(BK * 2 == 128, "a bfloat16 stage row is one 128-byte swizzle row");
}  // namespace ws

// What a ws launch multiplies: a bfloat16 prefix, or a float32 prefix
// rounded to bfloat16 on the way in.
enum Feed { FEED_BF16 = 0, FEED_F32 = 1 };

template <int FEED>
struct FeedShape {
  // A: 128 rows x 64 bfloat16 (one 128-byte row each), or 64 float32 as two
  // 128 x 32 sub-tiles; then the bfloat16 B tile
  static constexpr int A_BYTES = FEED == FEED_BF16 ? ws::BM * ws::BK * 2 : ws::BM * ws::BK * 4;
  static constexpr int STAGE_BYTES = A_BYTES + ws::B_BYTES;
  static constexpr int STAGES = ws::RING_BYTES / STAGE_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment
  static_assert(STAGES * STAGE_BYTES >= ws::BM * (ws::BN + 1) * 4, "the epilogue's tile");
};

// mbar_wait as one PTX loop, with the same trap: a C++ loop around a wait
// is a branch that ptxas takes as divergent, and a wgmma after it would be
// serialized.
__device__ __forceinline__ void mbar_wait_ptx(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .s64 t0, t1;\n"
      "mov.u64 t0, %%clock64;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra LAB_DONE;\n"
      "mov.u64 t1, %%clock64;\n"
      "sub.s64 t1, t1, t0;\n"
      "setp.gt.s64 p, t1, 17179869184;\n"  // 2^34 cycles
      "@p trap;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` if `pred` is non-zero, as a predicated instruction
// rather than a branch.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, int pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(pred)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d = A (64 x 16, bf16) . B (128 x 16, bf16)^T (+ d if `accumulate`), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate)
      : "memory");
}

// The same with A (64 x 16, bf16) from registers: this thread's fragment
// (see `load_a_bf16`).
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
      : "memory");
}

// Two float32 as one bfloat16 pair, each rounded to nearest even (the value
// __float2bfloat16_rn gives), `lo` in the low half.
__device__ __forceinline__ uint32_t bf16x2_rn(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// This thread's A fragments of one FEED_F32 stage, rounded to bfloat16: for
// k-step ks, a[ks][0..3] = A[r][c..c+1], A[r+8][c..c+1], A[r][c+8..c+9],
// A[r+8][c+8..c+9] with c = 16 ks + 2 (l % 4) (the wgmma bf16 A register
// layout; r = `row`, the tile row of lane l / 4 of its warp's 16 rows). Read
// as float2 from the two 128 x 32 float32 sub-tiles in the 128-byte swizzle
// (16-byte chunk q of row r at chunk q ^ (r % 8)): free of bank conflicts.
__device__ __forceinline__ void load_a_bf16(const unsigned char* a_tile, int row, int lane,
                                            uint32_t (&a)[4][4]) {
  const int t = lane & 3, sw = row & 7;  // rows r and r + 8 share the swizzle
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const unsigned char* r0 = a_tile + (ks >> 1) * (ws::BM * 128) + row * 128;
    const unsigned char* r8 = r0 + 8 * 128;
    const int q = (ks & 1) * 4 + (t >> 1);
    const int o0 = ((q ^ sw) << 4) | ((t & 1) << 3);
    const int o1 = (((q + 2) ^ sw) << 4) | ((t & 1) << 3);
    const float2 v00 = *reinterpret_cast<const float2*>(r0 + o0);
    const float2 v80 = *reinterpret_cast<const float2*>(r8 + o0);
    const float2 v01 = *reinterpret_cast<const float2*>(r0 + o1);
    const float2 v81 = *reinterpret_cast<const float2*>(r8 + o1);
    a[ks][0] = bf16x2_rn(v00.x, v00.y);
    a[ks][1] = bf16x2_rn(v80.x, v80.y);
    a[ks][2] = bf16x2_rn(v01.x, v01.y);
    a[ks][3] = bf16x2_rn(v81.x, v81.y);
  }
}

// The single pass's B operand, made once per launch: the panel's rows (one
// block row per row, row stride ldl; the strip's first rows in the streamed
// factorization) rounded to bfloat16 into `dst` (row stride ldb, a multiple
// of 8).
__global__ void bf16_rows_kernel(const float* __restrict__ la, long long ldl, int kdim,
                                 uint32_t* __restrict__ dst, int ldb) {
  const float* src = la + (long long)blockIdx.y * ldl;
  uint32_t* row = dst + (long long)blockIdx.y * (ldb / 2);
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; 2 * p < kdim; p += gridDim.x * blockDim.x) {
    row[p] = bf16x2_rn(src[2 * p], 2 * p + 1 < kdim ? src[2 * p + 1] : 0.0f);
  }
}

// Plain loads of stage k by the producer warpgroup (thread `ptid` of 128)
// into the layout a FEED_BF16 TMA writes (16-byte chunk c / 8 of row r at
// chunk (c / 8) ^ (r % 8)): A bfloat16, from float32 rounded to nearest
// even (the value cvt.rn.bf16x2.f32 gives, as the consumers' conversion
// does), then B; zero past the strip's rows and past kdim.
template <int FEED>
__device__ __forceinline__ void plain_stage(unsigned char* stage, const void* __restrict__ la,
                                            long long ldl, const uint16_t* __restrict__ lb,
                                            long long ldb, int m1, int m2, int kdim, int k,
                                            int rbase, int cbase, int ptid) {
  using namespace ws;
  const int k0 = k * BK;
  for (int e = ptid; e < BM * BK; e += 128) {
    const int r = e / BK, c = e % BK, row = rbase + r, kk = k0 + c;
    const bool valid = row < m1 && kk < kdim;
    uint16_t v = 0;
    if (FEED == FEED_F32) {
      const float f = valid ? static_cast<const float*>(la)[(long long)row * ldl + kk] : 0.0f;
      v = static_cast<uint16_t>(bf16x2_rn(f, 0.0f) & 0xffffu);
    } else if (valid) {
      v = static_cast<const uint16_t*>(la)[(long long)row * ldl + kk];
    }
    *reinterpret_cast<uint16_t*>(stage + r * 128 +
                                 ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1))) = v;
  }
  unsigned char* b_tile = stage + FeedShape<FEED_BF16>::A_BYTES;
  for (int e = ptid; e < BN * BK; e += 128) {
    const int r = e / BK, c = e % BK, row = cbase + r, kk = k0 + c;
    const uint16_t v = (row < m2 && kk < kdim) ? lb[(long long)row * ldb + kk] : uint16_t(0);
    *reinterpret_cast<uint16_t*>(b_tile + r * 128 +
                                 ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1))) = v;
  }
}

// `amap` covers the strip's rows L[j0:cap, 0:kdim] (FEED_BF16: bfloat16,
// 128 x 64 boxes; FEED_F32: float32, 128 x 32 boxes), `bmap` the B rows
// (bfloat16, 128 x 64 boxes): the strip's first m2 rows, or their
// bfloat16 copy (FEED_F32); `la` and `lb` (row stride ldb) point at their
// first elements (plain loads).
template <int FEED, int METHOD, bool TMA, bool SERIAL>
__global__ void __launch_bounds__(ws::THREADS, 1)
    panel_strip_ws_kernel(const __grid_constant__ CUtensorMap amap,
                          const __grid_constant__ CUtensorMap bmap, const float* __restrict__ x1,
                          const float* __restrict__ x2, const void* __restrict__ la,
                          const uint16_t* __restrict__ lb, long long ldb, float* __restrict__ out,
                          int m1, int m2, int d, long long ldl, int kdim, long long row0,
                          long long col0, long long n, float noise, int needs,
                          const __grid_constant__ CovProgram prog) {
  using namespace ws;
  // the stages' layout: the plain loads write bfloat16 A for either feed
  constexpr int LAYOUT = TMA ? FEED : FEED_BF16;
  using Shape = FeedShape<LAYOUT>;
  static_assert(!SERIAL || LAYOUT == FEED_BF16, "the serialized loop takes bfloat16 stages");
  constexpr int PRODUCER = TMA ? TMA_PRODUCER_REGS : PLAIN_PRODUCER_REGS;
  constexpr int CONSUMER = (THREADS * START_REGS - 128 * PRODUCER) / 256;
  constexpr int STAGES = Shape::STAGES;
  extern __shared__ unsigned char smem_dyn[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ __align__(8) uint64_t empty_bar[STAGES];
  __shared__ float sprm[MAX_PARAMS];
  __shared__ int sops[MAX_OPS];
  __shared__ int soffs[MAX_OPS];

  // stages on 1024-byte boundaries (the swizzle atom)
  unsigned char* smem = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  const int tid = threadIdx.x;
  // A 1-D grid in launch order: a row tile with all its column tiles, then
  // the next, so that the blocks in flight share their A rows in L2.
  const int col_tiles = (m2 + BN - 1) / BN;
  const int rbase = static_cast<int>(blockIdx.x / col_tiles) * BM;
  const int cbase = static_cast<int>(blockIdx.x % col_tiles) * BN;
  const int num_k = (kdim + BK - 1) / BK;

  if (tid < MAX_PARAMS) sprm[tid] = static_cast<float>(prog.params[tid]);
  if (tid < MAX_OPS) {
    sops[tid] = prog.ops[tid];
    soffs[tid] = prog.offs[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_bar[s], TMA ? 1 : 128);
      mbar_init(&empty_bar[s], 2);  // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, warp-uniform to the compiler (a role branch it took as
  // divergent would serialize every wgmma behind it)
  const int g = SERIAL ? tid / 128 : __shfl_sync(0xffffffff, tid / 128, 0);
  if (g == CONSUMERS / 128) {
    // ---- producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER));
    const int ptid = tid - CONSUMERS;
    if (TMA) {
      if (ptid == 0) {
        for (int k = 0; k < num_k; ++k) {
          const int s = k % STAGES;
          if (k >= STAGES) mbar_wait(&empty_bar[s], ((k / STAGES) - 1) & 1);
          unsigned char* stage = smem + s * Shape::STAGE_BYTES;
          mbar_expect_tx(&full_bar[s], Shape::STAGE_BYTES);
          tma_load(stage, &amap, &full_bar[s], k * BK, rbase);
          if (FEED == FEED_F32) {
            tma_load(stage + BM * 128, &amap, &full_bar[s], k * BK + BK / 2, rbase);
          }
          tma_load(stage + Shape::A_BYTES, &bmap, &full_bar[s], k * BK, cbase);
        }
      }
    } else {
      for (int k = 0; k < num_k; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty_bar[s], ((k / STAGES) - 1) & 1);
        plain_stage<FEED>(smem + s * Shape::STAGE_BYTES, la, ldl, lb, ldb, m1, m2, kdim, k,
                          rbase, cbase, ptid);
        // the generic writes, visible to wgmma's async-proxy reads
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&full_bar[s]);
      }
    }
    return;
  }

  // ---- consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER));
  const int lane = tid % 32, wg_tid = tid % 128;
  const int row = g * 64 + (wg_tid / 32) * 16 + lane / 4;  // of this thread's A fragment
  float acc[64], part[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    acc[j] = 0.0f;
    part[j] = 0.0f;
  }
  if constexpr (SERIAL) {
    // Promotion every PROMOTE stages under a condition, the two warpgroups'
    // intervals offset by half an interval: ptxas serializes these wgmma
    // (C7518), which keeps one k-step in flight per warpgroup. (The unused
    // fragment fences are those of the form measured.)
    const int offset = g * (PROMOTE / 2);
    int released = 0;  // stages this warpgroup has released
    bool fresh = true;
    // release stages [released, upto) to the producer
    auto release = [&](int upto) {
      for (; released < upto; ++released) {
        if (wg_tid == 0) mbar_arrive(&empty_bar[released % STAGES]);
      }
    };
    auto step = [&](int k, uint32_t(&frag)[4][4]) {
      const int s = k % STAGES;
      const unsigned char* stage = smem + s * Shape::STAGE_BYTES;
      mbar_wait(&full_bar[s], (k / STAGES) & 1);
      fence_acc(part);
      fence_frag(frag);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        wgmma_bf16(part, smem_desc(stage + g * 64 * 128 + ks * 32),
                   smem_desc(stage + Shape::A_BYTES + ks * 32), !(ks == 0 && fresh));
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(part);
      fence_frag(frag);
      fresh = false;
      if ((k + 1 + offset) % PROMOTE == 0 || k + 1 == num_k) {
        wgmma_wait<0>();
        fence_acc(part);
        fence_frag(frag);
        release(k + 1);
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] += part[j];
        fresh = true;
      } else {
        // the previous stage's group has retired; this one runs on
        wgmma_wait<1>();
        fence_acc(part);
        fence_frag(frag);
        release(k);
      }
    };
    uint32_t frag0[4][4] = {}, frag1[4][4] = {};
    for (int k = 0; k < num_k; k += 2) {
      step(k, frag0);
      if (k + 1 < num_k) step(k + 1, frag1);
    }
  } else {
    // Issues stage k's four k-steps into `part` as one wgmma group (a fresh
    // accumulator if `fresh`).
    auto issue = [&](int k, int fresh, uint32_t(&frag)[4][4]) {
      const int s = k % STAGES;
      const unsigned char* stage = smem + s * Shape::STAGE_BYTES;
      const unsigned char* b_tile = stage + Shape::A_BYTES;
      mbar_wait_ptx(&full_bar[s], (k / STAGES) & 1);
      if (LAYOUT == FEED_F32) load_a_bf16(stage, row, lane, frag);
      fence_acc(part);
      if constexpr (LAYOUT == FEED_F32) fence_frag(frag);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const int accumulate = ks > 0 || !fresh;
        if (LAYOUT == FEED_F32) {
          wgmma_bf16_rs(part, frag[ks], smem_desc(b_tile + ks * 32), accumulate);
        } else {
          wgmma_bf16(part, smem_desc(stage + g * 64 * 128 + ks * 32), smem_desc(b_tile + ks * 32),
                     accumulate);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      fence_acc(part);
      if constexpr (LAYOUT == FEED_F32) fence_frag(frag);
    };
    // The previous group has retired (one stays in flight): release its stage.
    auto retire_previous = [&](int k, int released, uint32_t(&frag)[4][4]) {
      wgmma_wait<1>();
      fence_acc(part);
      if constexpr (LAYOUT == FEED_F32) fence_frag(frag);
      mbar_arrive_if(&empty_bar[(k + STAGES - 1) % STAGES], released && wg_tid == 0);
    };
    // Chunks of PROMOTE stages, each summed in a fresh tensor-core
    // accumulator and added into `acc` in float32 after the chunk: no branch
    // around a wgmma or its accumulator depends on the thread, so ptxas keeps
    // the groups asynchronous. Two sets of A fragments: a set is rewritten
    // only after the group that read it has retired.
    uint32_t frag0[4][4] = {}, frag1[4][4] = {};
    for (int k0 = 0; k0 < num_k; k0 += PROMOTE) {
      const int k1 = min(k0 + PROMOTE, num_k);
      for (int k = k0; k < k1; k += 2) {
        issue(k, k == k0, frag0);
        retire_previous(k, k > k0, frag1);
        if (k + 1 < k1) {
          issue(k + 1, 0, frag1);
          retire_previous(k + 1, 1, frag0);
        }
      }
      wgmma_wait<0>();
      fence_acc(part);
      mbar_arrive_if(&empty_bar[(k1 - 1) % STAGES], wg_tid == 0);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += part[j];
    }
  }
  // both warpgroups are done with the ring before the epilogue reuses it
  asm volatile("bar.sync 1, 256;" ::: "memory");
  store_strip<METHOD>(smem, acc, tid, rbase, cbase, x1, x2, out, m1, m2, d, row0, col0, n, noise,
                      needs, prog.n_ops, sops, soffs, sprm);
}

// ---------------------------------------------------------------------------
// float64: mma.sync on the FP64 tensor cores, fed by TMA or cp.async
// ---------------------------------------------------------------------------

namespace dm {
constexpr int BM = 128;                       // tile rows: two warp rows of 64
constexpr int BN = 128;                       // tile columns: four warp columns of 32
constexpr int WM = 64;                        // a warp's rows: four mma tiles of 16
constexpr int WN = 32;                        // a warp's columns: four mma tiles of 8
constexpr int THREADS = 256;                  // eight warps
constexpr int BOX_K = 16;                     // doubles in a 128-byte swizzle row: one TMA box
constexpr int BK = 32;                        // contraction per stage: two boxes
constexpr int STAGES = 3;                     // ring of loaded stages
constexpr int BOX_BYTES = BM * BOX_K * 8;     // one operand box, 16 KB
constexpr int OPERAND_BYTES = (BK / BOX_K) * BOX_BYTES;
constexpr int STAGE_BYTES = 2 * OPERAND_BYTES;  // A's boxes, then B's
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment
static_assert(BM == BN, "one box shape serves both operands");
static_assert(BM == 2 * WM && BN == 4 * WN && THREADS == 8 * 32, "eight warps, 2 x 4");
static_assert(STAGES * STAGE_BYTES >= BM * (BN + 1) * 8, "the epilogue's tile");
}  // namespace dm

// cp.async of one double, zero-filled when `valid` is false.
__device__ __forceinline__ void cp_async8(void* dst, const double* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 8 : 0)
               : "memory");
}

// Starts the load of stage k of the float64 kernel into its ring slot: for
// each operand two 128 x 16 boxes, the contraction's columns k BK .. k BK +
// 31 of the strip's rows (A) and of its first rows (B), in the 128-byte
// swizzle (16-byte chunk q of box row r at chunk q ^ (r % 8)). TMA from
// thread 0 (the slot's full barrier expects the bytes; the map's extents
// zero-fill rows past the strip and columns past kdim), or cp.async of one
// double at a time from every thread, zero-filled there too (each thread
// arrives once its copies have landed).
template <bool TMA>
__device__ __forceinline__ void load_stage_f64(unsigned char* smem, uint64_t* full_bar, int k,
                                               int tid, const CUtensorMap* amap,
                                               const CUtensorMap* bmap,
                                               const double* __restrict__ la,
                                               const double* __restrict__ lb, int m1, int m2,
                                               long long ldl, long long ldb, int kdim, int rbase,
                                               int cbase) {
  using namespace dm;
  const int s = k % STAGES;
  unsigned char* stage = smem + s * STAGE_BYTES;
  if (TMA) {
    if (tid == 0) {
      mbar_expect_tx(&full_bar[s], STAGE_BYTES);
#pragma unroll
      for (int h = 0; h < BK / BOX_K; ++h) {
        tma_load(stage + h * BOX_BYTES, amap, &full_bar[s], k * BK + h * BOX_K, rbase);
        tma_load(stage + OPERAND_BYTES + h * BOX_BYTES, bmap, &full_bar[s], k * BK + h * BOX_K,
                 cbase);
      }
    }
  } else {
    const int k0 = k * BK;
    for (int e = tid; e < 2 * BM * BK; e += THREADS) {
      const int op = e / (BM * BK);
      const int r = (e / BK) % BM;
      const int c = e % BK;
      const int row = (op ? cbase : rbase) + r;
      const int kk = k0 + c;
      const bool valid = row < (op ? m2 : m1) && kk < kdim;
      const double* src =
          valid ? (op ? lb + (long long)row * ldb : la + (long long)row * ldl) + kk : la;
      const int q = (c % BOX_K) >> 1;  // the 16-byte chunk in the box row
      const int off = op * OPERAND_BYTES + (c / BOX_K) * BOX_BYTES + r * 128 +
                      ((q ^ (r & 7)) << 4) + ((c & 1) << 3);
      cp_async8(stage + off, src, valid);
    }
    cp_async_arrive(&full_bar[s]);
  }
}

// Row r of a swizzled 128 x 16 box: its doubles 4t .. 4t + 3, as two
// 16-byte loads. For the eight threads of a quarter warp (rows g and g + 1
// mod 8, t = 0..3) the sixteen chunks are the eight of each row, XORed by
// the row: free of bank conflicts.
__device__ __forceinline__ void load_quad(const unsigned char* box, int r, int t, double (&v)[4]) {
  const unsigned char* row = box + r * 128;
  const int sw = r & 7;
  const double2 lo = *reinterpret_cast<const double2*>(row + (((2 * t) ^ sw) << 4));
  const double2 hi = *reinterpret_cast<const double2*>(row + (((2 * t + 1) ^ sw) << 4));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

// c += A (16 x 16) . B (16 x 8) in float64 on the tensor cores. The
// register layout of thread (g = lane / 4, t = lane % 4): a[i] = A[g + 8 (i
// % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g], c[i] = C[g + 8 (i / 2)][2 t +
// i % 2].
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[8], const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// acc += this warp's 64 rows of an A box times its 32 rows of a B box,
// transposed: 16 deep. The contraction's order is free, so the
// instruction's k index t + 4 j of thread t is the box column 4 t + j, the
// same in A and B: every thread reads four consecutive doubles of a row
// (load_quad) and no element twice.
__device__ __forceinline__ void warp_box(double (&acc)[4][4][4], const unsigned char* a_box,
                                         const unsigned char* b_box, int wr, int wc, int g,
                                         int t) {
  double b[4][4];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) load_quad(b_box, wc + ni * 8 + g, t, b[ni]);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    double lo[4], hi[4];
    load_quad(a_box, wr + mi * 16 + g, t, lo);
    load_quad(a_box, wr + mi * 16 + 8 + g, t, hi);
    const double a[8] = {lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], lo[3], hi[3]};
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) dmma(acc[mi][ni], a, b[ni]);
  }
}

// `amap` covers the strip's rows (A: m1 rows, row stride ldl, the first
// kdim columns) and `bmap` the panel's rows (B: m2 rows, row stride ldb),
// for the TMA path; `la` and `lb` point at their first elements (cp.async
// path). As in the 3xTF32 kernel, B is A's first rows in the streamed
// factorization and its own operand below the panel's rank.
template <int METHOD, bool TMA>
__global__ void __launch_bounds__(dm::THREADS, 1)
    panel_strip_f64_kernel(const __grid_constant__ CUtensorMap amap,
                           const __grid_constant__ CUtensorMap bmap,
                           const double* __restrict__ x1, const double* __restrict__ x2,
                           const double* __restrict__ la, const double* __restrict__ lb,
                           double* __restrict__ out, int m1, int m2, int d, long long ldl,
                           long long ldb, int kdim, long long row0, long long col0, long long n,
                           double noise, int needs, const __grid_constant__ CovProgram prog) {
  using namespace dm;
  extern __shared__ unsigned char smem_dyn[];
  __shared__ __align__(8) uint64_t full_bar[STAGES];
  __shared__ double sprm[MAX_PARAMS];
  __shared__ int sops[MAX_OPS];
  __shared__ int soffs[MAX_OPS];

  // stages on 1024-byte boundaries (the swizzle atom)
  unsigned char* smem = smem_dyn + ((1024 - (smem_u32(smem_dyn) & 1023)) & 1023);
  const int tid = threadIdx.x;
  // A 1-D grid in launch order: a row tile with all its column tiles, then
  // the next, so that the blocks in flight share their A rows in L2.
  const int col_tiles = (m2 + BN - 1) / BN;
  const int rbase = static_cast<int>(blockIdx.x / col_tiles) * BM;
  const int cbase = static_cast<int>(blockIdx.x % col_tiles) * BN;
  const int num_k = (kdim + BK - 1) / BK;

  if (tid < MAX_PARAMS) sprm[tid] = prog.params[tid];
  if (tid < MAX_OPS) {
    sops[tid] = prog.ops[tid];
    soffs[tid] = prog.offs[tid];
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full_bar[s], TMA ? 1 : THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  for (int k = 0; k < STAGES && k < num_k; ++k) {
    load_stage_f64<TMA>(smem, full_bar, k, tid, &amap, &bmap, la, lb, m1, m2, ldl, ldb, kdim,
                        rbase, cbase);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int wr = (warp / 4) * WM, wc = (warp % 4) * WN, g = lane / 4, t = lane % 4;
  double acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0;
  for (int kb = 0; kb < num_k; ++kb) {
    const int s = kb % STAGES;
    const unsigned char* stage = smem + s * STAGE_BYTES;
    mbar_wait(&full_bar[s], (kb / STAGES) & 1);
#pragma unroll
    for (int h = 0; h < BK / BOX_K; ++h) {
      warp_box(acc, stage + h * BOX_BYTES, stage + OPERAND_BYTES + h * BOX_BYTES, wr, wc, g, t);
    }
    // every warp is done with the slot: it takes the stage STAGES ahead
    __syncthreads();
    if (kb + STAGES < num_k) {
      load_stage_f64<TMA>(smem, full_bar, kb + STAGES, tid, &amap, &bmap, la, lb, m1, m2, ldl,
                          ldb, kdim, rbase, cbase);
    }
  }

  // the accumulators to shared memory (the ring is free), then the epilogue
  double* tile = reinterpret_cast<double*>(smem);  // BM x (BN + 1)
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wr + mi * 16 + g + 8 * (i / 2), c = wc + ni * 8 + 2 * t + i % 2;
        tile[r * (BN + 1) + c] = acc[mi][ni][i];
      }
  __syncthreads();
  strip_from_tile<double, METHOD, BM, BN, THREADS>(tile, tid, rbase, cbase, x1, x2, out, m1, m2, d,
                                                   row0, col0, n, noise, needs, prog.n_ops, sops,
                                                   soffs, sprm);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so that the
// library links no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// Encodes a 2-D tensor map over `rows` rows of `cols` elements of type
// `type` (bfloat16, float32 or float64; row stride `ld` elements) in boxes of
// box_rows x box_cols, 128-byte swizzle; false if the encoder refuses it.
inline bool encode_map(CUtensorMap* map, const void* base, CUtensorMapDataType type, long long ld,
                       int cols, int rows, int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT64   ? 8
                   : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                                                             : 2;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether TMA can read rows of `elem`-byte entries at `base` with row stride
// `ld` elements: a 16-byte aligned base and row stride.
inline bool tma_aligned(const void* base, long long ld, int elem) {
  return (ld * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(base) % 16 == 0;
}

// The operand pairing of a launch. One operand (`lb == la`, ldb == ldl): the
// strip's columns are its own first m2 rows, so m2 <= m1, and one map serves
// both (the streamed factorization). Two operands: `lb` holds the panel's m2
// rows, any m2 (a rank of the distributed factorization below the panel).
inline bool operands_ok(const void* la, const void* lb, long long ldl, long long ldb, int m1,
                        int m2, int kdim) {
  if (lb == la) return ldb == ldl && m2 <= m1;
  return ldb >= kdim && ldl >= kdim;
}

template <int METHOD, bool TMA>
cudaError_t launch_tf32x3_as(const CUtensorMap& amap, const CUtensorMap& bmap, const float* x1,
                             const float* x2, const float* la, const float* lb, float* out,
                             int m1, int m2, int d, long long ldl, long long ldb, int kdim,
                             long long row0, long long col0, long long n, float noise, int needs,
                             const CovProgram& prog, cudaStream_t s) {
  const dim3 grid((m2 + tc::BN - 1) / tc::BN, (m1 + tc::BM - 1) / tc::BM);
  auto kernel = panel_strip_tf32x3_kernel<METHOD, TMA>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, tc::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<grid, tc::THREADS, tc::SMEM_BYTES, s>>>(amap, bmap, x1, x2, la, lb, out, m1, m2, d, ldl,
                                                   ldb, kdim, row0, col0, n, noise, needs, prog);
  return cudaGetLastError();
}

// One launch of the 3xTF32 instantiation. `la` points at m1 float32 prefix
// rows (row stride `ldl`) and `lb` at the panel's m2 rows (row stride
// `ldb`), whose first `kdim` columns are contracted (operands_ok). TMA where
// both operands are 16-byte aligned, cp.async elsewhere.
inline int launch_tf32x3(const float* x1, const float* x2, const float* la, const float* lb,
                         float* out, int m1, int m2, int d, long long ldl, long long ldb,
                         int kdim, long long row0, long long col0, long long n, double noise,
                         int method, int needs, const CovProgram& prog, cudaStream_t s) {
  if (!operands_ok(la, lb, ldl, ldb, m1, m2, kdim)) return static_cast<int>(cudaErrorInvalidValue);
  if ((m1 + tc::BM - 1) / tc::BM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap, bmap;
  std::memset(&amap, 0, sizeof(amap));
  std::memset(&bmap, 0, sizeof(bmap));
  const bool tma = tma_aligned(la, ldl, 4) && tma_aligned(lb, ldb, 4);
  if (tma && kdim > 0) {
    if (!encode_map(&amap, la, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ldl, kdim, m1, tc::BK, tc::BM)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // one operand: the same map serves B (its rows past m2 only reach
    // columns the epilogue masks)
    if (lb == la) {
      bmap = amap;
    } else if (!encode_map(&bmap, lb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ldb, kdim, m2, tc::BK,
                           tc::BN)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const float nz = static_cast<float>(noise);
#define FRIEDRICH_TF32X3(M)                                                                    \
  (tma ? launch_tf32x3_as<M, true>(amap, bmap, x1, x2, la, lb, out, m1, m2, d, ldl, ldb, kdim, \
                                   row0, col0, n, nz, needs, prog, s)                          \
       : launch_tf32x3_as<M, false>(amap, bmap, x1, x2, la, lb, out, m1, m2, d, ldl, ldb, kdim, \
                                    row0, col0, n, nz, needs, prog, s))
  cudaError_t err;
  switch (method) {
    case GRAM: err = FRIEDRICH_TF32X3(GRAM); break;
    case GRAM_BF16: err = FRIEDRICH_TF32X3(GRAM_BF16); break;
    case DIRECT: err = FRIEDRICH_TF32X3(DIRECT); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FRIEDRICH_TF32X3
  return static_cast<int>(err);
}

template <int FEED, int METHOD, bool TMA, bool SERIAL = false>
cudaError_t launch_ws_as(const CUtensorMap& amap, const CUtensorMap& bmap, const float* x1,
                         const float* x2, const void* la, const uint16_t* lb, long long ldb,
                         float* out, int m1, int m2, int d, long long ldl, int kdim,
                         long long row0, long long col0, long long n, float noise, int needs,
                         const CovProgram& prog, cudaStream_t s) {
  auto kernel = panel_strip_ws_kernel<FEED, METHOD, TMA, SERIAL>;
  constexpr int smem = FeedShape<TMA ? FEED : FEED_BF16>::SMEM_BYTES;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // setmaxnreg's split takes all the registers a block starts with: with
  // fewer, setmaxnreg.inc would wait forever, so refuse the launch instead
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < ws::START_REGS) return cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((m1 + ws::BM - 1) / ws::BM) * ((m2 + ws::BN - 1) / ws::BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), ws::THREADS, smem, s>>>(
      amap, bmap, x1, x2, la, lb, ldb, out, m1, m2, d, ldl, kdim, row0, col0, n, noise, needs, prog);
  return cudaGetLastError();
}

// One launch of a bfloat16-product instantiation: FEED_BF16, `la` m1 rows
// of a bfloat16 prefix (row stride `ldl` elements) and `lb` the panel's m2
// rows (row stride `ldb`); FEED_F32, float32 rows, the panel's m2 rounded
// into `scratch` first (m2 rows of round_up(kdim, 8) bfloat16, the caller's
// buffer). One operand (`lb == la`) or two, as operands_ok says.
template <int FEED>
int launch_ws(const float* x1, const float* x2, const void* la, const void* lb, void* scratch,
              float* out, int m1, int m2, int d, long long ldl, long long ldb_in, int kdim,
              long long row0, long long col0, long long n, double noise, int method, int needs,
              const CovProgram& prog, cudaStream_t s) {
  if (!operands_ok(la, lb, ldl, ldb_in, m1, m2, kdim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr bool bf16 = FEED == FEED_BF16;
  const uint16_t* b_rows = static_cast<const uint16_t*>(lb);
  long long ldb = ldb_in;
  if (!bf16 && kdim > 0) {
    if (scratch == nullptr || m2 > 65535) return static_cast<int>(cudaErrorInvalidValue);
    ldb = (kdim + 7) / 8 * 8;
    const int pairs = (kdim + 1) / 2;
    bf16_rows_kernel<<<dim3((pairs + 255) / 256, m2), 256, 0, s>>>(
        static_cast<const float*>(lb), ldb_in, kdim, static_cast<uint32_t*>(scratch),
        static_cast<int>(ldb));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    b_rows = static_cast<const uint16_t*>(scratch);
  }
  CUtensorMap amap, bmap;
  std::memset(&amap, 0, sizeof(amap));
  std::memset(&bmap, 0, sizeof(bmap));
  // TMA needs 16-byte aligned bases and row strides (the copy has both)
  const bool tma = tma_aligned(la, ldl, bf16 ? 2 : 4) && tma_aligned(b_rows, ldb, 2);
  if (tma && kdim > 0 &&
      !(encode_map(&amap, la, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                   ldl, kdim, m1, bf16 ? ws::BK : ws::BK / 2, ws::BM) &&
        encode_map(&bmap, b_rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ldb, kdim, m2, ws::BK,
                   ws::BN))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the serialized loop for a bfloat16 factor read in place at a row stride
  // where it measured faster (PERF.md)
  const bool serial = bf16 && tma && ldl >= ws::SERIAL_MIN_LD;
  const float nz = static_cast<float>(noise);
#define FRIEDRICH_WS(M)                                                                         \
  (serial ? launch_ws_as<FEED, M, true, bf16>(amap, bmap, x1, x2, la, b_rows, ldb, out, m1, m2, \
                                              d, ldl, kdim, row0, col0, n, nz, needs, prog, s)  \
   : tma  ? launch_ws_as<FEED, M, true>(amap, bmap, x1, x2, la, b_rows, ldb, out, m1, m2, d,    \
                                        ldl, kdim, row0, col0, n, nz, needs, prog, s)           \
          : launch_ws_as<FEED, M, false>(amap, bmap, x1, x2, la, b_rows, ldb, out, m1, m2, d,   \
                                         ldl, kdim, row0, col0, n, nz, needs, prog, s))
  cudaError_t err;
  switch (method) {
    case GRAM: err = FRIEDRICH_WS(GRAM); break;
    case GRAM_BF16: err = FRIEDRICH_WS(GRAM_BF16); break;
    case DIRECT: err = FRIEDRICH_WS(DIRECT); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FRIEDRICH_WS
  return static_cast<int>(err);
}

template <int METHOD, bool TMA>
cudaError_t launch_f64_as(const CUtensorMap& amap, const CUtensorMap& bmap, const double* x1,
                          const double* x2, const double* la, const double* lb, double* out,
                          int m1, int m2, int d, long long ldl, long long ldb, int kdim,
                          long long row0, long long col0, long long n, double noise, int needs,
                          const CovProgram& prog, cudaStream_t s) {
  auto kernel = panel_strip_f64_kernel<METHOD, TMA>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dm::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)((m1 + dm::BM - 1) / dm::BM) * ((m2 + dm::BN - 1) / dm::BN);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(tiles), dm::THREADS, dm::SMEM_BYTES, s>>>(
      amap, bmap, x1, x2, la, lb, out, m1, m2, d, ldl, ldb, kdim, row0, col0, n, noise, needs,
      prog);
  return cudaGetLastError();
}

// One launch of the float64 instantiation. `la` points at m1 float64 prefix
// rows (row stride `ldl`) and `lb` at the panel's m2 rows (row stride
// `ldb`), whose first `kdim` columns are contracted (operands_ok). TMA where
// both operands are 16-byte aligned, cp.async elsewhere (an odd capacity, an
// explicit prefix of odd width).
inline int launch_f64(const double* x1, const double* x2, const double* la, const double* lb,
                      double* out, int m1, int m2, int d, long long ldl, long long ldb, int kdim,
                      long long row0, long long col0, long long n, double noise, int method,
                      int needs, const CovProgram& prog, cudaStream_t s) {
  if (!operands_ok(la, lb, ldl, ldb, m1, m2, kdim)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap amap, bmap;
  std::memset(&amap, 0, sizeof(amap));
  std::memset(&bmap, 0, sizeof(bmap));
  const bool tma = tma_aligned(la, ldl, 8) && tma_aligned(lb, ldb, 8);
  if (tma && kdim > 0) {
    if (!encode_map(&amap, la, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, ldl, kdim, m1, dm::BOX_K, dm::BM)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (lb == la) {
      bmap = amap;
    } else if (!encode_map(&bmap, lb, CU_TENSOR_MAP_DATA_TYPE_FLOAT64, ldb, kdim, m2, dm::BOX_K,
                           dm::BN)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
#define FRIEDRICH_F64(M)                                                                        \
  (tma ? launch_f64_as<M, true>(amap, bmap, x1, x2, la, lb, out, m1, m2, d, ldl, ldb, kdim, row0, \
                                col0, n, noise, needs, prog, s)                                 \
       : launch_f64_as<M, false>(amap, bmap, x1, x2, la, lb, out, m1, m2, d, ldl, ldb, kdim,     \
                                 row0, col0, n, noise, needs, prog, s))
  cudaError_t err;
  switch (method) {
    case GRAM: err = FRIEDRICH_F64(GRAM); break;
    case GRAM_BF16: err = FRIEDRICH_F64(GRAM_BF16); break;
    case DIRECT: err = FRIEDRICH_F64(DIRECT); break;
    default: err = cudaErrorInvalidValue;
  }
#undef FRIEDRICH_F64
  return static_cast<int>(err);
}

}  // namespace

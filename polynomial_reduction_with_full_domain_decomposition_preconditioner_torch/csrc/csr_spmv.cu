// Fixed-order CSR SpMV y = A x in f32 (summed in f32) or f64 (summed in
// f64), int32 or int64 indices.
//
// Replaces no TPU kernel: the JAX package leaves its SpMV to XLA (a
// gather and a sorted segment_sum, ops/csr.py). It takes the place of
// torch's sparse_csr SpMV (cuSPARSE csrmv_v3 after a csr_partition pass),
// whose sums over long rows change from launch to launch, so that two
// fem-amg solves of one preconditioner part in their last bits.
//
// Every row has one summation order, fixed when the matrix is packed
// (ops/csr.py csr_from_scipy picks ``lanes`` from the row count and the
// row lengths, ops/kernels.py spmv_lanes):
// L = lanes threads serve a row, lane l sums the products of entries
// start + l, start + l + L, ... in ascending order from 0, then a fixed
// __shfl_xor_sync butterfly over the L lanes adds the partial sums. No
// atomics, no sum across blocks. Products and sums are __fmul_rn /
// __fadd_rn (__dmul_rn / __dadd_rn), so nothing is contracted into an
// FMA and the plain twin (ops/kernels.py csr_spmv_plain) repeats every
// rounding.
//
// Bound: bytes. Each entry moves its value and column index once and
// gathers one x; each row reads its two offsets and writes one y.
// Neighbouring lanes read neighbouring entries of a row, so the value and
// index loads coalesce; x is read through the read-only cache. A warp's
// rows wait on three dependent loads (offsets, entries, x), so the fewer
// lanes a row, the more rows a warp keeps in flight: a matrix of many
// short rows takes 1 or 2 lanes, one of few long rows 32 (the lanes
// were swept on the fem-amg hierarchy at 16^3 N=7, PERF.md).

#include "common.cuh"

namespace prfdd {
namespace {

constexpr int kSpmvThreads = 256;

template <typename T, typename I, int L>
__global__ void __launch_bounds__(kSpmvThreads)
csr_spmv_kernel(const I* __restrict__ crow, const I* __restrict__ cols,
                const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, int64_t n_rows) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t row = tid / L;
  const int lane = static_cast<int>(threadIdx.x) & (L - 1);
  T acc = T(0);
  if (row < n_rows) {
    const int64_t end = static_cast<int64_t>(crow[row + 1]);
    int64_t j = static_cast<int64_t>(crow[row]) + lane;
    // four of the lane's entries at a time: their loads are all issued
    // before the first add, and the adds keep the ascending order
    for (; j + 3 * L < end; j += 4 * L) {
      const I c0 = cols[j], c1 = cols[j + L], c2 = cols[j + 2 * L],
              c3 = cols[j + 3 * L];
      const T v0 = vals[j], v1 = vals[j + L], v2 = vals[j + 2 * L],
              v3 = vals[j + 3 * L];
      const T x0 = __ldg(x + static_cast<int64_t>(c0));
      const T x1 = __ldg(x + static_cast<int64_t>(c1));
      const T x2 = __ldg(x + static_cast<int64_t>(c2));
      const T x3 = __ldg(x + static_cast<int64_t>(c3));
      acc = add_rn(acc, mul_rn(v0, x0));
      acc = add_rn(acc, mul_rn(v1, x1));
      acc = add_rn(acc, mul_rn(v2, x2));
      acc = add_rn(acc, mul_rn(v3, x3));
    }
    for (; j < end; j += L)
      acc = add_rn(acc, mul_rn(vals[j], __ldg(x + static_cast<int64_t>(cols[j]))));
  }
  // every lane of the warp takes part: a block is whole warps and L
  // divides 32, so no row straddles two warps
#pragma unroll
  for (int off = L / 2; off >= 1; off >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
  if (row < n_rows && lane == 0) y[row] = acc;
}

template <typename T, typename I>
cudaError_t launch(const void* crow, const void* cols, const void* vals,
                   const void* x, void* y, int64_t n_rows, int lanes,
                   cudaStream_t stream) {
  const int64_t threads = n_rows * lanes;
  const int64_t blocks = (threads + kSpmvThreads - 1) / kSpmvThreads;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks));
#define PRFDD_SPMV_L(LN)                                                      \
  if (lanes == LN) {                                                          \
    csr_spmv_kernel<T, I, LN><<<grid, kSpmvThreads, 0, stream>>>(             \
        static_cast<const I*>(crow), static_cast<const I*>(cols),             \
        static_cast<const T*>(vals), static_cast<const T*>(x),                \
        static_cast<T*>(y), n_rows);                                          \
    return cudaGetLastError();                                                \
  }
  PRFDD_SPMV_L(1)
  PRFDD_SPMV_L(2)
  PRFDD_SPMV_L(4)
  PRFDD_SPMV_L(8)
  PRFDD_SPMV_L(16)
  PRFDD_SPMV_L(32)
#undef PRFDD_SPMV_L
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_i(int index_bits, const void* crow, const void* cols,
                     const void* vals, const void* x, void* y, int64_t n_rows,
                     int lanes, cudaStream_t stream) {
  switch (index_bits) {
    case 32: return launch<T, int32_t>(crow, cols, vals, x, y, n_rows, lanes, stream);
    case 64: return launch<T, int64_t>(crow, cols, vals, x, y, n_rows, lanes, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prfdd

// C interface: dtype 1 f32, 2 f64 (ops/kernels.py _CODE); index_bits 32 or
// 64 for both crow (n_rows + 1 offsets) and cols; lanes a power of two
// from 1 to 32. y (n_rows) is written whole. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int prfdd_csr_spmv(int dtype, int index_bits, const void* crow,
                              const void* cols, const void* vals,
                              const void* x, void* y, long long n_rows,
                              int lanes, void* stream) {
  using namespace prfdd;
  if (n_rows <= 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_i<float>(index_bits, crow, cols, vals, x, y, n_rows, lanes, st);
    case kF64: return launch_i<double>(index_bits, crow, cols, vals, x, y, n_rows, lanes, st);
    default: return cudaErrorInvalidValue;
  }
}

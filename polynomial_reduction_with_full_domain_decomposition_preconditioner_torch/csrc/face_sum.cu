// K2: one-pass structured face summation (direct stiffness summation on
// one shard) on a (Mz, My, Mx) point lattice.
//
// Replaces the Pallas TPU kernel of the JAX package (..._tpu/)
//   ops/pallas_kernels.py::lattice_face_sum_3d (_face_sum_kernel)
// which, for x then y then z, computes U += hi*U[X+1] + lo*U[X-1] with
//   hi[X] = 1 iff X % n == n-1 and X != M-1,  lo[X] = 1 iff X % n == 0 and X != 0
// then optionally multiplies by the inverse-multiplicity weight and then
// the Dirichlet mask before one output cast.
//
// What bounds it on an H100: bytes. Per point it must read U (and the
// weight and mask where given) and write the result once: at the 128^3
// main-path lattice 12.6 MB for the composite call (bf16 U and mask,
// 3.8 us at 3.35 TB/s), 25.2 MB for the outer dssum (f32 U, bf16 mask and
// weight, 7.5 us) and 50.3 MB in f64 (15.0 us). Arithmetic is negligible.
//
// Design (first, simple version): one thread per output point (a block
// per 128-wide x-strip of one (y, z) row, so no index divisions). It
// recomputes its x-sums on the <= 9 rows and its y-sums on the <= 3
// planes it needs (27 neighbour reads that mostly hit L1/L2), with the
// reference's association (U + hi*U[x+1]) + lo*U[x-1], then the same over
// y, then over z, in f32 (f64 for f64), reading wrapped neighbours as the
// roll form does. Adds and multiplies are explicitly rounded (no FMA
// contraction), so f32/f64 results are bitwise those of the plain twin.

#include "common.cuh"

namespace prfdd {
namespace {

struct Axis {
  int hi_ok, lo_ok;  // 0/1 masks of this index
  int p, m;          // wrapped neighbour indices (X+1, X-1)
};

__device__ __forceinline__ Axis axis_info(int X, int M, int n) {
  Axis a;
  const int r = X % n;
  a.hi_ok = (r == n - 1 && X != M - 1) ? 1 : 0;
  a.lo_ok = (r == 0 && X != 0) ? 1 : 0;
  a.p = (X + 1 == M) ? 0 : X + 1;
  a.m = (X == 0) ? M - 1 : X - 1;
  return a;
}

// x-sum of one lattice row at x: (U + hi*U[x+1]) + lo*U[x-1]
template <typename Tio, typename Acc>
__device__ __forceinline__ Acc sum_x(const Tio* __restrict__ row, int x,
                                     const Axis& ax) {
  const Acc c = to_acc<Acc>(row[x]);
  const Acc p = to_acc<Acc>(row[ax.p]);
  const Acc m = to_acc<Acc>(row[ax.m]);
  return add_rn(add_rn(c, mul_rn(static_cast<Acc>(ax.hi_ok), p)),
                mul_rn(static_cast<Acc>(ax.lo_ok), m));
}

// xy-sum of one plane at (y, x)
template <typename Tio, typename Acc>
__device__ __forceinline__ Acc sum_xy(const Tio* __restrict__ plane, int mx,
                                      int y, int x, const Axis& ay,
                                      const Axis& axx) {
  const Acc c = sum_x<Tio, Acc>(plane + static_cast<int64_t>(y) * mx, x, axx);
  const Acc p = sum_x<Tio, Acc>(plane + static_cast<int64_t>(ay.p) * mx, x, axx);
  const Acc m = sum_x<Tio, Acc>(plane + static_cast<int64_t>(ay.m) * mx, x, axx);
  return add_rn(add_rn(c, mul_rn(static_cast<Acc>(ay.hi_ok), p)),
                mul_rn(static_cast<Acc>(ay.lo_ok), m));
}

template <typename Tio, typename Tmw>
__global__ void face_sum_kernel(const Tio* __restrict__ u,
                                const Tmw* __restrict__ mask,
                                const Tmw* __restrict__ weight,
                                Tio* __restrict__ out, int mz, int my, int mx,
                                int n) {
  using Acc = typename AccOf<Tio>::type;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= mx) return;
  const int y = blockIdx.y;
  const int z = blockIdx.z;
  const int64_t plane = static_cast<int64_t>(my) * mx;
  const int64_t idx = z * plane + static_cast<int64_t>(y) * mx + x;
  const Axis axx = axis_info(x, mx, n);
  const Axis ay = axis_info(y, my, n);
  const Axis az = axis_info(z, mz, n);
  const Acc c = sum_xy<Tio, Acc>(u + z * plane, mx, y, x, ay, axx);
  const Acc p = sum_xy<Tio, Acc>(u + az.p * plane, mx, y, x, ay, axx);
  const Acc m = sum_xy<Tio, Acc>(u + az.m * plane, mx, y, x, ay, axx);
  Acc r = add_rn(add_rn(c, mul_rn(static_cast<Acc>(az.hi_ok), p)),
                 mul_rn(static_cast<Acc>(az.lo_ok), m));
  if (weight != nullptr) r = mul_rn(r, to_acc<Acc>(weight[idx]));
  if (mask != nullptr) r = mul_rn(r, to_acc<Acc>(mask[idx]));
  store_io(out + idx, r);
}

template <typename Tio, typename Tmw>
cudaError_t launch(const void* u, const void* mask, const void* weight,
                   void* out, int64_t mz, int64_t my, int64_t mx, int n,
                   cudaStream_t stream) {
  const int threads = 128;
  dim3 grid(static_cast<unsigned>((mx + threads - 1) / threads),
            static_cast<unsigned>(my), static_cast<unsigned>(mz));
  face_sum_kernel<Tio, Tmw><<<grid, threads, 0, stream>>>(
      static_cast<const Tio*>(u), static_cast<const Tmw*>(mask),
      static_cast<const Tmw*>(weight), static_cast<Tio*>(out),
      static_cast<int>(mz), static_cast<int>(my), static_cast<int>(mx), n);
  return cudaGetLastError();
}

template <typename Tio>
cudaError_t launch_mw(int mw_dtype, const void* u, const void* mask,
                      const void* weight, void* out, int64_t mz, int64_t my,
                      int64_t mx, int n, cudaStream_t stream) {
  switch (mw_dtype) {
    case kBF16: return launch<Tio, __nv_bfloat16>(u, mask, weight, out, mz, my, mx, n, stream);
    case kF32: return launch<Tio, float>(u, mask, weight, out, mz, my, mx, n, stream);
    case kF64: return launch<Tio, double>(u, mask, weight, out, mz, my, mx, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prfdd

// C interface: dtype / mw_dtype 0 bf16, 1 f32, 2 f64; mask and weight may
// be null (then not applied). Returns cudaGetLastError().
extern "C" int prfdd_face_sum_3d(int dtype, int mw_dtype, int n, const void* u,
                                 const void* mask, const void* weight,
                                 void* out, long long mz, long long my,
                                 long long mx, void* stream) {
  using namespace prfdd;
  if (n < 1 || mz <= 0 || my <= 0 || mx <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return launch_mw<__nv_bfloat16>(mw_dtype, u, mask, weight, out, mz, my, mx, n, st);
    case kF32: return launch_mw<float>(mw_dtype, u, mask, weight, out, mz, my, mx, n, st);
    case kF64: return launch_mw<double>(mw_dtype, u, mask, weight, out, mz, my, mx, n, st);
    default: return cudaErrorInvalidValue;
  }
}

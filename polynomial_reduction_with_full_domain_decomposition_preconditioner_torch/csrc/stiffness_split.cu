// K3: the SEM stiffness apply of K1 with its x- and y-contractions as bf16
// tensor-core passes accumulated in f32 (a precision study of K1).
//
// Replaces the Pallas TPU kernel
//   artifacts/bench_stiffness_precision.py::apply_split (_kernel_split)
// which emulates the f32 contractions of the fused stiffness kernel with
// fewer matrix-unit passes by splitting x = hi + lo, both bf16:
//   f32 I/O  U.D = U_hi.D_hi + U_hi.D_lo + U_lo.D_hi   (3 passes, all four
//            x/y contractions)
//   bf16 I/O U is exact, U.D = U.D_hi + U.D_lo          (2 passes; the f32 W
//            intermediates still take 3)
// The z-contractions and the metric multiply stay f32 FMAs with the unsplit
// f32 D, and nothing is rounded before the single store.
//
// What bounds it on an H100: bytes, as K1 (8 values of the I/O type per
// point: 67.1 MB / 20.0 us in f32 and 33.6 MB / 10.0 us in bf16 at 128^3).
// The 12 (f32) or 10 (bf16) passes are 2 * 8 flops per point each, under
// 1 us at 128^3 at the bf16 tensor rate.
//
// Design (first, simple version), n = 8 only. The TPU kernel multiplies
// 128 x 128 block-diagonal matrices because its matrix unit wants them; per
// element the contraction is (64 lines x 8).(8 x 8), and K = 8 is the K of
// mma.sync.aligned.m16n8k8 (bf16 in, f32 accumulate). One block of 4 warps
// per element; warp w owns the z-planes 2w and 2w+1 and each lane 4 points
// in the accumulator-fragment layout of that instruction:
//   (k, j, i) = (2w + p, lane / 4, 2 * (lane % 4) + q),  p, q in {0, 1}.
//  * x-contractions: the 16 x-lines of the two planes are the A tile (rows
//    p * 8 + j, columns m), which is exactly what the lane holds, so A is
//    split in registers; B[m][i] is D[i][m] (or D[m][i] for the transposed
//    contraction), split once per block. The result lands on the lane's
//    own points.
//  * y-contractions: computed plane by plane as D.U_k with the stacked A
//    tile [D_hi; D_lo] (rows 0-7 and 8-15) and B = U_k read from shared
//    memory with transposed indexing (b = U[k][m][i], m = 2 * (lane % 4) +
//    q, i = lane / 4). Rows j and j + 8 of the accumulator are the D_hi and
//    D_lo parts of the same point and are added: again the lane's own
//    points, so no result is transposed through shared memory. The U_lo
//    pass uses [D_hi; 0].
//  * z-contractions: f32 FMAs over the 8 planes in shared memory, as K1.
// hi is round-to-nearest-even and lo = rn(x - hi) (x - hi is exact in f32).

#include <type_traits>

#include "common.cuh"

namespace prfdd {
namespace {

constexpr int kN = 8;
constexpr int kPlane = kN * kN;
constexpr int kThreads = 128;

struct Split {
  uint32_t hi, lo;  // two bf16 each, the first value in the low half
};

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

__device__ __forceinline__ Split split2(float a, float b) {
  const __nv_bfloat16 ah = __float2bfloat16_rn(a);
  const __nv_bfloat16 bh = __float2bfloat16_rn(b);
  const float ar = __fsub_rn(a, __bfloat162float(ah));
  const float br = __fsub_rn(b, __bfloat162float(bh));
  Split s;
  s.hi = pack_bf16(ah, bh);
  s.lo = pack_bf16(__float2bfloat16_rn(ar), __float2bfloat16_rn(br));
  return s;
}

// c (16 x 8, f32) += a (16 x 8, bf16, row) . b (8 x 8, bf16, col)
__device__ __forceinline__ void mma_m16n8k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  a = __low2float(v);
  b = __high2float(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// x-contraction of the lane's two planes: v[p][q] are the A rows p * 8 + j,
// columns 2t + q. exact: v holds bf16 values (2 passes), else bf16x3.
__device__ __forceinline__ void contract_x(const float (&v)[2][2], Split b,
                                           bool exact, float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  const Split a0 = split2(v[0][0], v[0][1]);
  const Split a1 = split2(v[1][0], v[1][1]);
  mma_m16n8k8(c, a0.hi, a1.hi, b.hi);
  mma_m16n8k8(c, a0.hi, a1.hi, b.lo);
  if (!exact) mma_m16n8k8(c, a0.lo, a1.lo, b.hi);
}

// y-contraction of one plane: s points at the plane's 8 x 8 values in shared
// memory; d.hi / d.lo are the lane's pairs of the stacked A tile [D_hi; D_lo].
// Returns the two values at (j, 2t), (j, 2t + 1).
__device__ __forceinline__ void contract_y(const float* s, int g, int t2,
                                           Split d, bool exact, float& r0,
                                           float& r1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const Split b = split2(s[t2 * kN + g], s[(t2 + 1) * kN + g]);
  mma_m16n8k8(c, d.hi, d.lo, b.hi);
  if (!exact) mma_m16n8k8(c, d.hi, 0u, b.lo);
  r0 = c[0] + c[2];
  r1 = c[1] + c[3];
}

template <typename Tio>
__global__ void __launch_bounds__(kThreads)
stiffness_split_kernel(const Tio* __restrict__ u,
                       const Tio* __restrict__ g0, const Tio* __restrict__ g1,
                       const Tio* __restrict__ g2, const Tio* __restrict__ g3,
                       const Tio* __restrict__ g4, const Tio* __restrict__ g5,
                       const float* __restrict__ dmat, Tio* __restrict__ out,
                       int my, int mx) {
  constexpr bool kExactU = std::is_same<Tio, __nv_bfloat16>::value;
  __shared__ float sD[kN * kN];
  __shared__ float sU[kN * kPlane];   // (k, j, i)
  __shared__ float sWs[kN * kPlane];
  __shared__ float sWt[kN * kPlane];

  const int lane = threadIdx.x & 31;
  const int k0 = (threadIdx.x >> 5) * 2;  // the warp's first plane
  const int g = lane >> 2;                // y within the element
  const int t2 = (lane & 3) * 2;          // first x of the lane's pair

  int64_t off[2];
  int sidx[2];
  for (int p = 0; p < 2; ++p) {
    const int64_t z = static_cast<int64_t>(blockIdx.z) * kN + k0 + p;
    const int64_t y = static_cast<int64_t>(blockIdx.y) * kN + g;
    off[p] = (z * my + y) * mx + static_cast<int64_t>(blockIdx.x) * kN + t2;
    sidx[p] = (k0 + p) * kPlane + g * kN + t2;
  }

  if (threadIdx.x < kN * kN) sD[threadIdx.x] = dmat[threadIdx.x];
  float uv[2][2], G[6][2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    load_pair(u + off[p], uv[p][0], uv[p][1]);
    load_pair(g0 + off[p], G[0][p][0], G[0][p][1]);
    load_pair(g1 + off[p], G[1][p][0], G[1][p][1]);
    load_pair(g2 + off[p], G[2][p][0], G[2][p][1]);
    load_pair(g3 + off[p], G[3][p][0], G[3][p][1]);
    load_pair(g4 + off[p], G[4][p][0], G[4][p][1]);
    load_pair(g5 + off[p], G[5][p][0], G[5][p][1]);
    sU[sidx[p]] = uv[p][0];
    sU[sidx[p] + 1] = uv[p][1];
  }
  __syncthreads();

  // the lane's pairs of D (rows of D) and of D^T, split once
  const Split dd = split2(sD[g * kN + t2], sD[g * kN + t2 + 1]);
  const Split dt = split2(sD[t2 * kN + g], sD[(t2 + 1) * kN + g]);

  // Dr, Ds on tensor cores; Dt in f32
  float c[4];
  contract_x(uv, dd, kExactU, c);
  float wr[2][2], ws[2][2], wt[2][2];
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float ds[2];
    contract_y(sU + (k0 + p) * kPlane, g, t2, dd, kExactU, ds[0], ds[1]);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float dr = c[2 * p + q];
      float dz = 0.f;
#pragma unroll
      for (int m = 0; m < kN; ++m)
        dz += sD[(k0 + p) * kN + m] * sU[m * kPlane + g * kN + t2 + q];
      wr[p][q] = G[0][p][q] * dr + G[3][p][q] * ds[q] + G[4][p][q] * dz;
      ws[p][q] = G[3][p][q] * dr + G[1][p][q] * ds[q] + G[5][p][q] * dz;
      wt[p][q] = G[4][p][q] * dr + G[5][p][q] * ds[q] + G[2][p][q] * dz;
    }
    sWs[sidx[p]] = ws[p][0];
    sWs[sidx[p] + 1] = ws[p][1];
    sWt[sidx[p]] = wt[p][0];
    sWt[sidx[p] + 1] = wt[p][1];
  }
  __syncthreads();

  // the transposed contractions; the W intermediates are f32: bf16x3
  contract_x(wr, dt, false, c);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    float as[2];
    contract_y(sWs + (k0 + p) * kPlane, g, t2, dt, false, as[0], as[1]);
    float au[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      float az = 0.f;
#pragma unroll
      for (int m = 0; m < kN; ++m)
        az += sD[m * kN + k0 + p] * sWt[m * kPlane + g * kN + t2 + q];
      au[q] = (c[2 * p + q] + as[q]) + az;
    }
    store_pair(out + off[p], au[0], au[1]);
  }
}

template <typename Tio>
cudaError_t launch(const void* u, const void* const* g, const void* dmat,
                   void* out, int64_t mz, int64_t my, int64_t mx,
                   cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(mx / kN), static_cast<unsigned>(my / kN),
            static_cast<unsigned>(mz / kN));
  stiffness_split_kernel<Tio><<<grid, kThreads, 0, stream>>>(
      static_cast<const Tio*>(u),
      static_cast<const Tio*>(g[0]), static_cast<const Tio*>(g[1]),
      static_cast<const Tio*>(g[2]), static_cast<const Tio*>(g[3]),
      static_cast<const Tio*>(g[4]), static_cast<const Tio*>(g[5]),
      static_cast<const float*>(dmat), static_cast<Tio*>(out),
      static_cast<int>(my), static_cast<int>(mx));
  return cudaGetLastError();
}

}  // namespace
}  // namespace prfdd

// C interface, as prfdd_stiffness_3d: dtype 0 bf16 / 1 f32 (all seven
// lattices share it; f64 is refused), n must be 8, dmat is the 8 x 8
// differentiation matrix in f32. Returns cudaGetLastError().
extern "C" int prfdd_stiffness_split_3d(int dtype, int n, const void* u,
                                        const void* g0, const void* g1,
                                        const void* g2, const void* g3,
                                        const void* g4, const void* g5,
                                        const void* dmat, void* out,
                                        long long mz, long long my,
                                        long long mx, void* stream) {
  using namespace prfdd;
  if (n != kN || mz % kN || my % kN || mx % kN) return cudaErrorInvalidValue;
  const void* g[6] = {g0, g1, g2, g3, g4, g5};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return launch<__nv_bfloat16>(u, g, dmat, out, mz, my, mx, st);
    case kF32: return launch<float>(u, g, dmat, out, mz, my, mx, st);
    default: return cudaErrorInvalidValue;
  }
}

// K1: fused SEM stiffness apply on a (Mz, My, Mx) point lattice.
//
// Replaces the Pallas TPU kernel of the JAX package (..._tpu/)
//   ops/pallas_kernels.py::stiffness_lattice_3d (_stiffness_kernel)
// which computes the local, unassembled image Au = sum_a D_a^T sum_b G_ab D_b u
// one n^3 element at a time, reading u and the six metric factors once and
// writing Au once, with f32 accumulation for bf16 I/O.
//
// What bounds it on an H100: bytes. Per point it must move (1 + 6 + 1)
// values of the I/O type — 32 B in f32, 16 B in bf16, 64 B in f64: at the
// 128^3 main-path lattice 67.1 MB (20.0 us at 3.35 TB/s), 33.6 MB (10.0 us)
// and 134 MB (40.1 us). Its (12n + 18) flops per point are 239 MFLOP at
// n = 8, about 3.6 us at the 67 TFLOP/s f32 non-tensor rate. What a
// kernel can lose its time on is shared memory (a contraction that reads
// both of its operands there makes 12n shared loads a point, more than an
// SM's one wavefront a clock can serve within the byte bound) and then
// registers: what it keeps out of shared memory limits the warps an SM
// holds to hide its barriers and its loads.
//
// Design: the register-blocked column layout of GPU spectral-element codes
// (the axhelm kernels of libParanumal / NekRS; Swirydowicz et al.,
// "Acceleration of tensor-product operations for high-order finite element
// methods", IJHPCA 2019).
// - One thread per (i, j) column of an element. It holds its n values of u
//   along k and its n partial sums of Au in registers. A block is an
//   x-strip of EX elements (EX * n of up to 32 points, 16 in f64, so a
//   warp's rows are contiguous runs of at least 32 bytes in bf16) times EY
//   elements in y for small n, at most 256 threads, and walks EZ elements
//   in z (ops/kernels.py::_stiffness_plan picks EY and EZ so that the grid
//   fills the card in about one wave).
// - The z-contraction (dt = D[k][.] u, and the scatter Au[.] += D[k][.] Wt)
//   runs in registers; D[k][m] has a compile-time index into the kernel's
//   parameter block (D arrives by value, in the accumulation type, from
//   the host's f64 GLL table), so it is a constant-bank operand of the FMA
//   and costs no load.
// - Only the x- and y-contractions use shared memory. An element's u is
//   staged whole (n planes); then, plane by plane: dr, ds from the staged
//   plane; Wr, Ws, Wt in the accumulation type from the plane's six
//   factors (fetched one plane ahead, straight to registers, consumed at
//   once); Wr and Ws staged in one of two buffers taken in turn; their
//   transposed contractions added. One barrier a plane.
// - The D rows and columns of the thread's own i and j (4n values) sit in
//   registers (in f64 those of j stay in shared memory, see kJShared), so each
//   FMA of those contractions reads one shared value: 4n shared loads a
//   point instead of 12n, and x-rows are read as 16-byte vectors where n
//   allows it (n = 4, 8; even n in f64). They reach the registers by way
//   of a padded shared copy of D: the parameter block serves a warp one
//   address at a time, and the threads of a warp differ in i.
// - Global loads and the store are coalesced over the strip's x-extent.
//   They are scalar: a column's points are a plane pitch apart, and a
//   strip row already fills its 32-byte sectors.
// No derivative or W intermediate is rounded to the I/O type; one cast at
// the store. Any element-aligned lattice is accepted, n = 2..8.

#include "common.cuh"

namespace prfdd {
namespace {

constexpr int kMaxThreads = 256;

// The register budget is set for two blocks of 256 threads an SM: 128
// registers a thread.
constexpr int kMinBlocks = 2;

// In f64 every value takes two registers, and the full set (4n of D, 2n of
// u and Au, the plane's factors) spills under that budget at n = 8. D's
// rows and columns of the thread's j are then read from shared memory; a
// warp's threads share one or two values of j, so those reads broadcast.
template <typename Acc> constexpr bool kJShared = sizeof(Acc) == 8;

// Elements per block along x: the largest power of two with EX * N points
// within 32 (16 for f64, whose registers are twice as wide). Mirrored by
// ops/kernels.py::_stiffness_strip.
template <typename Tio, int N>
struct Strip {
  static constexpr int kTarget = (sizeof(Tio) == 8) ? 16 : 32;
  static constexpr int pow2_floor(int v) {
    int p = 1;
    while (2 * p <= v) p *= 2;
    return p;
  }
  static constexpr int EX = pow2_floor(kTarget / N);
  static constexpr int XW = EX * N;   // points of a strip row
};

template <typename Acc, int N>
struct DTable {
  Acc d[N * N];   // D[a][b] at a * N + b
};

// N consecutive shared values into registers, as 16-byte reads where the
// row start is 16-byte aligned for every element of the strip.
template <typename Acc, int N>
__device__ __forceinline__ void load_row(const Acc* __restrict__ p, Acc (&r)[N]) {
  constexpr int W = 16 / static_cast<int>(sizeof(Acc));
  if constexpr (N % W == 0) {
    struct alignas(16) Q { Acc v[W]; };
#pragma unroll
    for (int q = 0; q < N / W; ++q) {
      const Q t = reinterpret_cast<const Q*>(p)[q];
#pragma unroll
      for (int w = 0; w < W; ++w) r[q * W + w] = t.v[w];
    }
  } else {
#pragma unroll
    for (int m = 0; m < N; ++m) r[m] = p[m];
  }
}

template <typename Tio, int N>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
stiffness_kernel(const Tio* __restrict__ u,
                 const Tio* __restrict__ g0, const Tio* __restrict__ g1,
                 const Tio* __restrict__ g2, const Tio* __restrict__ g3,
                 const Tio* __restrict__ g4, const Tio* __restrict__ g5,
                 const __grid_constant__ DTable<typename AccOf<Tio>::type, N> dm,
                 Tio* __restrict__ out, int my, int mx, int ex, int ey, int ez,
                 int ey_blk, int ez_blk) {
  using Acc = typename AccOf<Tio>::type;
  constexpr int XW = Strip<Tio, N>::XW;
  constexpr bool JS = kJShared<Acc>;
  constexpr int NP = N + 1;   // padded row of sD: lanes of different i, other banks
  __shared__ __align__(16) Acc sU[N][kMaxThreads];      // (k; row, x)
  __shared__ __align__(16) Acc sWr[2][kMaxThreads];     // two planes in turn
  __shared__ __align__(16) Acc sWs[2][kMaxThreads];
  __shared__ Acc sD[N * NP];

  const int t = threadIdx.x;
  const int xl = t % XW, jl = t / XW;
  const int i = xl % N, j = jl % N;
  const int xb = xl - i, yb = jl - j;  // first x / row of this thread's element
  const bool valid = static_cast<int>(blockIdx.x) * Strip<Tio, N>::EX + xl / N < ex &&
                     static_cast<int>(blockIdx.y) * ey_blk + jl / N < ey;
  const int64_t x = static_cast<int64_t>(blockIdx.x) * XW + xl;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * (ey_blk * N) + jl;
  const int64_t ps = static_cast<int64_t>(my) * mx;   // plane stride

  // D's rows and columns of this thread's own i and j, by way of shared
  // memory (the parameter block serves one address a warp at a time)
  for (int q = t; q < N * N; q += blockDim.x) sD[(q / N) * NP + q % N] = dm.d[q];
  __syncthreads();
  Acc Di[N], DTi[N], Dj[JS ? 1 : N], DTj[JS ? 1 : N];
#pragma unroll
  for (int m = 0; m < N; ++m) {
    Di[m] = sD[i * NP + m];
    DTi[m] = sD[m * NP + i];
    if constexpr (!JS) {
      Dj[m] = sD[j * NP + m];
      DTj[m] = sD[m * NP + j];
    }
  }
  auto d_j = [&](int m) -> Acc {
    if constexpr (JS) return sD[j * NP + m]; else return Dj[m];
  };
  auto dt_j = [&](int m) -> Acc {
    if constexpr (JS) return sD[m * NP + j]; else return DTj[m];
  };
  const int s = jl * XW + xl;        // own slot of a staged plane
  const int srow = jl * XW + xb;     // own element's x-row
  const int scol = yb * XW + xl;     // own element's y-column

  for (int e = 0; e < ez_blk; ++e) {
    const int ezi = static_cast<int>(blockIdx.z) * ez_blk + e;
    if (ezi >= ez) break;            // uniform over the block
    const int64_t base = (static_cast<int64_t>(ezi) * N * my + y) * mx + x;
    const Tio* g[6] = {g0 + base, g1 + base, g2 + base, g3 + base, g4 + base, g5 + base};

    Acc uk[N], au[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      uk[k] = valid ? to_acc<Acc>(u[base + k * ps]) : Acc(0);
      au[k] = Acc(0);
    }
    Tio graw[6];   // the next plane's factors, in flight while this one computes
#pragma unroll
    for (int q = 0; q < 6; ++q) graw[q] = valid ? g[q][0] : Tio(0.0f);
    // the block's previous element read sU before its last barrier
#pragma unroll
    for (int k = 0; k < N; ++k) sU[k][s] = uk[k];
    __syncthreads();

#pragma unroll
    for (int k = 0; k < N; ++k) {
      const Acc G0 = to_acc<Acc>(graw[0]), G1 = to_acc<Acc>(graw[1]),
                G2 = to_acc<Acc>(graw[2]), G3 = to_acc<Acc>(graw[3]),
                G4 = to_acc<Acc>(graw[4]), G5 = to_acc<Acc>(graw[5]);
      if (k + 1 < N) {
#pragma unroll
        for (int q = 0; q < 6; ++q)
          graw[q] = valid ? g[q][(k + 1) * ps] : Tio(0.0f);
      }

      // reference-coordinate derivatives: r along x, s along y, t along z
      Acc row[N];
      load_row<Acc, N>(&sU[k][srow], row);
      Acc dr = 0, ds = 0, dt = 0;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        dr += Di[m] * row[m];
        ds += d_j(m) * sU[k][scol + m * XW];
        dt += dm.d[k * N + m] * uk[m];
      }
      const Acc Wr = G0 * dr + G3 * ds + G4 * dt;
      const Acc Ws = G3 * dr + G1 * ds + G5 * dt;
      const Acc Wt = G4 * dr + G5 * ds + G2 * dt;
      // z: Au[m] += D[k][m] * Wt[k]
#pragma unroll
      for (int m = 0; m < N; ++m) au[m] += dm.d[k * N + m] * Wt;
      // plane k - 2, the last in this buffer, was read before the barrier
      // of plane k - 1: one barrier a plane is enough
      sWr[k & 1][s] = Wr;
      sWs[k & 1][s] = Ws;
      __syncthreads();

      // x and y: Au[k] += sum_m D[m][i] Wr[m] + sum_m D[m][j] Ws[m]
      load_row<Acc, N>(&sWr[k & 1][srow], row);
      Acc a = 0;
#pragma unroll
      for (int m = 0; m < N; ++m) {
        a += DTi[m] * row[m];
        a += dt_j(m) * sWs[k & 1][scol + m * XW];
      }
      au[k] += a;
    }
    if (valid) {
#pragma unroll
      for (int k = 0; k < N; ++k) store_io(out + base + k * ps, au[k]);
    }
    // the next element's sU is written after this element's last barrier,
    // past every read of sU, and before its own first barrier
  }
}

template <typename Tio, int N>
cudaError_t launch_n(const void* u, const void* const* g, const double* dmat,
                     void* out, int64_t mz, int64_t my, int64_t mx, int ex_blk,
                     int ey_blk, int ez_blk, cudaStream_t stream) {
  using Acc = typename AccOf<Tio>::type;
  using S = Strip<Tio, N>;
  const int ex = static_cast<int>(mx / N), ey = static_cast<int>(my / N),
            ez = static_cast<int>(mz / N);
  const int64_t threads = static_cast<int64_t>(S::XW) * ey_blk * N;
  const int64_t gx = (ex + S::EX - 1) / S::EX, gy = (ey + ey_blk - 1) / ey_blk,
                gz = (ez + ez_blk - 1) / ez_blk;
  if (ex_blk != S::EX || threads > kMaxThreads || gy > 65535 || gz > 65535)
    return cudaErrorInvalidValue;
  DTable<Acc, N> dm;
  for (int q = 0; q < N * N; ++q) dm.d[q] = static_cast<Acc>(dmat[q]);
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
            static_cast<unsigned>(gz));
  stiffness_kernel<Tio, N><<<grid, static_cast<unsigned>(threads), 0, stream>>>(
      static_cast<const Tio*>(u),
      static_cast<const Tio*>(g[0]), static_cast<const Tio*>(g[1]),
      static_cast<const Tio*>(g[2]), static_cast<const Tio*>(g[3]),
      static_cast<const Tio*>(g[4]), static_cast<const Tio*>(g[5]),
      dm, static_cast<Tio*>(out), static_cast<int>(my), static_cast<int>(mx),
      ex, ey, ez, ey_blk, ez_blk);
  return cudaGetLastError();
}

template <typename Tio>
cudaError_t launch_t(int n, const void* u, const void* const* g,
                     const double* dmat, void* out, int64_t mz, int64_t my,
                     int64_t mx, int ex_blk, int ey_blk, int ez_blk,
                     cudaStream_t stream) {
  switch (n) {
#define PRFDD_STIFFNESS_N(N) \
    case N: return launch_n<Tio, N>(u, g, dmat, out, mz, my, mx, ex_blk, ey_blk, ez_blk, stream);
    PRFDD_STIFFNESS_N(2)
    PRFDD_STIFFNESS_N(3)
    PRFDD_STIFFNESS_N(4)
    PRFDD_STIFFNESS_N(5)
    PRFDD_STIFFNESS_N(6)
    PRFDD_STIFFNESS_N(7)
    PRFDD_STIFFNESS_N(8)
#undef PRFDD_STIFFNESS_N
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prfdd

// C interface: dtype 0 bf16 / 1 f32 / 2 f64 (all seven lattices share it);
// dmat is the n x n GLL differentiation matrix in f64 ON THE HOST (it is
// cast to the accumulation type, f32 for bf16 and f32 I/O, and passed to
// the kernel by value). The launch plan comes from
// ops/kernels.py::_stiffness_plan: a block takes ex_blk x ey_blk elements
// in x and y and walks ez_blk elements in z. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for a plan the kernel does not take.
extern "C" int prfdd_stiffness_3d(int dtype, int n, const void* u,
                                  const void* g0, const void* g1,
                                  const void* g2, const void* g3,
                                  const void* g4, const void* g5,
                                  const double* dmat, void* out, long long mz,
                                  long long my, long long mx, int ex_blk,
                                  int ey_blk, int ez_blk, void* stream) {
  using namespace prfdd;
  if (mz <= 0 || my <= 0 || mx <= 0 || mx > 2147483647LL || ex_blk < 1 ||
      ey_blk < 1 || ez_blk < 1 || dmat == nullptr)
    return cudaErrorInvalidValue;
  const void* g[6] = {g0, g1, g2, g3, g4, g5};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return launch_t<__nv_bfloat16>(n, u, g, dmat, out, mz, my, mx, ex_blk, ey_blk, ez_blk, st);
    case kF32: return launch_t<float>(n, u, g, dmat, out, mz, my, mx, ex_blk, ey_blk, ez_blk, st);
    case kF64: return launch_t<double>(n, u, g, dmat, out, mz, my, mx, ex_blk, ey_blk, ez_blk, st);
    default: return cudaErrorInvalidValue;
  }
}

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
// n = 8, about 3.6 us at the 67 TFLOP/s f32 non-tensor rate.
//
// Design (first, simple version): one thread per lattice point, one block
// per x-strip of EPB elements (EPB * n^3 threads, ~256-512). Threads are
// ordered x-fastest, so a warp reads whole contiguous element rows. The
// block stages u in shared memory, reads each point's six factors once
// into registers, computes Dr/Ds/Dt and Wr/Ws/Wt in the accumulation type
// (no intermediate is ever rounded to bf16), stages W in shared memory and
// applies the transposed contractions before one store. D (n x n, from the
// host f64 GLL table in the accumulation type) sits in shared memory.
// Any element-aligned lattice is accepted (no 128-alignment as on the TPU).

#include "common.cuh"

namespace prfdd {
namespace {

template <int N>
struct Tile {
  static constexpr int N3 = N * N * N;
  static constexpr int EPB = (N3 >= 256) ? 1 : (256 / N3);  // elements per block
  static constexpr int ROW = EPB * N;                        // x extent of the tile
  static constexpr int THREADS = EPB * N3;
};

template <typename Tio, int N>
__global__ void __launch_bounds__(Tile<N>::THREADS)
stiffness_kernel(const Tio* __restrict__ u,
                 const Tio* __restrict__ g0, const Tio* __restrict__ g1,
                 const Tio* __restrict__ g2, const Tio* __restrict__ g3,
                 const Tio* __restrict__ g4, const Tio* __restrict__ g5,
                 const typename AccOf<Tio>::type* __restrict__ dmat,
                 Tio* __restrict__ out, int my, int mx, int ex) {
  using Acc = typename AccOf<Tio>::type;
  constexpr int ROW = Tile<N>::ROW;
  constexpr int EPB = Tile<N>::EPB;
  constexpr int PLANE = N * ROW;
  __shared__ Acc sD[N * N];
  __shared__ Acc sU[N * PLANE];   // (k, j, x) with x = e*N + i
  __shared__ Acc sWr[N * PLANE];
  __shared__ Acc sWs[N * PLANE];
  __shared__ Acc sWt[N * PLANE];

  const int t = threadIdx.x;
  const int xl = t % ROW;
  const int j = (t / ROW) % N;
  const int k = t / PLANE;
  const int i = xl % N;
  const int xb = xl - i;  // first x of this thread's element in the tile
  const bool valid = static_cast<int>(blockIdx.x) * EPB + xl / N < ex;
  const int64_t x = static_cast<int64_t>(blockIdx.x) * ROW + xl;
  const int64_t y = static_cast<int64_t>(blockIdx.y) * N + j;
  const int64_t z = static_cast<int64_t>(blockIdx.z) * N + k;
  const int64_t off = (z * my + y) * mx + x;

  for (int q = t; q < N * N; q += blockDim.x) sD[q] = dmat[q];
  const int s = k * PLANE + j * ROW + xl;
  Acc G0 = 0, G1 = 0, G2 = 0, G3 = 0, G4 = 0, G5 = 0;
  Acc uv = 0;
  if (valid) {
    uv = to_acc<Acc>(u[off]);
    G0 = to_acc<Acc>(g0[off]);
    G1 = to_acc<Acc>(g1[off]);
    G2 = to_acc<Acc>(g2[off]);
    G3 = to_acc<Acc>(g3[off]);
    G4 = to_acc<Acc>(g4[off]);
    G5 = to_acc<Acc>(g5[off]);
  }
  sU[s] = uv;
  __syncthreads();

  // reference-coordinate derivatives: r along x, s along y, t along z
  Acc dr = 0, ds = 0, dt = 0;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    dr += sD[i * N + m] * sU[k * PLANE + j * ROW + xb + m];
    ds += sD[j * N + m] * sU[k * PLANE + m * ROW + xl];
    dt += sD[k * N + m] * sU[m * PLANE + j * ROW + xl];
  }
  sWr[s] = G0 * dr + G3 * ds + G4 * dt;
  sWs[s] = G3 * dr + G1 * ds + G5 * dt;
  sWt[s] = G4 * dr + G5 * ds + G2 * dt;
  __syncthreads();

  // transposed contractions: sum_m D[m, i] W[..., m]
  Acc au = 0;
#pragma unroll
  for (int m = 0; m < N; ++m) {
    au += sD[m * N + i] * sWr[k * PLANE + j * ROW + xb + m];
    au += sD[m * N + j] * sWs[k * PLANE + m * ROW + xl];
    au += sD[m * N + k] * sWt[m * PLANE + j * ROW + xl];
  }
  if (valid) store_io(out + off, au);
}

template <typename Tio, int N>
cudaError_t launch_n(const void* u, const void* const* g, const void* dmat,
                     void* out, int64_t mz, int64_t my, int64_t mx,
                     cudaStream_t stream) {
  using Acc = typename AccOf<Tio>::type;
  const int ex = static_cast<int>(mx / N);
  dim3 grid((ex + Tile<N>::EPB - 1) / Tile<N>::EPB,
            static_cast<unsigned>(my / N), static_cast<unsigned>(mz / N));
  stiffness_kernel<Tio, N><<<grid, Tile<N>::THREADS, 0, stream>>>(
      static_cast<const Tio*>(u),
      static_cast<const Tio*>(g[0]), static_cast<const Tio*>(g[1]),
      static_cast<const Tio*>(g[2]), static_cast<const Tio*>(g[3]),
      static_cast<const Tio*>(g[4]), static_cast<const Tio*>(g[5]),
      static_cast<const Acc*>(dmat), static_cast<Tio*>(out),
      static_cast<int>(my), static_cast<int>(mx), ex);
  return cudaGetLastError();
}

template <typename Tio>
cudaError_t launch_t(int n, const void* u, const void* const* g,
                     const void* dmat, void* out, int64_t mz, int64_t my,
                     int64_t mx, cudaStream_t stream) {
  switch (n) {
    case 2: return launch_n<Tio, 2>(u, g, dmat, out, mz, my, mx, stream);
    case 3: return launch_n<Tio, 3>(u, g, dmat, out, mz, my, mx, stream);
    case 4: return launch_n<Tio, 4>(u, g, dmat, out, mz, my, mx, stream);
    case 5: return launch_n<Tio, 5>(u, g, dmat, out, mz, my, mx, stream);
    case 6: return launch_n<Tio, 6>(u, g, dmat, out, mz, my, mx, stream);
    case 7: return launch_n<Tio, 7>(u, g, dmat, out, mz, my, mx, stream);
    case 8: return launch_n<Tio, 8>(u, g, dmat, out, mz, my, mx, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prfdd

// C interface: dtype 0 bf16 / 1 f32 / 2 f64 (all seven lattices share it);
// dmat is the n x n differentiation matrix in the accumulation type (f32
// for bf16 and f32 I/O, f64 for f64). Returns cudaGetLastError().
extern "C" int prfdd_stiffness_3d(int dtype, int n, const void* u,
                                  const void* g0, const void* g1,
                                  const void* g2, const void* g3,
                                  const void* g4, const void* g5,
                                  const void* dmat, void* out, long long mz,
                                  long long my, long long mx, void* stream) {
  using namespace prfdd;
  const void* g[6] = {g0, g1, g2, g3, g4, g5};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return launch_t<__nv_bfloat16>(n, u, g, dmat, out, mz, my, mx, st);
    case kF32: return launch_t<float>(n, u, g, dmat, out, mz, my, mx, st);
    case kF64: return launch_t<double>(n, u, g, dmat, out, mz, my, mx, st);
    default: return cudaErrorInvalidValue;
  }
}

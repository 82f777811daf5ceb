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
// f32 D, Au = (x-part + y-part) + z-part, and nothing is rounded before the
// single store. The TPU kernel takes every n with 128 % n == 0 by
// contracting with the block-diagonal kron(I_{128/n}, D); this kernel does
// the same at 8: n = 2, 4 and 8, with the 8 x 8 operand kron(I_{8/n}, D_n),
// so that an 8^3 tile holds (8/n)^3 whole elements. The hi/lo split of the
// block-diagonal matrix is that of D_n (zeros split to zeros).
//
// What bounds it on an H100: bytes, as K1 (8 values of the I/O type per
// point: 67.1 MB / 20.0 us in f32 and 33.6 MB / 10.0 us in bf16 at 128^3).
// The 12 (f32) or 10 (bf16) passes are 2 * 8 flops per point each, under
// 1 us at 128^3 even at mma.sync rates. What a kernel can lose its time on
// is everything between the load and the store: z-contractions that read
// both operands from shared memory (48 shared wavefronts per 32 points,
// more than the whole bf16 byte bound at 128^3), scalar transposed reads
// for the y-contractions, loads of one point pair a lane that fill half a
// 32-byte sector with nothing else in flight, and, once those are gone,
// the instructions a tile costs (about 1,000 of arithmetic, issued at up
// to 4 a clock an SM) and device memory read in short runs.
//
// Design.
// - One warp per 8 x 8 x 8 tile. In the accumulator layout of
//   mma.sync.aligned.m16n8k8 (bf16 in, f32 accumulate), which is also its
//   A layout, a lane holds the rows g = lane / 4 and g + 8 at the columns
//   2 * (lane % 4) + {0, 1}; rows are (plane, y) and columns x, so four
//   instructions cover the 8 planes and a lane owns two whole z-columns
//   (k = 0..7, j = g, i = 2 * (lane % 4) + {0, 1}), 16 points.
// - z-contractions in registers: dz[k] = sum_m D[k][m] u[m] and the scatter
//   az[m] += D[k][m] Wt[k] are FMA chains over the lane's own column, D[k][m]
//   a compile-time index into the kernel's parameter block (a constant-bank
//   operand, no load).
// - x-contractions: the lane's points of two planes are the A tile, B is
//   the lane's pair of D (or D^T), split once per block. The halves D_hi and
//   D_lo lie along k of one m16n8k16 pass against A_hi twice, so the tensor
//   core sums them; A_lo . D_hi is an m16n8k8 pass into the same sums.
// - y-contractions, plane by plane: D . U_k with A = [D_hi | D_lo] along k
//   (rows 8-15 zero) and B = [U_k^T; U_k^T], U_k^T transposed in registers
//   by movmatrix.sync.aligned.m8n8.trans.b16 from the lane's own packed
//   bf16 pairs (u exact in bf16, or the hi and lo halves after the split;
//   f32 is never transposed). Row j of the result is the lane's own point.
//   The U_lo pass is D_hi . U_lo^T. Wr and Ws are contracted as soon as
//   their plane pair or plane is formed: no W round trip through shared
//   memory.
// - Pipelined global traffic. A block of TX warps takes a super-tile of TX
//   x-adjacent tiles and walks super-tiles with the grid's stride. It
//   stages u and the six factors of the next S - 1 super-tiles with
//   cp.async vectors of VB bytes (16 where pitch and pointers allow, down to
//   a point pair) into S buffers of dynamic shared memory while it computes
//   the current one; the copies ask the L2 for the whole 128-byte line
//   (.L2::128B), so device memory is read in lines although a super-tile
//   row is 32 or 64 bytes. Shared memory holds each tile as 8 planes of 8
//   rows of 8 points (tile-major), so a warp reads a plane of one lattice as
//   one contiguous run: conflict-free. A thread's vectors of a lattice
//   differ in z only, so their offsets are fixed for the kernel. Au is
//   written back into the tile's u slot and stored after a barrier in the
//   same vectors, whole rows of the super-tile.
// - Ragged edges (a lattice aligned to elements, not to 8-point tiles)
//   load as zeros and are not stored; a vector never straddles the
//   lattice's end because it divides the row pitch, and zero points
//   contribute nothing to a neighbour: elements never cross a tile.
// The launch plan (VB, TX, S, blocks) comes from ops/kernels.py::_split_plan
// and rests on studies/launch_plan_sweep.py: where the seven inputs fit in
// the L2, 2 tiles a block, 3 stages and every block an SM holds; else
// 64-byte super-tile rows, 2 stages and 2 blocks an SM (fewer streams read
// device memory in longer runs).
// hi is round-to-nearest-even and lo = rn(x - hi) (x - hi is exact in f32).

#include <type_traits>

#include "common.cuh"

namespace prfdd {
namespace {

constexpr int kT = 8;                 // tile edge, the K of m16n8k8
constexpr int kTilePts = kT * kT * kT;
constexpr int kLattices = 7;          // u and the six factors
constexpr int kMaxThreads = 256;      // at most 8 tiles (warps) a block

struct DTable8 {
  float d[kT * kT];   // kron(I_{8/n}, D_n)[a][b] at a * 8 + b, f32
};

template <typename Tio>
struct Operands {
  const Tio* p[kLattices];   // u, G_rr, G_ss, G_tt, G_rs, G_rt, G_st
};

struct Split {
  uint32_t hi, lo;  // two bf16 each, the first value in the low half
};

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t r;
  __builtin_memcpy(&r, &v, sizeof(r));
  return r;
}

// hi = rn(x), lo = rn(x - hi) for two values, each pair packed as one
// conversion (the first value in the low half)
__device__ __forceinline__ Split split2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  Split s;
  s.hi = bits(h);
  s.lo = bits(__floats2bfloat162_rn(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y)));
  return s;
}

// c (16 x 8, f32) += a (16 x 8, bf16, row) . b (8 x 8, bf16, col)
__device__ __forceinline__ void mma_m16n8k8(float (&c)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col); a0/a1
// are rows g / g + 8 at k = 2t, 2t + 1, a2/a3 the same rows at k + 8, b0/b1
// rows k = 2t, 2t + 1 and k + 8 at column g
__device__ __forceinline__ void mma_m16n8k16(float (&c)[4], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The 8 x 8 bf16 matrix whose row lane / 4, columns 2 * (lane % 4) + {0, 1}
// this lane holds, transposed, in the same layout.
__device__ __forceinline__ uint32_t transpose8x8(uint32_t a) {
  uint32_t d;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d) : "r"(a));
  return d;
}

// VB bytes global -> shared, asynchronously; zeros when !valid (src points
// at a valid address all the same).
template <int VB>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? VB : 0;
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global.L2::128B [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(gmem), "n"(VB), "r"(src_bytes) : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <int VB> struct VecOf;
template <> struct VecOf<4> { using type = uint32_t; };
template <> struct VecOf<8> { using type = uint2; };
template <> struct VecOf<16> { using type = uint4; };

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

// x-contraction of two planes: a0 / a1 hold the A rows j / 8 + j (the
// lane's points of the two planes), b the lane's pair of the contracted
// matrix M. One k = 16 pass takes A_hi against [M_hi; M_lo] (the two halves
// summed in the tensor core); A_lo . M_hi follows unless A is exact.
__device__ __forceinline__ void contract_x(const Split& a0, const Split& a1,
                                           const Split& b, bool exact,
                                           float (&c)[4]) {
  c[0] = c[1] = c[2] = c[3] = 0.f;
  mma_m16n8k16(c, a0.hi, a1.hi, a0.hi, a1.hi, b.hi, b.lo);
  if (!exact) mma_m16n8k8(c, a0.lo, a1.lo, b.hi);
}

// y-contraction of one plane whose lane values are the pairs a (split):
// d.hi / d.lo are the lane's pairs of the row j of M_hi / M_lo, laid along
// k as [M_hi | M_lo] against [A^T; A^T] in one k = 16 pass (rows 8-15 are
// zero), then M_hi . A_lo^T unless A is exact. Returns the two values at the
// lane's own points.
__device__ __forceinline__ void contract_y(const Split& a, const Split& d,
                                           bool exact, float& r0, float& r1) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  const uint32_t bh = transpose8x8(a.hi);
  mma_m16n8k16(c, d.hi, 0u, d.lo, 0u, bh, bh);
  if (!exact) mma_m16n8k8(c, d.hi, 0u, transpose8x8(a.lo));
  r0 = c[0];
  r1 = c[1];
}

template <typename Tio, int VB, int S>
__global__ void __launch_bounds__(kMaxThreads, 2)
stiffness_split_kernel(const __grid_constant__ Operands<Tio> ops,
                       const __grid_constant__ DTable8 dm,
                       Tio* __restrict__ out, int mz, int my, int mx,
                       int tx_shift, int ntx, int nty, int nsuper) {
  constexpr bool kExactU = std::is_same<Tio, __nv_bfloat16>::value;
  constexpr int V = VB / static_cast<int>(sizeof(Tio));   // points a vector
  constexpr int CPR = kT / V;                              // vectors a tile row
  static_assert(V >= 2 && kT % V == 0, "a vector holds 2, 4 or 8 points");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Tio* const smem = reinterpret_cast<Tio*>(smem_raw);

  const int tx = 1 << tx_shift;              // tiles a block = warps
  const int lat_pts = tx * kTilePts;         // one lattice of a stage
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int own = g * kT + t2;               // the lane's pair in a plane

  auto slot = [&](int buf, int l) { return smem + (buf * kLattices + l) * lat_pts; };

  // This thread's vectors of a super-tile's lattice, in the order vector,
  // y, tile, z: a warp's 32 vectors are whole rows of the super-tile in
  // device memory and one contiguous run of a tile in shared memory
  // (tile-major). The block's 32 * tx threads cover 4 / CPR planes, so the
  // thread's kTrips vectors differ in z only, by kDz planes each: their
  // offsets are fixed for the kernel.
  constexpr int kTrips = 16 / V;
  constexpr int kDz = 4 / CPR;
  const int vq = threadIdx.x % CPR, vrest = threadIdx.x / CPR;
  const int vy = vrest & (kT - 1), vxt = (vrest >> 3) & (tx - 1);
  const int vz = vrest >> (tx_shift + 3);
  const int vx = vxt * kT + vq * V;
  const int soff0 = ((vxt * kT + vz) * kT + vy) * kT + vq * V;
  const int64_t plane = static_cast<int64_t>(my) * mx;
  const int64_t goff0 = vz * plane + static_cast<int64_t>(vy) * mx + vx;

  // first point (x, y, z) of super-tile L, its offset in the lattice, and
  // whether this thread's vectors lie inside it in x and y
  auto origin = [&](int L, int& z0, int64_t& base) -> bool {
    const int r = L / ntx;
    const int x0 = (L - r * ntx) << (tx_shift + 3);
    const int y0 = (r % nty) * kT;
    z0 = (r / nty) * kT;
    base = z0 * plane + static_cast<int64_t>(y0) * mx + x0 + goff0;
    return x0 + vx < mx && y0 + vy < my;
  };

  auto issue = [&](int L, int buf) {
    if (L < nsuper) {
      int z0;
      int64_t base;
      const bool in_xy = origin(L, z0, base);
#pragma unroll
      for (int t = 0; t < kTrips; ++t) {
        const bool ok = in_xy && z0 + vz + t * kDz < mz;
        const int64_t goff = base + t * kDz * plane;
        const int soff = soff0 + t * kDz * kT * kT;
#pragma unroll
        for (int l = 0; l < kLattices; ++l)
          cp_async<VB>(slot(buf, l) + soff, ok ? ops.p[l] + goff : ops.p[l], ok);
      }
    }
    cp_async_commit();   // an empty group keeps the count uniform
  };

  const int step = gridDim.x;
  int L = blockIdx.x;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue(L + s * step, s);

  // the lane's pairs of D (rows of D: B of x, A of y) and of D^T, split
  // once, while the first loads are in flight
  const Split dd = split2(dm.d[g * kT + t2], dm.d[g * kT + t2 + 1]);
  const Split dt = split2(dm.d[t2 * kT + g], dm.d[(t2 + 1) * kT + g]);

  for (int it = 0; L < nsuper; ++it, L += step) {
    cp_async_wait<S - 2>();   // this super-tile's group has landed
    __syncthreads();          // for every thread; the buffer refilled next
                              // was stored from before this barrier
    issue(L + (S - 1) * step, (it + S - 1) % S);
    const int buf = it % S;
    const Tio* tu = slot(buf, 0) + warp * kTilePts;

    // u: the lane's pairs as A / B operands (hi, lo) and, for the z-chain,
    // as f32; an exact bf16 pair is its own hi and has no lo
    Split us[kT];
    float dz[kT][2];
    {
      float uf[kT][2];
#pragma unroll
      for (int k = 0; k < kT; ++k) {
        if constexpr (kExactU) {
          const uint32_t raw =
              *reinterpret_cast<const uint32_t*>(tu + k * kT * kT + own);
          us[k].hi = raw;
          us[k].lo = 0u;
          uf[k][0] = __uint_as_float(raw << 16);
          uf[k][1] = __uint_as_float(raw & 0xffff0000u);
        } else {
          load_pair(tu + k * kT * kT + own, uf[k][0], uf[k][1]);
          us[k] = split2(uf[k][0], uf[k][1]);
        }
      }
      // z: dz[k] = sum_m D[k][m] u[m], f32 FMAs in registers
#pragma unroll
      for (int k = 0; k < kT; ++k) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float s = 0.f;
#pragma unroll
          for (int m = 0; m < kT; ++m) s += dm.d[k * kT + m] * uf[m][q];
          dz[k][q] = s;
        }
      }
    }

    float az[kT][2], xy[kT][2];
#pragma unroll
    for (int k = 0; k < kT; ++k) az[k][0] = az[k][1] = 0.f;

#pragma unroll
    for (int p = 0; p < kT / 2; ++p) {
      float c[4];
      contract_x(us[2 * p], us[2 * p + 1], dd, kExactU, c);   // Dr of planes 2p, 2p + 1
      float wr[2][2], ws[2][2];
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        const int k = 2 * p + pp;
        float ds[2];
        contract_y(us[k], dd, kExactU, ds[0], ds[1]);
        float G[6][2];
#pragma unroll
        for (int l = 0; l < 6; ++l)
          load_pair(slot(buf, 1 + l) + warp * kTilePts + k * kT * kT + own,
                    G[l][0], G[l][1]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float dr = c[2 * pp + q], dzq = dz[k][q];
          wr[pp][q] = G[0][q] * dr + G[3][q] * ds[q] + G[4][q] * dzq;
          ws[pp][q] = G[3][q] * dr + G[1][q] * ds[q] + G[5][q] * dzq;
          const float wt = G[4][q] * dr + G[5][q] * ds[q] + G[2][q] * dzq;
          // z: Au[m] += D[k][m] * Wt[k]
#pragma unroll
          for (int m = 0; m < kT; ++m) az[m][q] += dm.d[k * kT + m] * wt;
        }
      }
      // the transposed contractions; the W intermediates are f32: bf16x3
      const Split wa[2] = {split2(wr[0][0], wr[0][1]), split2(wr[1][0], wr[1][1])};
      contract_x(wa[0], wa[1], dt, false, c);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        float as[2];
        contract_y(split2(ws[pp][0], ws[pp][1]), dt, false, as[0], as[1]);
        xy[2 * p + pp][0] = c[2 * pp] + as[0];
        xy[2 * p + pp][1] = c[2 * pp + 1] + as[1];
      }
    }

    // Au into the tile's u slot (read by this warp only, above), then whole
    // rows of the super-tile to device memory
    __syncwarp();
    Tio* to = slot(buf, 0) + warp * kTilePts;
#pragma unroll
    for (int k = 0; k < kT; ++k)
      store_pair(to + k * kT * kT + own, xy[k][0] + az[k][0], xy[k][1] + az[k][1]);
    __syncthreads();
    using Vec = typename VecOf<VB>::type;
    int z0;
    int64_t base;
    const bool in_xy = origin(L, z0, base);
#pragma unroll
    for (int t = 0; t < kTrips; ++t) {
      if (in_xy && z0 + vz + t * kDz < mz)
        *reinterpret_cast<Vec*>(out + base + t * kDz * plane) =
            *reinterpret_cast<const Vec*>(slot(buf, 0) + soff0 + t * kDz * kT * kT);
    }
  }
  cp_async_wait<0>();
}

// The dynamic shared memory of a block of tx warps, with the kernel's limit
// raised to it where it is above the 48 KB a block gets without asking.
template <typename Tio, int VB, int S>
cudaError_t shared_bytes(int tx, int& smem) {
  smem = S * kLattices * tx * kTilePts * static_cast<int>(sizeof(Tio));
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(stiffness_split_kernel<Tio, VB, S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename Tio, int VB, int S>
cudaError_t launch_vs(const Operands<Tio>& ops, const DTable8& dm, Tio* out,
                      int64_t mz, int64_t my, int64_t mx, int tx, int blocks,
                      cudaStream_t stream) {
  int smem;
  const cudaError_t e = shared_bytes<Tio, VB, S>(tx, smem);
  if (e != cudaSuccess) return e;
  const int tx_shift = __builtin_ctz(static_cast<unsigned>(tx));
  const int64_t ntx = (mx + tx * kT - 1) / (tx * kT), nty = (my + kT - 1) / kT,
                ntz = (mz + kT - 1) / kT;
  stiffness_split_kernel<Tio, VB, S><<<static_cast<unsigned>(blocks), 32 * tx, smem, stream>>>(
      ops, dm, out, static_cast<int>(mz), static_cast<int>(my),
      static_cast<int>(mx), tx_shift, static_cast<int>(ntx),
      static_cast<int>(nty), static_cast<int>(ntx * nty * ntz));
  return cudaGetLastError();
}

// Blocks of this launch that one SM holds at once (0 when none fits).
template <typename Tio, int VB, int S>
cudaError_t occupancy_vs(int tx, int* per_sm) {
  int smem;
  const cudaError_t e = shared_bytes<Tio, VB, S>(tx, smem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, stiffness_split_kernel<Tio, VB, S>, 32 * tx, smem);
}

template <typename Tio>
cudaError_t launch_t(const void* const* p, const DTable8& dm, void* out,
                     int64_t mz, int64_t my, int64_t mx, int vec_bytes, int tx,
                     int stages, int blocks, cudaStream_t stream, int* per_sm) {
  Operands<Tio> ops;
  for (int l = 0; l < kLattices; ++l) ops.p[l] = static_cast<const Tio*>(p[l]);
  Tio* o = static_cast<Tio*>(out);
  const int key = vec_bytes * 10 + stages;
#define PRFDD_SPLIT_VS(VB, S)                                                \
  case VB * 10 + S:                                                          \
    if constexpr (VB >= 2 * static_cast<int>(sizeof(Tio))) {                 \
      if (per_sm) return occupancy_vs<Tio, VB, S>(tx, per_sm);               \
      return launch_vs<Tio, VB, S>(ops, dm, o, mz, my, mx, tx, blocks, stream); \
    }                                                                        \
    break;
  switch (key) {
    PRFDD_SPLIT_VS(4, 2)
    PRFDD_SPLIT_VS(4, 3)
    PRFDD_SPLIT_VS(8, 2)
    PRFDD_SPLIT_VS(8, 3)
    PRFDD_SPLIT_VS(16, 2)
    PRFDD_SPLIT_VS(16, 3)
    default: break;
  }
#undef PRFDD_SPLIT_VS
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace prfdd

// C interface: dtype 0 bf16 / 1 f32 (all seven lattices share it; f64 is
// refused), n = 2, 4 or 8, dmat the n x n GLL differentiation matrix in f64
// ON THE HOST (cast to f32 and laid out as kron(I_{8/n}, D_n) here, passed to
// the kernel by value). The launch plan comes from
// ops/kernels.py::_split_plan: vec_bytes (4, 8 or 16, at least a point pair)
// divides the row pitch and every pointer, tx tiles a block (1..8, a power
// of two), stages 2 or 3, blocks the 1-D grid. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for what the kernel does not take.
extern "C" int prfdd_stiffness_split_3d(int dtype, int n, const void* u,
                                        const void* g0, const void* g1,
                                        const void* g2, const void* g3,
                                        const void* g4, const void* g5,
                                        const double* dmat, void* out,
                                        long long mz, long long my,
                                        long long mx, int vec_bytes, int tx,
                                        int stages, int blocks, void* stream) {
  using namespace prfdd;
  if ((n != 2 && n != 4 && n != 8) || mz <= 0 || my <= 0 || mx <= 0 ||
      mz % n || my % n || mx % n || mx > 2147483647LL || my > 2147483647LL ||
      mz > 2147483647LL || tx < 1 || tx > kMaxThreads / 32 || (tx & (tx - 1)) ||
      blocks < 1 || dmat == nullptr)
    return cudaErrorInvalidValue;
  DTable8 dm;
  for (int a = 0; a < kT; ++a)
    for (int b = 0; b < kT; ++b)
      dm.d[a * kT + b] = (a / n == b / n)
          ? static_cast<float>(dmat[(a % n) * n + b % n]) : 0.f;
  const void* p[kLattices] = {u, g0, g1, g2, g3, g4, g5};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return launch_t<__nv_bfloat16>(p, dm, out, mz, my, mx, vec_bytes, tx, stages, blocks, st, nullptr);
    case kF32: return launch_t<float>(p, dm, out, mz, my, mx, vec_bytes, tx, stages, blocks, st, nullptr);
    default: return cudaErrorInvalidValue;
  }
}

// The blocks of a K3 launch with this dtype, vec_bytes, tx and stages that
// one SM of the current device holds at once, into *per_sm (the card's
// answer to the plan's model of its limits; studies and checks only).
extern "C" int prfdd_stiffness_split_blocks_per_sm(int dtype, int vec_bytes,
                                                   int tx, int stages,
                                                   int* per_sm) {
  using namespace prfdd;
  if (per_sm == nullptr || tx < 1 || tx > kMaxThreads / 32 || (tx & (tx - 1)))
    return cudaErrorInvalidValue;
  const void* p[kLattices] = {};
  DTable8 dm = {};
  switch (dtype) {
    case kBF16: return launch_t<__nv_bfloat16>(p, dm, nullptr, 0, 0, 0, vec_bytes, tx, stages, 1, nullptr, per_sm);
    case kF32: return launch_t<float>(p, dm, nullptr, 0, 0, 0, vec_bytes, tx, stages, 1, nullptr, per_sm);
    default: return cudaErrorInvalidValue;
  }
}

// K2: one-pass structured face summation (direct stiffness summation on
// one shard) on a (Mz, My, Mx) point lattice, or on a batch of them: the
// (B, Mz, My, Mx) stack of P slab shards, one lattice per shard.
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
// weight, 7.5 us) and 50.3 MB in f64 (15.0 us). Useful arithmetic is at
// most 6 adds and 2 multiplies a point, so what a kernel can lose its time
// on is the number of load instructions, repeated partial sums, and, on
// the small lattices of the coarse p-multigrid levels, its latency chain.
//
// Design: separable, wide, and without a barrier.
// - A thread owns a vector of V x-contiguous points (16 bytes where the
//   pointers and the row pitch allow: 8 bf16, 4 f32, 2 f64; the wrapper
//   passes the widest V that fits, down to 1), loaded and stored with one
//   instruction; mask and weight vectors cover the same V points in their
//   own type.
// - The sum is taken axis by axis. The x-sum of a row needs the thread's
//   own vector (neighbours inside it are registers) and at most the two
//   points across its ends, single loads that hit the line a neighbouring
//   thread fetched. The y-sum needs the x-sums of the rows above and
//   below only where the row's hi / lo flag is set, the z-sum the xy-sums
//   of the neighbouring planes only where the plane's flag is set. Flags
//   are uniform along x, so whole rows branch together, and at n = 8 a
//   thread x-sums (1 + 2/8)^2 = 1.56 rows on average instead of 9.
// - Every load a thread needs (up to 3 x 3 rows, mask, weight) is started
//   before the first sum, so one memory latency covers them all; rows
//   shared with neighbouring threads come from L1 / L2.
// - hi/lo come from one `%` per thread and axis over V points.
// - Neighbouring rows are re-read through the cache and not staged in
//   shared memory: a block that stages the x-sums of a row tile and its
//   halo does the same 1.56 x-sums a point, adds a shared-memory round
//   trip and a barrier, and measured no faster at 128^3 and 0.5-1.5 us
//   slower on the small lattices (PERF.md, "staged against direct").
// - Block (chosen in ops/kernels.py::_face_sum_plan): tx vectors along x
//   (a whole row up to 128 of them) times `by` consecutive rows of one
//   plane, about 128 threads, so neighbouring rows share a block's L1.
//   On a lattice too small to give the card 65,536 threads the plan
//   narrows the vector: there the time is one thread's chain of loads
//   and sums, not the number of instructions.
//
// Batch: the B lattices are one launch over B * Mz planes. A plane's z
// flags come from its index inside its own lattice (z % Mz), so no sum
// crosses from one lattice into the next: each entry's result equals a
// launch on that lattice alone, value for value. The shards' slab
// boundaries are summed afterwards by the exchange
// (runtime/comm.LocalComm.slab_exchange_add).
//
// Contract: the reference's association, x first, (U + hi*U[x+1]) +
// lo*U[x-1], then y, then z, every add and multiply rounded on its own
// (no FMA), f32 compute (f64 for f64), weight before mask, one cast. A
// term whose flag is 0 is skipped instead of multiplied by 0 and a set
// flag adds the neighbour without the multiply by 1, so for finite inputs
// every value equals the plain twin's; the sign of a zero may differ, and
// non-finite inputs (0 * inf) are outside the contract. A wrapped
// neighbour (X = 0, X = M - 1) always has flag 0 and is never read.

#include "common.cuh"

namespace prfdd {
namespace {

constexpr int kMaxThreads = 256;   // the register budget of a block is set for it

// V values of T that move as one access of up to 16 bytes (wider ones as
// several 16-byte accesses).
template <typename T, int V>
struct alignas((V * sizeof(T) < 16) ? V * sizeof(T) : 16) Vec {
  T v[V];
};

enum : unsigned { kHi = 1u, kLo = 2u };

// flags of lattice index X (0 <= X < M) along one axis
__device__ __forceinline__ unsigned row_flags(int X, int M, int n) {
  const int r = X % n;
  return ((r == n - 1 && X != M - 1) ? kHi : 0u) |
         ((r == 0 && X != 0) ? kLo : 0u);
}

template <typename AV, int V>
__device__ __forceinline__ void add_to(AV& r, const AV& p) {
#pragma unroll
  for (int q = 0; q < V; ++q) r.v[q] = add_rn(r.v[q], p.v[q]);
}

template <typename Tio, typename Tmw, int V>
__global__ void __launch_bounds__(kMaxThreads) face_sum_kernel(const Tio* __restrict__ u,
                                const Tmw* __restrict__ mask,
                                const Tmw* __restrict__ weight,
                                Tio* __restrict__ out, int mz, int my, int mx,
                                int n) {
  // mz: planes of one lattice; the grid's z runs over the whole batch
  using Acc = typename AccOf<Tio>::type;
  using AV = Vec<Acc, V>;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;   // plane of the batch
  if (x0 >= mx || y >= my) return;
  // this thread's V points along x: which add their right / left neighbour
  unsigned hi_bits = 0u, lo_bits = 0u;
  {
    int rem = x0 % n;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      const int x = x0 + p;
      if (rem == n - 1 && x != mx - 1) hi_bits |= 1u << p;
      if (rem == 0 && x != 0) lo_bits |= 1u << p;
      rem = (rem + 1 == n) ? 0 : rem + 1;
    }
  }
  const bool need_left = lo_bits & 1u, need_right = (hi_bits >> (V - 1)) & 1u;
  const unsigned f_y = row_flags(y, my, n), f_z = row_flags(z % mz, mz, n);
  const int64_t idx = (static_cast<int64_t>(z) * my + y) * mx + x0;

  // every load first. Row [a][b] is the row at z + dz(a), y + dy(b) with
  // d(0) = 0, d(1) = +1 (read under hi), d(2) = -1 (read under lo): a set
  // flag says the neighbour exists, so no read leaves the lattice.
  Vec<Tmw, V> wv, mv;
  if (weight != nullptr) wv = *reinterpret_cast<const Vec<Tmw, V>*>(weight + idx);
  if (mask != nullptr) mv = *reinterpret_cast<const Vec<Tmw, V>*>(mask + idx);
  Vec<Tio, V> raw[3][3];
  Tio lft[3][3], rgt[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const bool zn = (a == 0) || (f_z & (a == 1 ? kHi : kLo));
    const int dz = (a == 0) ? 0 : (a == 1) ? 1 : -1;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const bool yn = (b == 0) || (f_y & (b == 1 ? kHi : kLo));
      const int dy = (b == 0) ? 0 : (b == 1) ? 1 : -1;
      if (zn && yn) {
        const Tio* __restrict__ row =
            u + (static_cast<int64_t>(z + dz) * my + (y + dy)) * mx;
        raw[a][b] = *reinterpret_cast<const Vec<Tio, V>*>(row + x0);
        if (need_left) lft[a][b] = row[x0 - 1];
        if (need_right) rgt[a][b] = row[x0 + V];
      }
    }
  }

  // x-sum of row [a][b]: (U + hi*U[x+1]) + lo*U[x-1]
  auto xsum = [&](int a, int b) -> AV {
    Acc c[V];
#pragma unroll
    for (int p = 0; p < V; ++p) c[p] = to_acc<Acc>(raw[a][b].v[p]);
    const Acc left = need_left ? to_acc<Acc>(lft[a][b]) : Acc(0);
    const Acc right = need_right ? to_acc<Acc>(rgt[a][b]) : Acc(0);
    AV s;
#pragma unroll
    for (int p = 0; p < V; ++p) {
      Acc v = c[p];
      if ((hi_bits >> p) & 1u) v = add_rn(v, (p + 1 < V) ? c[(p + 1) % V] : right);
      if ((lo_bits >> p) & 1u) v = add_rn(v, (p > 0) ? c[(p + V - 1) % V] : left);
      s.v[p] = v;
    }
    return s;
  };
  // xy-sum of plane [a]
  auto ysum = [&](int a) -> AV {
    AV r = xsum(a, 0);
    if (f_y & kHi) add_to<AV, V>(r, xsum(a, 1));
    if (f_y & kLo) add_to<AV, V>(r, xsum(a, 2));
    return r;
  };
  AV acc = ysum(0);
  if (f_z & kHi) add_to<AV, V>(acc, ysum(1));
  if (f_z & kLo) add_to<AV, V>(acc, ysum(2));
  if (weight != nullptr) {
#pragma unroll
    for (int q = 0; q < V; ++q) acc.v[q] = mul_rn(acc.v[q], to_acc<Acc>(wv.v[q]));
  }
  if (mask != nullptr) {
#pragma unroll
    for (int q = 0; q < V; ++q) acc.v[q] = mul_rn(acc.v[q], to_acc<Acc>(mv.v[q]));
  }
  Vec<Tio, V> o;
#pragma unroll
  for (int q = 0; q < V; ++q) store_io(&o.v[q], acc.v[q]);
  *reinterpret_cast<Vec<Tio, V>*>(out + idx) = o;
}

struct Plan {
  int vec, tx, by;  // points per thread; threads along x; rows per block
};

template <typename Tio, typename Tmw, int V>
cudaError_t launch_v(const void* u, const void* mask, const void* weight,
                     void* out, int64_t batch, int64_t mz, int64_t my,
                     int64_t mx, int n, const Plan& p, cudaStream_t stream) {
  const int64_t chunk = static_cast<int64_t>(p.tx) * V;
  const int64_t gx = (mx + chunk - 1) / chunk, gy = (my + p.by - 1) / p.by;
  const int64_t gz = batch * mz;
  if (mx % V != 0 || gy > 65535 || gz > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy),
            static_cast<unsigned>(gz));
  dim3 block(static_cast<unsigned>(p.tx), static_cast<unsigned>(p.by));
  face_sum_kernel<Tio, Tmw, V><<<grid, block, 0, stream>>>(
      static_cast<const Tio*>(u), static_cast<const Tmw*>(mask),
      static_cast<const Tmw*>(weight), static_cast<Tio*>(out),
      static_cast<int>(mz), static_cast<int>(my), static_cast<int>(mx), n);
  return cudaGetLastError();
}

template <typename Tio, typename Tmw>
cudaError_t launch(const void* u, const void* mask, const void* weight,
                   void* out, int64_t batch, int64_t mz, int64_t my,
                   int64_t mx, int n, const Plan& p, cudaStream_t stream) {
  constexpr int kMaxVec = 16 / static_cast<int>(sizeof(Tio));
#define PRFDD_FACE_SUM_V(V)                                                   \
  if constexpr (V <= kMaxVec)                                                 \
    if (p.vec == V)                                                           \
      return launch_v<Tio, Tmw, V>(u, mask, weight, out, batch, mz, my, mx, n, p, stream);
  PRFDD_FACE_SUM_V(1)
  PRFDD_FACE_SUM_V(2)
  PRFDD_FACE_SUM_V(4)
  PRFDD_FACE_SUM_V(8)
#undef PRFDD_FACE_SUM_V
  return cudaErrorInvalidValue;
}

template <typename Tio>
cudaError_t launch_mw(int mw_dtype, const void* u, const void* mask,
                      const void* weight, void* out, int64_t batch, int64_t mz,
                      int64_t my, int64_t mx, int n, const Plan& p,
                      cudaStream_t stream) {
  switch (mw_dtype) {
    case kBF16: return launch<Tio, __nv_bfloat16>(u, mask, weight, out, batch, mz, my, mx, n, p, stream);
    case kF32: return launch<Tio, float>(u, mask, weight, out, batch, mz, my, mx, n, p, stream);
    case kF64: return launch<Tio, double>(u, mask, weight, out, batch, mz, my, mx, n, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace prfdd

// C interface: dtype / mw_dtype 0 bf16, 1 f32, 2 f64; mask and weight may
// be null (then not applied); batch lattices of mz x my x mx points each,
// stored one after the other. The launch plan comes from
// ops/kernels.py::_face_sum_plan: vec points per thread (every pointer and
// the row pitch are multiples of the vector it implies) and a block of
// tx threads along x times by rows. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the card would refuse.
extern "C" int prfdd_face_sum_3d(int dtype, int mw_dtype, int n, const void* u,
                                 const void* mask, const void* weight,
                                 void* out, long long batch, long long mz,
                                 long long my, long long mx, int vec, int tx,
                                 int by, void* stream) {
  using namespace prfdd;
  if (n < 1 || batch <= 0 || mz <= 0 || my <= 0 || mx <= 0 ||
      mx > 2147483647LL ||
      vec < 1 || tx < 1 || by < 1 ||
      static_cast<long long>(tx) * by > kMaxThreads)
    return cudaErrorInvalidValue;
  const Plan p{vec, tx, by};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kBF16: return launch_mw<__nv_bfloat16>(mw_dtype, u, mask, weight, out, batch, mz, my, mx, n, p, st);
    case kF32: return launch_mw<float>(mw_dtype, u, mask, weight, out, batch, mz, my, mx, n, p, st);
    case kF64: return launch_mw<double>(mw_dtype, u, mask, weight, out, batch, mz, my, mx, n, p, st);
    default: return cudaErrorInvalidValue;
  }
}

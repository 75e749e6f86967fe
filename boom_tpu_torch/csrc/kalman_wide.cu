// Sequential Kalman recurrences for wider states, hand-written for Hopper
// (sm_90a): several chains (or D-path series) packed into a warp, a lane a
// row of the state, the state dimension fixed at compile time.
//
// Replaces the reference's XLA time scans (not Pallas kernels) where the
// state is wider than kalman_seq.cu's one-thread-a-chain kernels take:
//   K2w `smoother_wide_kernel<D, pass>`: the fused static
//      `simulation_smoother` (boom_tpu/statespace/kalman.py:438-481,
//      lax.scan at :476) plus `_smoother_passes` (:289-350, scans at :322
//      and :349) at 7 <= d <= 16 (a local linear trend with a 7-season
//      cycle is d = 8): the unconditional simulation fused into the filter
//      on y - y+, the backward r pass and the forward state pass, one
//      launch each behind one C entry; the draw is alpha+ +
//      E_0[alpha | y - y+]. float64 (bsts.SMOOTHER_DTYPE).
//   K3 `dpath_kernel<T, D, chunk>`: the ASIS D-path recurrence of bsts.asis_redraw
//      (boom_tpu/statespace/bsts.py:1077-1084, a lax.scan): D_0 = 0,
//      D_t = T_c D_{t-1} + w_{c,g,t} for every chain c and variance group
//      g, float32 or float64, d in 1..16: every d of the ASIS pass.
// The plain PyTorch versions are boom_tpu_torch/statespace/kalman.py
// (`simulation_smoother`, `dpath`); statespace/kalman_kernel.py binds this
// file.
//
// What bounds them on this card. K2w's filter step is d x d algebra,
// 4d^3 + 8d^2 + 3d flops (2,624 at d = 8), in float64: at the bsts_reg shape
// (4096 chains, T = 500, d = 8) the operations bound it (0.196 ms at 34
// TFLOP/s), ahead of its bytes (w, eps in, the draw out: 0.09 ms; its
// [C, T, d + 1] scratch, 147 MB there, is written and read back twice on
// top). But each chain is 500 dependent steps, so what it reaches is set by
// the latency of a step and by how many steps are in flight: occupancy.
// K3 does d^2 multiply-adds a step and series; its bytes bound it (w in,
// the D-paths out: 0.39 GB in float32 at 4096 chains, 3 groups, d = 8).
//
// Design:
//   - d is a template parameter (K2w 7..16, K3 1..16); the C entries
//     dispatch on it. Every array is sized D, no loop carries a guard.
//   - A chain (K3: a series (c, g)) takes a group of W lanes, W the next
//     power of two >= D: 32 / W of them a warp (K2w: 4 at d <= 8, 2 past
//     it; K3 at d = 2: 16). Lane i of a group holds row i; lanes i >= D
//     shadow row 0 and write nothing. A group past the batch shadows the
//     last chain and writes nothing: no lane leaves early, every shuffle
//     and __syncwarp() takes the whole warp.
//   - K2w: lane i keeps row i of T and a row (pass 1: the column) of
//     R Q R' in registers; the chain's shared memory holds only P, a second
//     P-sized buffer, z and the exchange vectors. z'a, z'P z and z'alpha+
//     are segmented butterflies (xor offsets < W, a fixed order: repeated
//     launches are bit-identical, every lane of a group gets the same sum).
//     A filter step: lane i forms P z (row i), (T P) row i into buffer Y,
//     publishes P z, a, alpha+; then K_i = (T P z)_i / f, its own row of
//     L = T - K z', and column i of P' = (T P) L' + R Q R' (the plain
//     version's operations for each element: (T P)[j] . L[i] + RQR[j][i])
//     over P in buffer X; then row i of 0.5 (P' + P'^T), the diagonal
//     exact, into Y; X and Y swap. Three __syncwarp()s a step, no block
//     barrier. The loads of P, T P and the vectors take two doubles each.
//   - K2w's three passes are three launches: only the scratch passes
//     between them, so each has its own registers and shared memory (the
//     P buffers only in pass 1). __launch_bounds__(128, 4): at most 128
//     registers, no spill at any D (Wide), four blocks of 128 threads (16
//     warps, the 4096 chains of d = 13 in one wave) on an SM.
//   - The per-step streams are staged a chunk of kChunk steps ahead with
//     cp.async, double-buffered, as K2 does (kalman_seq.cu): w and eps in
//     pass 1 (a step's slot of D + 1 doubles holds w_t and eps_t, then
//     (v/f, K)), the slots in reverse chunks in pass 2 (r_{t-1} replaces
//     their first D), the slots and w in pass 3 (the draw replaces w_t).
//     A chunk's slots and draws go back as one contiguous run a chain,
//     consecutive lanes on consecutive doubles (whole 32-byte sectors).
//     kChunk is the longest of 16, 8, 6, 4, 2 steps with which four blocks
//     fit the SM's 228 KB (pass 1: 8 steps at d = 8, 6 at d = 16, 54 KB a
//     block). Passes 2 and 3 exchange their vectors through two parities
//     of buffers: one __syncwarp() a step.
//   - K3: T D_{t-1} takes D shuffles within the group a step; w
//     [C, G, T-1, d] is staged two chunks ahead through shared memory with
//     16-byte cp.async (a series' rows are contiguous; a run starts at its
//     element's phase in a 16-byte vector) and D [C, G, T, d], its zero row
//     included, leaves from a shared chunk in 16-byte stores (the ragged
//     edge of a run in single elements). A chunk is 64 bytes a lane-step
//     (2 KB a warp) where the grid fills the card (bsts_reg: 3,072 warps),
//     256 where one wave of such blocks holds it (bsts_llt's 512 warps, one
//     block an SM: a warp needs more bytes in flight); the launcher asks
//     the card's occupancy.
//   - Not the float64 tensor cores: mma.sync.m8n8k4.f64 would fit d = 8's
//     T P, but each chain is 500 dependent steps of 8 x 8 algebra, so the
//     time is set by a step's latency and by occupancy, not by the f64
//     rate; and inline PTX mma cannot run in the host rehearsal
//     (kernels/host_rehearsal.py compiles this file with g++). A DMMA
//     variant is ROADMAP's lever for a later PR to measure.
// The operation order of each value is the plain version's (the reductions
// aside), so float64 results agree with it to rounding (PERF.md, 1e-9
// normwise).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 128;           // threads a block, both kernels
constexpr int kWideMinBlocks = 4;     // K2w blocks resident on an SM
constexpr int kSmemPerSm = 233472;    // an H100 SM's shared memory, 228 KB
constexpr int kSmemPerBlock = 1024;   // reserved by the card for each block

// The block's dynamic shared memory, 16-byte aligned.
#ifndef BOOM_SHARED_BYTES
#define BOOM_SHARED_BYTES(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

// Lanes of a chain's group: the next power of two >= d.
__host__ __device__ constexpr int group_lanes(int d) {
  return d <= 1 ? 1 : d <= 2 ? 2 : d <= 4 ? 4 : d <= 8 ? 8 : 16;
}

// Sum over a group of W lanes by a fixed butterfly (xor offsets < W); every
// lane of the group gets the same bits.
template <int W, typename T>
__device__ __forceinline__ T group_sum(T v, int lane) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1)
    v = v + __shfl_sync(kFull, v, lane ^ off);
  return v;
}

// x . v of D values, left to right (the plain version's matrix-vector
// order of one row).
template <int D, typename T>
__device__ __forceinline__ T dot(const T (&x)[D], const T* v) {
  T acc = x[0] * v[0];
#pragma unroll
  for (int m = 1; m < D; ++m) acc = acc + x[m] * v[m];
  return acc;
}

__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

// 8-byte asynchronous copy global -> shared (cp.async, cached in L1).
__device__ __forceinline__ void copy8_async(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
#else
  std::memcpy(smem, gmem, 8);
#endif
}

// 16-byte asynchronous copy global -> shared of which the first `bytes`
// (1..16) are read and the rest zero-filled; both addresses 16-byte aligned.
__device__ __forceinline__ void copy16_async(void* smem, const void* gmem,
                                             int bytes) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
#else
  std::memset(smem, 0, 16);
  std::memcpy(smem, gmem, bytes);
#endif
}

__device__ __forceinline__ void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// One 16-byte store shared -> global, both 16-byte aligned.
__device__ __forceinline__ void store16(void* gmem, const void* smem) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(gmem) = *reinterpret_cast<const uint4*>(smem);
#else
  std::memcpy(gmem, smem, 16);
#endif
}

// ---- K2w -----------------------------------------------------------------

// Two doubles at a 16-byte aligned address of shared memory, one load.
struct alignas(16) Pair {
  double x, y;
};
__device__ __forceinline__ Pair ld_pair(const double* p) {
#ifdef __CUDA_ARCH__
  const double2 v = *reinterpret_cast<const double2*>(p);
  return {v.x, v.y};
#else
  return {p[0], p[1]};
#endif
}

// x . v of D values left to right, v 16-byte aligned in shared memory (two
// a load).
template <int D>
__device__ __forceinline__ double dot_pairs(const double (&x)[D],
                                            const double* v) {
  Pair q = ld_pair(v);
  double acc = x[0] * q.x;
  acc = acc + x[1] * q.y;
#pragma unroll
  for (int m = 2; m + 1 < D; m += 2) {
    q = ld_pair(v + m);
    acc = acc + x[m] * q.x;
    acc = acc + x[m + 1] * q.y;
  }
  if constexpr (D % 2 == 1) acc = acc + x[D - 1] * v[D - 1];
  return acc;
}

// a . b of D values left to right, both 16-byte aligned in shared memory.
template <int D>
__device__ __forceinline__ double dot_shared(const double* a,
                                             const double* b) {
  Pair p = ld_pair(a), q = ld_pair(b);
  double acc = p.x * q.x;
  acc = acc + p.y * q.y;
#pragma unroll
  for (int m = 2; m + 1 < D; m += 2) {
    p = ld_pair(a + m);
    q = ld_pair(b + m);
    acc = acc + p.x * q.x;
    acc = acc + p.y * q.y;
  }
  if constexpr (D % 2 == 1) acc = acc + a[D - 1] * b[D - 1];
  return acc;
}

// K2w's layout at state dimension D for pass kPass (1: the filter, 2: the
// backward r pass, 3: the forward state pass), each a launch of its own so
// that each has its own registers and shared memory. A chain's shared
// memory (doubles, every part 16-byte aligned): four exchange vectors of
// kVec (in pass 1 the fourth holds z); in pass 1 the P buffers X and Y
// (D x kLd each; kLd = 2 mod 4, so rows are pair-aligned and a group's
// own-row pair loads and column stores meet no more bank conflicts than
// their bytes force); two stage buffers of kChunk steps of kStep doubles: a
// slot of D + 1 (w_t and eps_t, then (v/f, K); in pass 2 (v/f, K), then r;
// in pass 3 r) and in pass 3 w_t (then the draw). A chain's size is 4 mod
// 8 doubles, so the broadcast loads of a warp's 2 or 4 chains fall in
// different banks. kChunk is the longest (16, 8, 6, 4 or 2 steps) with
// which kWideMinBlocks blocks fit an SM.
template <int D, int kPass>
struct Wide {
  static constexpr int kW = group_lanes(D);
  static constexpr int kPerWarp = kWarp / kW;
  static constexpr int kChainsPerBlock = kBlock / kWarp * kPerWarp;
  static constexpr int kLd = (D + 1) / 4 * 4 + 2;
  static constexpr int kVec = D + D % 2;
  static constexpr int kRec = D + 1;
  static constexpr int kP = kPass == 1 ? D * kLd : 0;
  static constexpr int kStep = kPass == 3 ? 2 * D + 1 : D + 1;
  // Registers: at most 128 (four blocks an SM), with no spill. Past d = 8
  // pass 1 reads the column of R Q R' from the cache, not from registers
  // (they hold T's row, L's row and the sums), and past d = 12 it unrolls
  // the columns of T P and P' four at a time (whole, its loads ran ahead
  // into spills of 4-20 bytes at d = 13-15).
  static constexpr bool kQInRegisters = D <= 8;
  static constexpr int kUnrollColumns = D > 12 ? 4 : D;
  static constexpr int chain_doubles(int chunk) {
    return (2 * kP + 4 * kVec + 2 * chunk * kStep + 3) / 8 * 8 + 4;
  }
  static constexpr bool fits(int chunk) {
    return kWideMinBlocks * (kChainsPerBlock * chain_doubles(chunk) * 8 +
                             kSmemPerBlock) <= kSmemPerSm;
  }
  static constexpr int kChunk = fits(16) ? 16 : fits(8) ? 8 : fits(6) ? 6
                              : fits(4) ? 4 : 2;
  static constexpr int kDoubles = chain_doubles(kChunk);
  static constexpr int kBlockBytes = kChainsPerBlock * kDoubles * 8;
  static_assert(D >= 2 && D <= 16 && fits(kChunk), "K2w's layout");
};

// K2w, pass kPass: a group of W lanes a chain, lane i < D a row; operands
// as K2's (kalman_seq.cu): w [C, T-1, D] = R chol(Q) eta, eps [C, T] =
// sqrt(h) eps_z, alpha1 [C, D]; scratch [C, T, D+1]: pass 1 writes
// (v/f, K) of step t at slot t, pass 2 overwrites its first D with
// r_{t-1}, pass 3 reads them and writes the draw.
template <int D, int kPass>
__global__ void __launch_bounds__(kBlock, kWideMinBlocks)
    smoother_wide_kernel(const double* __restrict__ z,
                         const double* __restrict__ tm,
                         const double* __restrict__ rqr,
                         const double* __restrict__ h,
                         const double* __restrict__ p0,
                         const double* __restrict__ alpha1,
                         const double* __restrict__ w,
                         const double* __restrict__ eps,
                         const double* __restrict__ y,
                         const unsigned char* __restrict__ obs,
                         double* __restrict__ scratch,
                         double* __restrict__ out, int batch, int t_len) {
  using S = Wide<D, kPass>;
  constexpr int W = S::kW, kLd = S::kLd, kVec = S::kVec, kRec = S::kRec;
  constexpr int kChunk = S::kChunk;
  BOOM_SHARED_BYTES(smem_raw);
  const int lane = threadIdx.x % kWarp;
  const int il = lane % W;  // the row of this lane
  const bool act = il < D;
  const int i = act ? il : 0;  // idle lanes shadow row 0, write nothing
  const int cb = threadIdx.x / kWarp * S::kPerWarp + lane / W;
  const int c_at = blockIdx.x * (blockDim.x / kWarp * S::kPerWarp) + cb;
  const bool live = c_at < batch;  // a group past the batch writes nothing
  const int c = live ? c_at : batch - 1;
  double* ex = reinterpret_cast<double*>(smem_raw) +
               static_cast<long long>(cb) * S::kDoubles;  // [4][kVec]
  double* stage0 = ex + 4 * kVec + 2 * S::kP;
  auto stage = [&](int b) { return stage0 + b * kChunk * S::kStep; };

  // the chain's operands
  const long long cd = static_cast<long long>(c) * D;
  const double* tm_c = tm + cd * D;
  const double* q_c = rqr + cd * D;
  const double* w_c = w + static_cast<long long>(c) * (t_len - 1) * D;
  double* scr_c = scratch + static_cast<long long>(c) * t_len * kRec;
  const double zi = act ? z[cd + i] : 0.0;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  auto chunk_len = [&](int j) {
    const int left = t_len - j * kChunk;
    return left < kChunk ? left : kChunk;
  };
  auto w_len = [&](int j) {  // rows of w chunk j uses (T - 1 in all)
    const int left = t_len - 1 - j * kChunk;
    return left < 0 ? 0 : left < kChunk ? left : kChunk;
  };
  // the group copies `count` doubles of its chain from src: element g to
  // dst[g / every * pitch + g % every] (every = D, pitch = D + 1: rows of w
  // into slots; every = pitch = 1: a contiguous run)
  auto stage_run = [&](double* dst, const double* src, int count,
                       int every, int pitch) {
    for (int g = il; g < count; g += W)
      copy8_async(dst + g / every * pitch + g % every, src + g);
  };
  auto store_run = [&](double* dst, const double* src, int count) {
    if (live)
      for (int g = il; g < count; g += W) dst[g] = src[g];
  };

  if constexpr (kPass == 1) {
    // 1. forward: simulate alpha+ and filter y - y+ (kalman.py:460-473); a
    // step's slot holds w_t [D] and eps_t, then (v/f, K)
    double* px = stage0 - 2 * S::kP;  // P
    double* py = px + S::kP;          // T P, then the next P
    double* zv = ex + 3 * kVec;       // z (ex: P z, a, alpha+)
    const double* eps_c = eps + static_cast<long long>(c) * t_len;
    double trow[D], qv[S::kQInRegisters ? D : 1];
#pragma unroll
    for (int j = 0; j < D; ++j) trow[j] = tm_c[i * D + j];
    if constexpr (S::kQInRegisters) {
#pragma unroll
      for (int j = 0; j < D; ++j) qv[j] = q_c[j * D + i];  // column i
    }
    for (int e = il; e < D * D; e += W) {
      const int r = e / D;
      px[r * kLd + (e - r * D)] = p0[cd * D + e];
    }
    if (act) zv[i] = zi;
    const double hh = h[c];
    auto stage1 = [&](int j, int b) {
      const int t0 = j * kChunk;
      stage_run(stage(b), w_c + t0 * D, w_len(j) * D, D, kRec);
      stage_run(stage(b) + D, eps_c + t0, chunk_len(j), 1, kRec);
    };
    double a_i = 0.0;  // the filter on y - y+ starts from a0 = 0
    double sim_i = alpha1[cd + i];
    double y_n = y[0];
    bool o_n = obs == nullptr || obs[0] != 0;
    __syncwarp();
    stage1(0, 0);
    async_commit();
    for (int j = 0; j < n_chunks; ++j) {
      const int b = j & 1, t0 = j * kChunk, n = chunk_len(j);
      if (j + 1 < n_chunks) stage1(j + 1, b ^ 1);
      async_commit();
      async_wait<1>();
      __syncwarp();
      for (int s = 0; s < n; ++s) {
        const int t = t0 + s;
        double* slot = stage(b) + s * kRec;
        const double yt = y_n;
        const bool ob = o_n;
        if (t + 1 < t_len) {
          y_n = y[t + 1];
          o_n = obs == nullptr || obs[t + 1] != 0;
        }
        const double wt = slot[i];  // w_t[i] (none at t = T - 1)
        const double et = slot[D];
        const double pz = dot_shared<D>(px + i * kLd, zv);  // P z, row i
        const double zs = group_sum<W>(zi * sim_i, lane);
        const double za = group_sum<W>(zi * a_i, lane);
        const double f = group_sum<W>(zi * pz, lane) + hh;
        const double v = ob ? (yt - (zs + et)) - za : 0.0;
        const double rf = reciprocal(f);
        // (T P) row i into Y, two columns at a time
#pragma unroll(S::kUnrollColumns)
        for (int jj = 0; jj < D - 1; jj += 2) {
          Pair q = ld_pair(px + jj);
          double acc0 = trow[0] * q.x, acc1 = trow[0] * q.y;
#pragma unroll
          for (int m = 1; m < D; ++m) {
            q = ld_pair(px + m * kLd + jj);
            acc0 = acc0 + trow[m] * q.x;
            acc1 = acc1 + trow[m] * q.y;
          }
          if (act) {
            py[i * kLd + jj] = acc0;
            py[i * kLd + jj + 1] = acc1;
          }
        }
        if constexpr (D % 2 == 1) {
          double acc = trow[0] * px[D - 1];
#pragma unroll
          for (int m = 1; m < D; ++m)
            acc = acc + trow[m] * px[m * kLd + D - 1];
          if (act) py[i * kLd + D - 1] = acc;
        }
        if (act) {
          ex[i] = pz;
          ex[kVec + i] = a_i;
          ex[2 * kVec + i] = sim_i;
        }
        __syncwarp();  // P z, a, alpha+ and T P are whole; P is read
        const double tpz = dot_pairs<D>(trow, ex);
        const double ta = dot_pairs<D>(trow, ex + kVec);
        const double ts = dot_pairs<D>(trow, ex + 2 * kVec);
        const double k = ob ? tpz * rf : 0.0;
        // column i of P' = (T P) L' + R Q R', L row i = T row i - K_i z'
        double lrow[D];
#pragma unroll
        for (int m = 0; m < D; ++m) lrow[m] = trow[m] - k * zv[m];
#pragma unroll(S::kUnrollColumns)
        for (int jj = 0; jj < D; ++jj) {
          double q;
          if constexpr (S::kQInRegisters)
            q = qv[jj];
          else
            q = q_c[jj * D + i];
          const double pn = dot_pairs<D>(lrow, py + jj * kLd) + q;
          if (act) px[jj * kLd + i] = pn;
        }
        if (act) slot[1 + i] = k;  // lane i + 1 read w_t[i + 1] there
        if (il == 0) slot[0] = v * rf;
        a_i = ta + k * v;
        if (t < t_len - 1) sim_i = ts + wt;
        __syncwarp();  // P' is whole in X
        // 0.5 (P' + P'^T), the diagonal P'_ii exactly, row i into Y
        if (act) {
#pragma unroll
          for (int jj = 0; jj < D; ++jj)
            py[i * kLd + jj] =
                jj == i ? px[i * kLd + i]
                        : 0.5 * (px[i * kLd + jj] + px[jj * kLd + i]);
        }
        __syncwarp();  // P is whole in Y
        double* swap = px;
        px = py;
        py = swap;
      }
      store_run(scr_c + t0 * kRec, stage(b), n * kRec);
      __syncwarp();  // the group is done with buffer b before it is refilled
    }
  } else if constexpr (kPass == 2) {
    // 2. backward: r_{t-1} = where(obs, z v/f, 0) + L' r_t
    // (kalman.py:315-323), chunks in reverse; r_{t-1} replaces the first D
    // of slot t. Lane i holds column i of T.
    double tcol[D];
#pragma unroll
    for (int m = 0; m < D; ++m) tcol[m] = tm_c[m * D + i];
    auto stage2 = [&](int j, int b) {
      stage_run(stage(b), scr_c + j * kChunk * kRec, chunk_len(j) * kRec, 1,
                1);
    };
    double r_i = 0.0;
    stage2(n_chunks - 1, 0);
    async_commit();
    bool o_n = obs == nullptr || obs[t_len - 1] != 0;
    for (int jj = 0; jj < n_chunks; ++jj) {
      const int j = n_chunks - 1 - jj, b = jj & 1;
      const int t0 = j * kChunk, n = chunk_len(j);
      if (j > 0) stage2(j - 1, b ^ 1);
      async_commit();
      async_wait<1>();
      __syncwarp();
      for (int s = n - 1; s >= 0; --s) {
        const int t = t0 + s;
        double* slot = stage(b) + s * kRec;
        const bool ob = o_n;
        if (t > 0) o_n = obs == nullptr || obs[t - 1] != 0;
        const double vf = slot[0];
        double* xk = ex + (t & 1) * 2 * kVec;  // K, then r
        if (act) {
          xk[i] = slot[1 + i];
          xk[kVec + i] = r_i;
        }
        __syncwarp();  // the other parity's readers are two steps behind
        // sum_m L[m][i] r_m, L[m][i] = T[m][i] - K_m z_i
        Pair kk = ld_pair(xk), rr = ld_pair(xk + kVec);
        double lr = (tcol[0] - kk.x * zi) * rr.x;
        lr = lr + (tcol[1] - kk.y * zi) * rr.y;
#pragma unroll
        for (int m = 2; m + 1 < D; m += 2) {
          kk = ld_pair(xk + m);
          rr = ld_pair(xk + kVec + m);
          lr = lr + (tcol[m] - kk.x * zi) * rr.x;
          lr = lr + (tcol[m + 1] - kk.y * zi) * rr.y;
        }
        if constexpr (D % 2 == 1)
          lr = lr + (tcol[D - 1] - xk[D - 1] * zi) * xk[kVec + D - 1];
        r_i = (ob ? zi * vf : 0.0) + lr;
        if (act) slot[i] = r_i;  // lane i - 1 read K_{i-1} there
      }
      __syncwarp();
      store_run(scr_c + t0 * kRec, stage(b), n * kRec);
      __syncwarp();
    }
  } else {
    // 3. forward state: alpha_1 = P0 r_0, alpha_{t+1} = T alpha_t + RQR r_t
    // (kalman.py:325, :345-350), added to alpha+ regenerated from alpha_1
    // and w as pass 1 made it (:481); a chunk holds the slots (r in their
    // first D), then w [D] a step at kChunk * kRec, which the draw replaces
    double* out_c = out + static_cast<long long>(c) * t_len * D;
    double trow[D], qrow[D];
#pragma unroll
    for (int m = 0; m < D; ++m) {
      trow[m] = tm_c[i * D + m];
      qrow[m] = q_c[i * D + m];  // row i of R Q R'
    }
    auto stage3 = [&](int j, int b) {
      const int t0 = j * kChunk;
      stage_run(stage(b), scr_c + t0 * kRec, chunk_len(j) * kRec, 1, 1);
      stage_run(stage(b) + kChunk * kRec, w_c + t0 * D, w_len(j) * D, 1, 1);
    };
    double sim_i = alpha1[cd + i];
    double ah = 0.0;
    stage3(0, 0);
    async_commit();
    for (int j = 0; j < n_chunks; ++j) {
      const int b = j & 1, t0 = j * kChunk, n = chunk_len(j);
      if (j + 1 < n_chunks) stage3(j + 1, b ^ 1);
      async_commit();
      async_wait<1>();
      __syncwarp();
      for (int s = 0; s < n; ++s) {
        const int t = t0 + s;
        const double* rs = stage(b) + s * kRec;
        double* ws = stage(b) + kChunk * kRec + s * D;
        double* xa = ex + (t & 1) * 2 * kVec;  // alpha-hat_{t-1}, alpha+_t
        if (act) {
          xa[i] = ah;
          xa[kVec + i] = sim_i;
        }
        __syncwarp();  // the other parity's readers are two steps behind
        if (t == 0) {
          const double* p0_c = p0 + cd * D;
          ah = p0_c[i * D] * rs[0];
#pragma unroll
          for (int m = 1; m < D; ++m) ah = ah + p0_c[i * D + m] * rs[m];
        } else {
          const double ta = dot_pairs<D>(trow, xa);
          const double qr = dot<D>(qrow, rs);
          ah = ta + qr;
        }
        const double draw = sim_i + ah;
        if (t < t_len - 1) sim_i = dot_pairs<D>(trow, xa + kVec) + ws[i];
        if (act) ws[i] = draw;
      }
      __syncwarp();
      store_run(out_c + t0 * D, stage(b) + kChunk * kRec, n * D);
      __syncwarp();
    }
  }
}

// ---- K3 ------------------------------------------------------------------

// K3's layout: a group of W lanes a series, kPerWarp series a warp; each
// warp stages w kChunk steps at a time kStages - 1 chunks ahead, and
// collects D a chunk at a time: kStages + 1 buffers of kPerWarp runs of
// kLen elements (a chunk's run of a series from its phase in a 16-byte
// vector). A chunk is kLaneBytes a lane: 64 (about 2 KB a warp) where the
// grid fills the card, 256 where one wave of long-chunk blocks holds the
// grid (few series: bsts_llt's 8,192 are 512 warps, one block an SM) and
// each warp needs more bytes in flight.
template <typename T, int D, int kLaneBytes>
struct Dpath {
  static constexpr int kW = group_lanes(D);
  static constexpr int kPerWarp = kWarp / kW;
  static constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  static constexpr int kChunk = kLaneBytes / static_cast<int>(sizeof(T));
  static constexpr int kStages = 3;
  // steps of a chunk unrolled: four in float32; one in float64, where
  // unrolling spilled 4-16 bytes at d = 9-16
  static constexpr int kUnrollSteps = sizeof(T) == 4 ? 4 : 1;
  static constexpr int kLen = (kChunk * D + 2 * (kVec - 1)) / kVec * kVec;
  static constexpr int kWarpElems = (kStages + 1) * kPerWarp * kLen;
  static constexpr int kBlockBytes =
      kBlock / kWarp * kWarpElems * static_cast<int>(sizeof(T));
  static_assert(kBlockBytes <= kSmemPerSm - kSmemPerBlock, "K3's layout");
};

// K3: a group of W lanes a series s = (c, g) of the flattened [C, G]; lane
// i < D holds row i of T_c and D_t[i]. w [C, G, T-1, D] -> out [C, G, T, D],
// out[:, :, 0] = 0; both 16-byte aligned; C G < 2^31.
template <typename T, int D, int kLaneBytes>
__global__ void __launch_bounds__(kBlock)
    dpath_kernel(const T* __restrict__ tm, const T* __restrict__ w,
                 T* __restrict__ out, int batch, int groups, int t_len) {
  using S = Dpath<T, D, kLaneBytes>;
  constexpr int W = S::kW, kV = S::kVec, kChunk = S::kChunk;
  constexpr int kLen = S::kLen, kNs = S::kPerWarp, kStages = S::kStages;
  BOOM_SHARED_BYTES(smem_raw);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int grp = lane / W, il = lane % W;
  const bool act = il < D;
  const int i = act ? il : 0;  // idle lanes shadow row 0, write nothing
  const int n_series = batch * groups;
  const int s0 = (blockIdx.x * (blockDim.x / kWarp) + warp) * kNs;
  auto series = [&](int g) {  // groups past the batch shadow the last
    return s0 + g < n_series ? s0 + g : n_series - 1;
  };
  const int s = series(grp);
  T* bufs = reinterpret_cast<T*>(smem_raw) + warp * S::kWarpElems;
  auto wbuf = [&](int b, int g) { return bufs + (b * kNs + g) * kLen; };
  T* obuf = bufs + kStages * kNs * kLen;
  const int c = s / groups;
  T trow[D];
#pragma unroll
  for (int j = 0; j < D; ++j)
    trow[j] = tm[(static_cast<long long>(c) * D + i) * D + j];
  const long long w_step = static_cast<long long>(t_len - 1) * D;
  const long long o_step = static_cast<long long>(t_len) * D;
  const long long w_total = n_series * w_step;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  // chunk j makes rows [j kChunk, +kChunk) of D from rows
  // [max(j kChunk - 1, 0), j kChunk + kChunk - 1) of w
  auto w_first = [&](int j) { return j == 0 ? 0 : j * kChunk - 1; };
  auto w_rows = [&](int j) {
    const int end = (j + 1) * kChunk < t_len ? (j + 1) * kChunk : t_len;
    return end - 1 - w_first(j);
  };
  // the warp's runs of chunk j into buffer b, 16 bytes a copy: the run of
  // series g at buffer (b, g) from its first element's phase
  auto stage = [&](int j, int b) {
    const int len = w_rows(j) * D;
    if (len <= 0) return;
    const int per = (len + 2 * (kV - 1)) / kV;  // vectors a run at most
    for (int k = lane; k < kNs * per; k += kWarp) {
      const int g = k / per, v = k - g * per;
      const long long e0 = series(g) * w_step +
                           static_cast<long long>(w_first(j)) * D;
      const long long at = (e0 / kV + v) * kV;
      if (at >= e0 + len) continue;
      const long long left = (w_total - at) * static_cast<long long>(sizeof(T));
      copy16_async(wbuf(b, g) + v * kV, w + at,
                   left < 16 ? static_cast<int>(left) : 16);
    }
  };
#pragma unroll
  for (int j = 0; j + 1 < kStages; ++j) {
    if (j < n_chunks) stage(j, j);
    async_commit();
  }
  T dcur = T(0);
  for (int j = 0; j < n_chunks; ++j) {
    const int t0 = j * kChunk;
    const int n = t_len - t0 < kChunk ? t_len - t0 : kChunk;
    if (j + kStages - 1 < n_chunks)
      stage(j + kStages - 1, (j + kStages - 1) % kStages);
    async_commit();
    async_wait<kStages - 1>();
    __syncwarp();
    const long long ew = s * w_step + static_cast<long long>(w_first(j)) * D;
    // w row t - 1 of step t = t0 + k at wr[k D] (chunk 0 starts at t = 1)
    const T* wr = wbuf(j % kStages, grp) + ew % kV + (j == 0 ? -D : 0) + i;
    const long long eo = s * o_step + static_cast<long long>(t0) * D;
    T* orun = obuf + grp * kLen + eo % kV + i;
#pragma unroll(S::kUnrollSteps)
    for (int k = 0; k < n; ++k) {
      if (t0 + k > 0) {
        T acc = trow[0] * __shfl_sync(kFull, dcur, grp * W);
#pragma unroll
        for (int m = 1; m < D; ++m)
          acc = acc + trow[m] * __shfl_sync(kFull, dcur, grp * W + m);
        dcur = acc + wr[k * D];
      }
      if (act) orun[k * D] = dcur;
    }
    __syncwarp();
    // the live runs [eo, eo + n D) to out: whole 16-byte vectors as such,
    // the ragged ends element by element
    const int len = n * D;
    const int per = (len + 2 * (kV - 1)) / kV;
    for (int k = lane; k < kNs * per; k += kWarp) {
      const int g = k / per, v = k - g * per;
      if (s0 + g >= n_series) continue;
      const long long e0 = (s0 + g) * o_step + static_cast<long long>(t0) * D;
      const long long at = (e0 / kV + v) * kV;
      if (at >= e0 + len) continue;
      const T* from = obuf + g * kLen + v * kV;
      if (at >= e0 && at + kV <= e0 + len) {
        store16(out + at, from);
      } else {
        for (int q = 0; q < kV; ++q)
          if (at + q >= e0 && at + q < e0 + len) out[at + q] = from[q];
      }
    }
    __syncwarp();  // obuf and buffer j are read before they are refilled
  }
}

// ---- launches ------------------------------------------------------------

// Lets `kernel` take `bytes` of dynamic shared memory and the SM give its
// most to shared memory (cudaSharedmemCarveoutMaxShared).
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
  return err;
}

bool bad_block(int threads) {
  return threads < kWarp || threads > kBlock || threads % kWarp != 0;
}

template <int D, int kPass>
cudaError_t launch_wide_pass(const void* z, const void* tm, const void* rqr,
                             const void* h, const void* p0,
                             const void* alpha1, const void* w,
                             const void* eps, const void* y, const void* obs,
                             void* scratch, void* out, int batch, int t_len,
                             int threads, cudaStream_t st) {
  using S = Wide<D, kPass>;
  auto kernel = smoother_wide_kernel<D, kPass>;
  static const cudaError_t attr = allow_shared(kernel, S::kBlockBytes);
  if (attr != cudaSuccess) return attr;
  const int chains = threads / kWarp * S::kPerWarp;
  const int blocks = (batch + chains - 1) / chains;
  kernel<<<blocks, threads, chains * S::kDoubles * 8, st>>>(
      static_cast<const double*>(z), static_cast<const double*>(tm),
      static_cast<const double*>(rqr), static_cast<const double*>(h),
      static_cast<const double*>(p0), static_cast<const double*>(alpha1),
      static_cast<const double*>(w), static_cast<const double*>(eps),
      static_cast<const double*>(y), static_cast<const unsigned char*>(obs),
      static_cast<double*>(scratch), static_cast<double*>(out), batch,
      t_len);
  return cudaGetLastError();
}

// K2w's three passes, one launch each on the stream (each reads what the
// one before it wrote).
template <int D>
int launch_smoother_wide(const void* z, const void* tm, const void* rqr,
                         const void* h, const void* p0, const void* alpha1,
                         const void* w, const void* eps, const void* y,
                         const void* obs, void* scratch, void* out,
                         int batch, int t_len, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_wide_pass<D, 1>(z, tm, rqr, h, p0, alpha1, w, eps,
                                           y, obs, scratch, out, batch,
                                           t_len, threads, st);
  if (err == cudaSuccess)
    err = launch_wide_pass<D, 2>(z, tm, rqr, h, p0, alpha1, w, eps, y, obs,
                                 scratch, out, batch, t_len, threads, st);
  if (err == cudaSuccess)
    err = launch_wide_pass<D, 3>(z, tm, rqr, h, p0, alpha1, w, eps, y, obs,
                                 scratch, out, batch, t_len, threads, st);
  return static_cast<int>(err);
}

// K3's two chunk lengths (bytes a lane-step, Dpath)
constexpr int kDpathShort = 64, kDpathLong = 256;

int card_sms() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

template <typename T, int D, int kLaneBytes>
int launch_dpath_chunks(const void* tm, const void* w, void* out, int batch,
                        int groups, int t_len, int threads, int blocks,
                        cudaStream_t st) {
  using S = Dpath<T, D, kLaneBytes>;
  const int smem = threads / kWarp * S::kWarpElems * static_cast<int>(sizeof(T));
  auto kernel = dpath_kernel<T, D, kLaneBytes>;
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const T*>(tm), static_cast<const T*>(w),
      static_cast<T*>(out), batch, groups, t_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dpath(const void* tm, const void* w, void* out, int batch,
                 int groups, int t_len, int threads, void* stream) {
  using Long = Dpath<T, D, kDpathLong>;
  const int series = threads / kWarp * Long::kPerWarp;
  const long long n_series = static_cast<long long>(batch) * groups;
  if (n_series > 0x7fffffffLL - kBlock)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((n_series + series - 1) / series);
  auto long_kernel = dpath_kernel<T, D, kDpathLong>;
  static const cudaError_t attr = allow_shared(long_kernel,
                                               Long::kBlockBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // long chunks where one wave of their blocks holds the grid
  static const int sms = card_sms();
  int per_sm = 0;
  const cudaError_t occ = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, long_kernel, threads,
      threads / kWarp * Long::kWarpElems * static_cast<int>(sizeof(T)));
  if (occ != cudaSuccess) return static_cast<int>(occ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks <= per_sm * sms)
    return launch_dpath_chunks<T, D, kDpathLong>(tm, w, out, batch, groups,
                                                 t_len, threads, blocks, st);
  return launch_dpath_chunks<T, D, kDpathShort>(tm, w, out, batch, groups,
                                                t_len, threads, blocks, st);
}

template <typename T>
int dispatch_dpath(const void* tm, const void* w, void* out, int batch,
                   int groups, int t_len, int d, int threads, void* stream) {
  if (batch < 0 || groups < 1 || t_len < 1 || bad_block(threads) ||
      reinterpret_cast<std::uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  switch (d) {
#define BOOM_DPATH_CASE(D) \
  case D:                  \
    return launch_dpath<T, D>(tm, w, out, batch, groups, t_len, threads, stream);
    BOOM_DPATH_CASE(1) BOOM_DPATH_CASE(2) BOOM_DPATH_CASE(3)
    BOOM_DPATH_CASE(4) BOOM_DPATH_CASE(5) BOOM_DPATH_CASE(6)
    BOOM_DPATH_CASE(7) BOOM_DPATH_CASE(8) BOOM_DPATH_CASE(9)
    BOOM_DPATH_CASE(10) BOOM_DPATH_CASE(11) BOOM_DPATH_CASE(12)
    BOOM_DPATH_CASE(13) BOOM_DPATH_CASE(14) BOOM_DPATH_CASE(15)
    BOOM_DPATH_CASE(16)
#undef BOOM_DPATH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entries. Every array is a contiguous device array of the entry's
// type. K2w (float64): z [B, d], tm, rqr and p0 [B, d, d], h [B], alpha1
// [B, d], w [B, T-1, d], eps [B, T], y [T], obs [T] bytes (nullptr: all
// observed), scratch [B, T, d+1], out [B, T, d]; 7 <= d <= 16. K3: tm
// [B, d, d], w [B, G, T-1, d], out [B, G, T, d], w and out 16-byte
// aligned; 1 <= d <= 16. threads: a multiple of 32 up to 128. stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int boom_kalman_smoother_wide_f64(
    const void* z, const void* tm, const void* rqr, const void* h,
    const void* p0, const void* alpha1, const void* w, const void* eps,
    const void* y, const void* obs, void* scratch, void* out, int batch,
    int t_len, int d, int threads, void* stream) {
  if (batch < 0 || t_len < 1 || bad_block(threads))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  switch (d) {
#define BOOM_WIDE_CASE(D)                                                   \
  case D:                                                                   \
    return launch_smoother_wide<D>(z, tm, rqr, h, p0, alpha1, w, eps, y,    \
                                   obs, scratch, out, batch, t_len, threads, \
                                   stream);
    BOOM_WIDE_CASE(7) BOOM_WIDE_CASE(8) BOOM_WIDE_CASE(9) BOOM_WIDE_CASE(10)
    BOOM_WIDE_CASE(11) BOOM_WIDE_CASE(12) BOOM_WIDE_CASE(13)
    BOOM_WIDE_CASE(14) BOOM_WIDE_CASE(15) BOOM_WIDE_CASE(16)
#undef BOOM_WIDE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int boom_dpath_f32(const void* tm, const void* w, void* out,
                              int batch, int groups, int t_len, int d,
                              int threads, void* stream) {
  return dispatch_dpath<float>(tm, w, out, batch, groups, t_len, d, threads,
                               stream);
}

extern "C" int boom_dpath_f64(const void* tm, const void* w, void* out,
                              int batch, int groups, int t_len, int d,
                              int threads, void* stream) {
  return dispatch_dpath<double>(tm, w, out, batch, groups, t_len, d, threads,
                                stream);
}

// Sequential Kalman recurrences for wider states, hand-written for Hopper
// (sm_90a): several chains (or D-path series) packed into a warp, a lane a
// row of the state, or (K1w in float32 to d = 13) a thread a system; the
// state dimension fixed at compile time.
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
//      E_0[alpha | y - y+]. float64 (bsts.SMOOTHER_DTYPE). Of a
//      time-varying system (z_t, h_t, R Q_t R'), the same smoother in two
//      forms: `smoother_wide_kernel<D, pass, true>` where each chain has
//      its own T, and `smoother_wide_nz_kernel<D, pass>` where every chain
//      shares one (Bsts'), its products over T's non-zeros.
//   K3 `dpath_kernel<T, D, chunk>`: the ASIS D-path recurrence of bsts.asis_redraw
//      (boom_tpu/statespace/bsts.py:1077-1084, a lax.scan): D_0 = 0,
//      D_t = T_c D_{t-1} + w_{c,g,t} for every chain c and variance group
//      g, float32 or float64, d in 1..16: every d of the ASIS pass.
//   K1w `loglik_thread_kernel<D, shared T>` (float32, 7 <= d <= 13) and
//      `wide_loglik_kernel<T, D>` (float32 at d 14-16, float64 at
//      7-16: a static choice of the dispatch, kThreadLoglikMaxD): the
//      marginal loglik (kalman.py `kalman_loglik` :229, its lax.scan at
//      :282) of every (chain, TIM point) system, on one series or on a
//      series a group of systems (bsts with a regression: each chain's
//      y - X beta), and optionally the innovations v and f
//      (`kalman_filter` :218, the one-step errors).
//   K1w's time-varying form `loglik_tv_warp_kernel<T, D>` (float32 and
//      float64, 7 <= d <= 16): the loglik (and v, f) of a time-varying
//      system (z_t, h_t, R Q_t R'), kalman.py `kalman_loglik`'s scan of
//      one (:240-282), a warp a system.
//   J1 and J2 `jet_warp_kernel<D, order>`: the same loglik with its first
//      (J1) or first and second (J2) derivatives along K <= 16 directions
//      of (h, R Q R'), forward mode (a dual / hyper-dual Tangent a unit of
//      (series, direction or pair)), d in 1..16, for the TIM proposal's
//      mode search in the variances (`jax.value_and_grad` in numopt.bfgs,
//      boom_tpu/numopt.py:43, and `jax.hessian` in newton_raphson, :101,
//      and bsts.py:661).
// The plain PyTorch versions are boom_tpu_torch/statespace/kalman.py
// (`simulation_smoother`, `dpath`, `kalman_loglik`, `loglik_jets`);
// statespace/kalman_kernel.py binds this file.
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
// K1w at bsts_reg's TIM batch (4096 chains x 17 points, T = 500, d = 8,
// float32) needs 66 GFLOP (the symmetric step, 1,905 flops): 0.99 ms at 67
// TFLOP/s. Its thread kernel is held by the FP32 pipe's issue: ~1,000
// multiply-adds a thread a step and ~150 other instructions, 16 one-warp
// blocks an SM (registers), the 2,176 warps in 1.03 waves (PERF.md). In
// the group layout it was held by the shared-memory pipe instead (~54
// loads, stores and shuffles a series-step, three __syncwarp()s a step:
// 7.2 ms).
// J1 and J2 run once a model on one series (B = 1, K = 3: 3 or 6 units),
// so the card's rates bound nothing (0.0002-0.0007 ms at d = 8): a unit's
// 500 dependent steps do, and how many instructions a step issues on the
// one warp that holds it (PERF.md; kernels/kalman_timing.py jet_floor_ms,
// the chain by assumed latencies).
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
//   - K1w in float32 to d = 13 (`loglik_thread_kernel`): a thread a
//     system, a block one warp. P is the upper triangle in the thread's
//     registers (36 floats at d = 8); a step is the measurement update on
//     P (P -= (P z)(P z)' / f) and the time update P' = T P T' + R Q R' on
//     the upper triangle alone, a row of T P at a time, P' formed in
//     shared memory and read back once a step: no butterfly, no
//     __syncwarp() in a step. T shared by every system (Bsts' T, which the
//     wrapper passes as its one row) sits in the constant bank, so each
//     multiply-add reads T as an operand; a T a system is staged once into
//     shared memory entry-major (a warp's load meets 32 banks). R Q R''s
//     upper triangle is staged once the same way, z, a and h are
//     registers. y is staged a chunk of 8 steps ahead with cp.async (the
//     warp's two or three series), v and f leave through shared memory a
//     chunk at a time as rows. Registers (nvcc -Xptxas -v, PERF.md):
//     112-128 at d 7-8, no spill (16 blocks an SM); 186-255 at d
//     9-13, where d = 12, 13 with T shared spill 4, 52 bytes (7 blocks an
//     SM at d = 13: shared memory).
//   - K1w past d = 13 and in float64 is K2w's pass 1 without alpha+ and
//     without the (v/f, K) stream (`wide_loglik_kernel`): a series takes a
//     group of W lanes, its P lives in shared memory, lane i holds row i of
//     T; y is read one step ahead from the cache, its series b /
//     per_series.
//   - J1 and J2: a unit is a (series, direction) (J1) or a (series,
//     direction pair) (J2); each unit carries the value chain with its
//     derivatives, so units never exchange data. A warp a unit
//     (`jet_warp_kernel`, a block a unit, so the 3-6 units of a proposal
//     build take an SM each): P in shared memory, the symmetric Riccati
//     step, its products as jobs over the 32 lanes in three phases, three
//     __syncwarp()s a step. y comes 32 steps ahead into registers, the
//     log of f leaves the step (a log a lane a chunk), and 1 / f comes
//     from the SFU and two Newton steps.
//   - K1w's time-varying form (`loglik_tv_warp_kernel`): phase 8 scores
//     200 draws, so a system takes a warp (a block each) in J1's layout
//     without the tangents: P in shared memory, the symmetric step, a
//     step's products as jobs over the 32 lanes in three phases, each
//     loading and computing before it stores; z_t and u_t staged a chunk
//     of 32 steps ahead by cp.async, y, the mask and h_scale a step a lane,
//     the log of f and v, f out of the step. T is read dense (a row of T's
//     non-zeros a lane, phase 8's 19 of 169, measured slower on one warp:
//     its run-time addresses and branches cost more than the terms they
//     save; PERF.md). It replaced the group kernel's time-varying path.
//   - K2w's structured time-varying form (`smoother_wide_nz_kernel`): T's
//     non-zeros are kernel parameters (NzT: a row's first one, then the
//     rest in a list), so bsts' T (phase 8's: 19 non-zeros of 169 at
//     d = 13) costs its non-zeros, not d^2 a product. The layout is K2w's
//     (a lane a row), but each product runs so that every lane does the
//     same terms: V = M T' is a lane's own row of M by the right, and
//     P' = T V is read down column i of V (by symmetry, row i of P' is
//     column i of T V), so a loop over T's rows is the same instruction
//     stream on every lane whatever the rows' lengths (the season's top
//     row of six costs each lane six terms once). P's row lives in the
//     lane's registers; M, V and P' pass through two D x kLo buffers (kLo
//     odd: a row and a column both meet D banks). The step is the
//     symmetric one, M = P - (P z)(P z)' / f before T, and the filter's
//     state and the simulation share one row b = a + alpha+ (v needs only
//     their sum). z_t and h_scale are staged once for the block
//     (__syncthreads() a chunk), so a chain's slot holds only w_t, eps_t
//     and u_t: 8 steps a chunk at d = 13 (the dense form's 4).
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

// ---- tangents (J1, J2) ------------------------------------------------------

// A scalar with its derivatives along two directions i and j: v, a = dv/di,
// b = dv/dj, c = d2v/didj (kOrder = 2, a hyper-dual number); kOrder = 1
// carries v and a alone (a dual number). 16-byte aligned, so that one
// shared-memory load takes two of its parts.
template <typename T, int kOrder>
struct alignas(16) Tangent {
  T v, a, b, c;
  __device__ Tangent() {}
  __device__ Tangent(T x)  // NOLINT: a constant promotes to a tangent
      : v(x), a(T(0)), b(T(0)), c(T(0)) {}
};
template <typename T>
struct alignas(16) Tangent<T, 1> {
  T v, a;
  __device__ Tangent() {}
  __device__ Tangent(T x) : v(x), a(T(0)) {}  // NOLINT: as above
};

// A system parameter as the filter reads it: value v and its derivatives
// sa, sb along the unit's directions i and j (it is linear in them).
template <typename T>
struct Seed {
  T v, sa, sb;
};

template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> operator+(const Tangent<T, K>& x,
                                                   const Tangent<T, K>& y) {
  Tangent<T, K> r;
  r.v = x.v + y.v;
  r.a = x.a + y.a;
  if constexpr (K == 2) {
    r.b = x.b + y.b;
    r.c = x.c + y.c;
  }
  return r;
}

template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> operator+(const Tangent<T, K>& x,
                                                   const Seed<T>& s) {
  Tangent<T, K> r;
  r.v = x.v + s.v;
  r.a = x.a + s.sa;
  if constexpr (K == 2) {
    r.b = x.b + s.sb;
    r.c = x.c;
  }
  return r;
}

template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> operator-(const Tangent<T, K>& x,
                                                   const Tangent<T, K>& y) {
  Tangent<T, K> r;
  r.v = x.v - y.v;
  r.a = x.a - y.a;
  if constexpr (K == 2) {
    r.b = x.b - y.b;
    r.c = x.c - y.c;
  }
  return r;
}

// a constant minus a tangent
template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> operator-(T s,
                                                   const Tangent<T, K>& x) {
  Tangent<T, K> r;
  r.v = s - x.v;
  r.a = -x.a;
  if constexpr (K == 2) {
    r.b = -x.b;
    r.c = -x.c;
  }
  return r;
}

// a constant times a tangent
template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> operator*(T s,
                                                   const Tangent<T, K>& x) {
  Tangent<T, K> r;
  r.v = s * x.v;
  r.a = s * x.a;
  if constexpr (K == 2) {
    r.b = s * x.b;
    r.c = s * x.c;
  }
  return r;
}

template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> operator*(const Tangent<T, K>& x,
                                                   T s) {
  return s * x;
}

template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> operator*(const Tangent<T, K>& x,
                                                   const Tangent<T, K>& y) {
  Tangent<T, K> r;
  r.v = x.v * y.v;
  r.a = x.a * y.v + x.v * y.a;
  if constexpr (K == 2) {
    r.b = x.b * y.v + x.v * y.b;
    r.c = x.c * y.v + x.a * y.b + x.b * y.a + x.v * y.c;
  }
  return r;
}

// The correctly rounded reciprocal.
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

// 1 / x to about an ulp: the SFU's approximation and two Newton steps,
// without __drcp_rn's fix-up for the correct rounding, which lengthened
// the jets' steps at small d (PERF.md). The host rehearsal takes 1 / x.
__device__ __forceinline__ double fast_reciprocal(double x) {
#ifdef __CUDA_ARCH__
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  double e = fma(-x, r, 1.0);
  r = fma(r, e, r);
  e = fma(-x, r, 1.0);
  return fma(r, e, r);
#else
  return 1.0 / x;
#endif
}

// q = 1 / f from fast_reciprocal(f.v):
// q' = -f' / f^2, q''_ij = (2 f'_i f'_j / f - f''_ij) / f^2
template <typename T, int K>
__device__ __forceinline__ Tangent<T, K> reciprocal(const Tangent<T, K>& f) {
  Tangent<T, K> q;
  q.v = fast_reciprocal(f.v);
  const T fa = f.a * q.v;
  q.a = -fa * q.v;
  if constexpr (K == 2) {
    q.b = -(f.b * q.v) * q.v;
    q.c = ((T(2) * fa) * f.b - f.c) * q.v * q.v;
  }
  return q;
}

constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)

// One step's log density -0.5 (log 2 pi + log f + v v / f), with the step's
// reciprocal rf = 1 / f in place of the division.
__device__ __forceinline__ float log_density(float v, float f, float rf) {
  return -0.5f * ((float(kLog2Pi) + logf(f)) + v * v * rf);
}
__device__ __forceinline__ double log_density(double v, double f,
                                              double rf) {
  return -0.5 * ((kLog2Pi + log(f)) + v * v * rf);
}

// The value of lane `src` of the warp.
__device__ __forceinline__ float shfl(float v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ double shfl(double v, int src) {
  return __shfl_sync(kFull, v, src);
}

// Sum over a group of W lanes by a fixed butterfly (xor offsets < W); every
// lane of the group gets the same bits.
template <int W, typename T>
__device__ __forceinline__ T group_sum(T v, int lane) {
#pragma unroll
  for (int off = W / 2; off > 0; off >>= 1) v = v + shfl(v, lane ^ off);
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

// An asynchronous copy of kBytes (4 or 8) global -> shared (cp.async,
// cached in L1).
template <int kBytes>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(kBytes)
               : "memory");
#else
  std::memcpy(smem, gmem, kBytes);
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
template <int D, int kPass, bool kTv = false>
struct Wide {
  static constexpr int kW = group_lanes(D);
  static constexpr int kPerWarp = kWarp / kW;
  static constexpr int kChainsPerBlock = kBlock / kWarp * kPerWarp;
  static constexpr int kLd = (D + 1) / 4 * 4 + 2;
  static constexpr int kVec = D + D % 2;
  static constexpr int kRec = D + 1;
  static constexpr int kP = kPass == 1 ? D * kLd : 0;
  // a time-varying system's pass 1 stages z_t at kZ (pair-aligned), u_t at
  // kU and hs[t] at kS of a step's slot; its pass 3 u_{t-1} after w
  static constexpr int kZ = (D + 2) / 2 * 2;
  static constexpr int kU = kZ + D;
  static constexpr int kS = kU + D;
  static constexpr int kStep = kPass == 1   ? (kTv ? (kS + 2) / 2 * 2 : D + 1)
                               : kPass == 3 ? (kTv ? 3 * D + 1 : 2 * D + 1)
                                            : D + 1;
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
// r_{t-1}, pass 3 reads them and writes the draw. kTv (a time-varying
// system): z_t of zt [T, D] (one for every chain) in place of z, h_t =
// h hs[t], and R Q_t R' = (u_t u_t') o R Q R' with u_t of u [., T, D] at
// u + c u_stride (R a 0/1 selection); pass 1 stages z_t, u_t and hs[t]
// into the step's slot with w_t and eps_t, pass 2 reads its lane's z_t[i]
// one step ahead, pass 3 stages u_{t-1} beside w. The time-varying form's
// T is the chain's at tm + c tm_stride (tm_stride 0: one for every chain);
// with the calendar's T_t (`sel` [T] bytes, not nullptr) two matrices lie
// there, and step t takes matrix sel[t] (the monthly cycle's rotation or
// not, the same for every chain and lane): the lane's row (pass 2: column)
// of T is reloaded from the cache where a step's choice differs from the
// one it holds, a branch the whole warp takes together, twice a month.
template <int D, int kPass, bool kTv>
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
                         double* __restrict__ out, int batch, int t_len,
                         const double* __restrict__ zt,
                         const double* __restrict__ hs,
                         const double* __restrict__ u, long long u_stride,
                         const unsigned char* __restrict__ sel,
                         long long tm_stride) {
  using S = Wide<D, kPass, kTv>;
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
  const double* tm_c = kTv ? tm + c * tm_stride : tm + cd * D;
  // the calendar's choice of step t (0 without one)
  auto choice = [&](int t) {
    return kTv && sel != nullptr ? static_cast<int>(sel[t]) : 0;
  };
  const double* q_c = rqr + cd * D;
  const double* w_c = w + static_cast<long long>(c) * (t_len - 1) * D;
  double* scr_c = scratch + static_cast<long long>(c) * t_len * kRec;
  const double* u_c = u + static_cast<long long>(c) * u_stride;
  double zi = act && !kTv ? z[cd + i] : 0.0;
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
      copy_async<8>(dst + g / every * pitch + g % every, src + g);
  };
  auto store_run = [&](double* dst, const double* src, int count) {
    if (live)
      for (int g = il; g < count; g += W) dst[g] = src[g];
  };
  // the group stores `count` doubles of its chain's slots (kRec each, a
  // step's slot kStep apart in src) as one contiguous run
  auto store_slots = [&](double* dst, const double* src, int count) {
    if constexpr (S::kStep == kRec) {
      store_run(dst, src, count);
    } else if (live) {
      for (int g = il; g < count; g += W)
        dst[g] = src[g / kRec * S::kStep + g % kRec];
    }
  };

  if constexpr (kPass == 1) {
    // 1. forward: simulate alpha+ and filter y - y+ (kalman.py:460-473); a
    // step's slot holds w_t [D] and eps_t, then (v/f, K)
    double* px = stage0 - 2 * S::kP;  // P
    double* py = px + S::kP;          // T P, then the next P
    double* zv = ex + 3 * kVec;       // z (ex: P z, a, alpha+)
    const double* eps_c = eps + static_cast<long long>(c) * t_len;
    double trow[D], qv[S::kQInRegisters ? D : 1];
    int t_held = choice(0);  // the matrix whose row trow holds
#pragma unroll
    for (int j = 0; j < D; ++j) trow[j] = tm_c[t_held * D * D + i * D + j];
    if constexpr (S::kQInRegisters) {
#pragma unroll
      for (int j = 0; j < D; ++j) qv[j] = q_c[j * D + i];  // column i
    }
    for (int e = il; e < D * D; e += W) {
      const int r = e / D;
      px[r * kLd + (e - r * D)] = p0[cd * D + e];
    }
    if (act && !kTv) zv[i] = zi;
    const double hh = h[c];
    auto stage1 = [&](int j, int b) {
      const int t0 = j * kChunk;
      stage_run(stage(b), w_c + t0 * D, w_len(j) * D, D, S::kStep);
      stage_run(stage(b) + D, eps_c + t0, chunk_len(j), 1, S::kStep);
      if constexpr (kTv) {
        stage_run(stage(b) + S::kZ, zt + t0 * D, chunk_len(j) * D, D,
                  S::kStep);
        stage_run(stage(b) + S::kU, u_c + t0 * D, chunk_len(j) * D, D,
                  S::kStep);
        stage_run(stage(b) + S::kS, hs + t0, chunk_len(j), 1, S::kStep);
      }
    };
    double a_i = 0.0;  // the filter on y - y+ starts from a0 = 0
    double sim_i = alpha1[cd + i];
    double y_n = y[0];
    bool o_n = obs == nullptr || obs[0] != 0;
    int s_n = t_held;
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
        double* slot = stage(b) + s * S::kStep;
        const double yt = y_n;
        const bool ob = o_n;
        if constexpr (kTv) {
          if (s_n != t_held) {  // T_t is the calendar's other matrix
            t_held = s_n;
#pragma unroll
            for (int j = 0; j < D; ++j)
              trow[j] = tm_c[t_held * D * D + i * D + j];
          }
        }
        if (t + 1 < t_len) {
          y_n = y[t + 1];
          o_n = obs == nullptr || obs[t + 1] != 0;
          s_n = choice(t + 1);
        }
        const double wt = slot[i];  // w_t[i] (none at t = T - 1)
        const double et = slot[D];
        double ht = hh, ui = 0.0;
        if constexpr (kTv) {
          zv = slot + S::kZ;
          zi = act ? zv[i] : 0.0;
          ui = slot[S::kU + i];
          ht = hh * slot[S::kS];
        }
        const double pz = dot_shared<D>(px + i * kLd, zv);  // P z, row i
        const double zs = group_sum<W>(zi * sim_i, lane);
        const double za = group_sum<W>(zi * a_i, lane);
        const double f = group_sum<W>(zi * pz, lane) + ht;
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
          if constexpr (kTv) q = (slot[S::kU + jj] * ui) * q;
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
      store_slots(scr_c + t0 * kRec, stage(b), n * kRec);
      __syncwarp();  // the group is done with buffer b before it is refilled
    }
  } else if constexpr (kPass == 2) {
    // 2. backward: r_{t-1} = where(obs, z v/f, 0) + L' r_t
    // (kalman.py:315-323), chunks in reverse; r_{t-1} replaces the first D
    // of slot t. Lane i holds column i of T.
    double tcol[D];
    int t_held = choice(t_len - 1);
#pragma unroll
    for (int m = 0; m < D; ++m) tcol[m] = tm_c[t_held * D * D + m * D + i];
    auto stage2 = [&](int j, int b) {
      stage_run(stage(b), scr_c + j * kChunk * kRec, chunk_len(j) * kRec, 1,
                1);
    };
    double r_i = 0.0;
    stage2(n_chunks - 1, 0);
    async_commit();
    bool o_n = obs == nullptr || obs[t_len - 1] != 0;
    double z_n = kTv && act ? zt[(t_len - 1) * D + i] : zi;
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
        if constexpr (kTv) {
          zi = z_n;
          if (t > 0 && act) z_n = zt[(t - 1) * D + i];
          if (choice(t) != t_held) {  // L_t = T_t - K_t z_t'
            t_held = choice(t);
#pragma unroll
            for (int m = 0; m < D; ++m)
              tcol[m] = tm_c[t_held * D * D + m * D + i];
          }
        }
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
    int t_held = choice(0);
#pragma unroll
    for (int m = 0; m < D; ++m) {
      trow[m] = tm_c[t_held * D * D + i * D + m];
      qrow[m] = q_c[i * D + m];  // row i of R Q R'
    }
    // the lane's row of T_k (alpha-hat_t takes T_{t-1}, alpha+_{t+1} T_t)
    auto hold = [&](int k) {
      if (kTv && k != t_held) {
        t_held = k;
#pragma unroll
        for (int m = 0; m < D; ++m) trow[m] = tm_c[k * D * D + i * D + m];
      }
    };
    // u_{t-1} of step t of chunk j (none at t = 0) at kChunk (kRec + D)
    constexpr int kUOff = kChunk * (kRec + D);
    auto stage3 = [&](int j, int b) {
      const int t0 = j * kChunk;
      stage_run(stage(b), scr_c + t0 * kRec, chunk_len(j) * kRec, 1, 1);
      stage_run(stage(b) + kChunk * kRec, w_c + t0 * D, w_len(j) * D, 1, 1);
      if constexpr (kTv) {
        const int s0 = j == 0 ? 1 : 0;
        stage_run(stage(b) + kUOff + s0 * D, u_c + (t0 - 1 + s0) * D,
                  (chunk_len(j) - s0) * D, 1, 1);
      }
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
          hold(choice(t - 1));
          const double ta = dot_pairs<D>(trow, xa);
          double qr;
          if constexpr (kTv) {
            // row i of R Q_{t-1} R' = (u_i u_m) R Q R'[i][m]
            const double* us = stage(b) + kUOff + s * D;
            const double ui = us[i];
            qr = ((ui * us[0]) * qrow[0]) * rs[0];
#pragma unroll
            for (int m = 1; m < D; ++m) qr = qr + ((ui * us[m]) * qrow[m]) * rs[m];
          } else {
            qr = dot<D>(qrow, rs);
          }
          ah = ta + qr;
        }
        const double draw = sim_i + ah;
        if (t < t_len - 1) {
          hold(choice(t));
          sim_i = dot_pairs<D>(trow, xa + kVec) + ws[i];
        }
        if (act) ws[i] = draw;
      }
      __syncwarp();
      store_run(out_c + t0 * D, stage(b) + kChunk * kRec, n * D);
      __syncwarp();
    }
  }
}

// ---- K2w's structured time-varying form -----------------------------------

// T's non-zeros where every chain shares one T (Bsts' T, whose blocks no
// chain's parameters move), as kernel parameters: row j's first non-zero
// (its primary: column pcol[j], value pval[j]; an empty row a 0 at column
// 0), then its others, the extras, at [obeg[j], obeg[j + 1]) of orow
// (= j), ocol and oval, in column order. A loop over j reads row j's
// entries at offsets known at compile time or the same for every lane:
// operands of the constant bank. kMaxNzD bounds d.
constexpr int kMaxNzD = 16;
struct NzT {
  unsigned char pcol[kMaxNzD];
  unsigned char obeg[kMaxNzD + 1];
  unsigned char orow[kMaxNzD * (kMaxNzD - 1)];
  unsigned char ocol[kMaxNzD * (kMaxNzD - 1)];
  double pval[kMaxNzD];
  double oval[kMaxNzD * (kMaxNzD - 1)];
};

// flush(j, s) with s = sum of T[j][m] x(m) over row j's extras, for every
// row j that has extras: one loop over all of T's extras (the same for
// every lane), a row's terms summed in a register.
template <int D, class Get, class Flush>
__device__ __forceinline__ void for_extras(const NzT& nz, Get x,
                                           Flush flush) {
  const int n = nz.obeg[D];
  int row = -1;
  double part = 0.0;
  for (int k = 0; k < n; ++k) {
    const int r = nz.orow[k];
    if (r != row) {
      if (row >= 0) flush(row, part);
      row = r;
      part = 0.0;
    }
    part = part + nz.oval[k] * x(nz.ocol[k]);
  }
  if (row >= 0) flush(row, part);
}

// The extras of its own row that a lane keeps in registers in passes 2
// and 3: a row of up to 1 + kOwnNz non-zeros (the season's top row of six)
// is held whole, and a longer one reads the rest from the constant bank.
constexpr int kOwnNz = 5;

// Row i's extras of nz into ev, ec (kOwnNz of them, padded with zeros at
// the primary's column), and the range [k_more, k_end) of the rest.
__device__ __forceinline__ void own_row(const NzT& nz, int i, int pc,
                                        double (&ev)[kOwnNz],
                                        int (&ec)[kOwnNz], int& k_more,
                                        int& k_end) {
  const int kb = nz.obeg[i];
  k_end = nz.obeg[i + 1];
#pragma unroll
  for (int e = 0; e < kOwnNz; ++e) {
    const bool has = kb + e < k_end;
    ec[e] = has ? nz.ocol[kb + e] : pc;
    ev[e] = has ? nz.oval[kb + e] : 0.0;
  }
  k_more = kb + kOwnNz < k_end ? kb + kOwnNz : k_end;
}

// Row i of T times x (x(m): element m, from shared memory) over the row's
// non-zeros: its primary (pc, pv), the extras own_row kept, the rest.
template <class Get>
__device__ __forceinline__ double own_row_dot(const NzT& nz, int pc,
                                              double pv,
                                              const double (&ev)[kOwnNz],
                                              const int (&ec)[kOwnNz],
                                              int k_more, int k_end,
                                              Get x) {
  double acc = pv * x(pc);
#pragma unroll
  for (int e = 0; e < kOwnNz; ++e) acc = acc + ev[e] * x(ec[e]);
  for (int k = k_more; k < k_end; ++k)
    acc = acc + nz.oval[k] * x(nz.ocol[k]);
  return acc;
}

// The structured form's layout at state dimension D for pass kPass: a
// group of W lanes a chain, lane i a row, as Wide. A chain's shared memory
// (doubles): the exchange vectors (passes 1 and 2 two of kVec, pass 3
// four), in pass 1 two D x kLo buffers A (M, then the P' a lane forms) and
// B (V = M T'), kLo odd so that the lanes of a group meet D banks both
// along a row and down a column; two stage buffers of kChunk steps of
// kStep doubles: pass 1 w_t, eps_t and u_t (kU), a step's (v/f, K)
// written over w_t and eps_t; pass 2 the slots; pass 3 the slots, w_t and
// u_{t-1}. Pass 1 stages z_t and h_scale once for the block, ahead of the
// chains, two buffers of kChunk steps of kVec + 1 (kBlk doubles), so a
// chain's slot holds only its own streams.
template <int D, int kPass>
struct WideNz {
  static constexpr int kW = group_lanes(D);
  static constexpr int kPerWarp = kWarp / kW;
  static constexpr int kChainsPerBlock = kBlock / kWarp * kPerWarp;
  static constexpr int kLo = D | 1;
  static constexpr int kVec = D + D % 2;
  static constexpr int kRec = D + 1;
  static constexpr int kSq = kPass == 1 ? D * kLo : 0;
  static constexpr int kEx = kPass == 3 ? 4 * kVec : 2 * kVec;
  static constexpr int kU = (D + 2) / 2 * 2;
  static constexpr int kStep = kPass == 1   ? (kU + D + 1) / 2 * 2
                               : kPass == 3 ? 3 * D + 1
                                            : D + 1;
  // pass 1 keeps row i of R Q R' in registers beside row i of P
  static constexpr bool kQInRegisters = D <= 13;
  static constexpr int blk_doubles(int chunk) {
    return kPass == 1 ? 2 * chunk * (kVec + 1) : 0;
  }
  static constexpr int chain_doubles(int chunk) {
    return (kEx + 2 * kSq + 2 * chunk * kStep + 3) / 8 * 8 + 4;
  }
  static constexpr bool fits(int chunk) {
    return kWideMinBlocks * ((kChainsPerBlock * chain_doubles(chunk) +
                              blk_doubles(chunk)) * 8 +
                             kSmemPerBlock) <= kSmemPerSm;
  }
  static constexpr int kChunk = fits(16) ? 16 : fits(8) ? 8 : fits(6) ? 6
                              : fits(4) ? 4 : 2;
  static constexpr int kBlk = blk_doubles(kChunk);
  static constexpr int kDoubles = chain_doubles(kChunk);
  static constexpr int kBlockBytes =
      (kChainsPerBlock * kDoubles + kBlk) * 8;
  static_assert(D >= 2 && D <= kMaxNzD && fits(kChunk), "K2w's nz layout");
};

// K2w's structured time-varying form, pass kPass: the function of
// smoother_wide_kernel<D, kPass, true> (its operands but T, which is nz:
// T's non-zeros in passes 1 and 3, T''s in pass 2) with T's products over
// its non-zeros. Every product is laid out so that a lane's work is T's
// non-zeros whatever its row's length: a lane forms its row of a product
// by the right (a row of M T' from its own row of M) or reads a column
// (P' = T V, row i of it is column i of T V by symmetry, from column i of
// V), so a loop over T's rows j, each term of its own offsets, is the same
// instruction stream on every lane, and the season's long top row costs
// every lane its six terms once, not six times the row. A step of pass 1
// is the symmetric Riccati step:
//   P z, f = z'P z + h_t; v = (y - eps_t) - z'b with b = a + alpha+ (the
//   filter on y - y+ and the simulation share a row: v needs only their
//   sum, and their next values are T (a + K~ v) + T alpha+ + w_t, K~ =
//   P z / f);
//   M = P - (P z)(P z)' / f where observed (P elsewhere), row i into A;
//   V = M T', row i into B (its primaries, then the extras);
//   K = T P z / f and b' = T (b + K~ v) + w_t, row i from the exchange;
//   P' = T V + R Q_t R', column i of T V into row i of A;
//   P = 0.5 (P' + P'^T), the diagonal exact, row i into registers;
// the plain version's (T P) L' + R Q_t R' and its symmetrisation to
// rounding. Pass 2 is r_{t-1} = where(obs, z v/f, 0) + T' r - z (K . r),
// its L' r with the sum K . r a butterfly; pass 3 forms T alpha-hat and
// T alpha+ over T's non-zeros. Three __syncwarp()s a step in pass 1, one
// in passes 2 and 3, and one __syncthreads() a chunk in pass 1 (the
// block's stage of z_t and h_scale).
template <int D, int kPass>
__global__ void __launch_bounds__(kBlock, kWideMinBlocks)
    smoother_wide_nz_kernel(const __grid_constant__ NzT nz,
                            const double* __restrict__ rqr,
                            const double* __restrict__ h,
                            const double* __restrict__ p0,
                            const double* __restrict__ alpha1,
                            const double* __restrict__ w,
                            const double* __restrict__ eps,
                            const double* __restrict__ y,
                            const unsigned char* __restrict__ obs,
                            double* __restrict__ scratch,
                            double* __restrict__ out, int batch, int t_len,
                            const double* __restrict__ zt,
                            const double* __restrict__ hs,
                            const double* __restrict__ u,
                            long long u_stride) {
  using S = WideNz<D, kPass>;
  constexpr int W = S::kW, kLo = S::kLo, kVec = S::kVec, kRec = S::kRec;
  constexpr int kChunk = S::kChunk, kStep = S::kStep;
  BOOM_SHARED_BYTES(smem_raw);
  const int lane = threadIdx.x % kWarp;
  const int il = lane % W;  // the row of this lane
  const bool act = il < D;
  const int i = act ? il : 0;  // idle lanes shadow row 0, write nothing
  const int cb = threadIdx.x / kWarp * S::kPerWarp + lane / W;
  const int c_at = blockIdx.x * (blockDim.x / kWarp * S::kPerWarp) + cb;
  const bool live = c_at < batch;  // a group past the batch writes nothing
  const int c = live ? c_at : batch - 1;
  double* blk = reinterpret_cast<double*>(smem_raw);
  double* ex = blk + S::kBlk + static_cast<long long>(cb) * S::kDoubles;
  double* stage0 = ex + S::kEx + 2 * S::kSq;
  auto stage = [&](int b) { return stage0 + b * kChunk * kStep; };

  const long long cd = static_cast<long long>(c) * D;
  const double* q_c = rqr + cd * D;
  const double* w_c = w + static_cast<long long>(c) * (t_len - 1) * D;
  double* scr_c = scratch + static_cast<long long>(c) * t_len * kRec;
  const double* u_c = u + static_cast<long long>(c) * u_stride;
  // the primary of this lane's row (of T; of T' in pass 2)
  const int pc = nz.pcol[i];
  const double pv = nz.pval[i];
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
  // dst[g / every * pitch + g % every]
  auto stage_run = [&](double* dst, const double* src, int count,
                       int every, int pitch) {
    for (int g = il; g < count; g += W)
      copy_async<8>(dst + g / every * pitch + g % every, src + g);
  };
  auto store_run = [&](double* dst, const double* src, int count) {
    if (live)
      for (int g = il; g < count; g += W) dst[g] = src[g];
  };

  if constexpr (kPass == 1) {
    // 1. forward: simulate alpha+ and filter y - y+ (kalman.py:460-473)
    double* exz = ex;           // P z
    double* exx = ex + kVec;    // b + K~ v
    double* ma = ex + 2 * kVec; // A: M, then P'
    double* vb = ma + S::kSq;   // B: V = M T'
    const double* eps_c = eps + static_cast<long long>(c) * t_len;
    double prow[D], qv[S::kQInRegisters ? D : 1];
#pragma unroll
    for (int j = 0; j < D; ++j) prow[j] = p0[(cd + i) * D + j];
    if constexpr (S::kQInRegisters) {
#pragma unroll
      for (int j = 0; j < D; ++j) qv[j] = q_c[i * D + j];  // row i
    }
    const double hh = h[c];
    // the block's z_t [kChunk][kVec], then h_scale [kChunk], of buffer b
    auto zbuf = [&](int b) { return blk + b * kChunk * (kVec + 1); };
    auto stage1 = [&](int j, int b) {
      const int t0 = j * kChunk, n = chunk_len(j);
      double* zb = zbuf(b);
      for (int g = threadIdx.x; g < n * D; g += blockDim.x)
        copy_async<8>(zb + g / D * kVec + g % D, zt + t0 * D + g);
      for (int g = threadIdx.x; g < n; g += blockDim.x)
        copy_async<8>(zb + kChunk * kVec + g, hs + t0 + g);
      stage_run(stage(b), w_c + t0 * D, w_len(j) * D, D, kStep);
      stage_run(stage(b) + D, eps_c + t0, n, 1, kStep);
      stage_run(stage(b) + S::kU, u_c + t0 * D, n * D, D, kStep);
    };
    double b_i = alpha1[cd + i];  // a_1 + alpha+_1, a_1 = 0
    double y_n = y[0];
    bool o_n = obs == nullptr || obs[0] != 0;
    stage1(0, 0);
    async_commit();
    for (int j = 0; j < n_chunks; ++j) {
      const int b = j & 1, t0 = j * kChunk, n = chunk_len(j);
      async_wait<0>();
      __syncthreads();  // chunk j is staged; every group is past chunk j - 1
      if (j + 1 < n_chunks) stage1(j + 1, b ^ 1);
      async_commit();
      const double* zb = zbuf(b);
      for (int s = 0; s < n; ++s) {
        const int t = t0 + s;
        double* slot = stage(b) + s * kStep;
        const double* zr = zb + s * kVec;
        const double yt = y_n;
        const bool ob = o_n;
        if (t + 1 < t_len) {
          y_n = y[t + 1];
          o_n = obs == nullptr || obs[t + 1] != 0;
        }
        const double wt = slot[i];  // w_t[i] (none at t = T - 1)
        const double et = slot[D];
        const double ui = slot[S::kU + i];
        const double ht = hh * zb[kChunk * kVec + s];
        const double zi = act ? zr[i] : 0.0;
        const double pz = dot_pairs<D>(prow, zr);  // (P z)_i
        const double f = group_sum<W>(zi * pz, lane) + ht;
        const double zb_i = group_sum<W>(zi * b_i, lane);
        const double v = ob ? (yt - et) - zb_i : 0.0;
        const double rf = reciprocal(f);
        const double kt = ob ? pz * rf : 0.0;  // K~_i
        if (act) {
          exz[i] = pz;
          exx[i] = b_i + kt * v;
        }
        __syncwarp();  // P z and b + K~ v are whole
        if (act) {
          double* mrow = ma + i * kLo;
#pragma unroll
          for (int jj = 0; jj + 1 < D; jj += 2) {
            const Pair q = ld_pair(exz + jj);
            mrow[jj] = ob ? prow[jj] - (pz * q.x) * rf : prow[jj];
            mrow[jj + 1] = ob ? prow[jj + 1] - (pz * q.y) * rf : prow[jj + 1];
          }
          if constexpr (D % 2 == 1)
            mrow[D - 1] =
                ob ? prow[D - 1] - (pz * exz[D - 1]) * rf : prow[D - 1];
          // V[i][j] = sum_m T[j][m] M[i][m]: every primary, then the
          // extras of the rows that have them
          double* vrow = vb + i * kLo;
#pragma unroll
          for (int jj = 0; jj < D; ++jj)
            vrow[jj] = nz.pval[jj] * mrow[nz.pcol[jj]];
          for_extras<D>(nz, [&](int m) { return mrow[m]; },
                        [&](int j, double part) { vrow[j] += part; });
        }
        __syncwarp();  // V is whole
        // (T P z)_i and (T (b + K~ v))_i over row i's non-zeros: a loop
        // over all of T's extras, the same for every lane
        double tp = pv * exz[pc], tx = pv * exx[pc];
        for (int k = 0; k < nz.obeg[D]; ++k) {
          if (nz.orow[k] == i) {
            tp = tp + nz.oval[k] * exz[nz.ocol[k]];
            tx = tx + nz.oval[k] * exx[nz.ocol[k]];
          }
        }
        const double kg = ob ? tp * rf : 0.0;
        if (act) slot[1 + i] = kg;  // lane i + 1 read w_t[i + 1] there
        if (il == 0) slot[0] = v * rf;
        if (t < t_len - 1) b_i = tx + wt;
        // P'[i][j] = (T V)[j][i] + R Q_t R'[i][j], R Q_t R' = (u_t u_t') o
        // R Q R' (idle lanes shadow row 0 and write nothing)
        // row i of P' = (T V)[j][i] + R Q_t R'[i][j], R Q_t R' = (u_t u_t')
        // o R Q R', in place of P's row (M holds what this step needed of
        // it), a row's extras added through a select of compile-time
        // indices; then into A (idle lanes shadow row 0, write nothing)
#pragma unroll
        for (int jj = 0; jj < D; ++jj)
          prow[jj] = nz.pval[jj] * vb[nz.pcol[jj] * kLo + i];
        for_extras<D>(nz, [&](int m) { return vb[m * kLo + i]; },
                      [&](int j, double part) {
#pragma unroll
                        for (int jj = 0; jj < D; ++jj)
                          if (jj == j) prow[jj] = prow[jj] + part;
                      });
#pragma unroll
        for (int jj = 0; jj < D; ++jj) {
          double q;
          if constexpr (S::kQInRegisters)
            q = qv[jj];
          else
            q = q_c[i * D + jj];
          prow[jj] = prow[jj] + (ui * slot[S::kU + jj]) * q;
          if (act) ma[i * kLo + jj] = prow[jj];
        }
        __syncwarp();  // P' is whole in A
        // P = 0.5 (P' + P'^T), the diagonal P'_ii exactly, row i
#pragma unroll
        for (int jj = 0; jj < D; ++jj)
          if (jj != i) prow[jj] = 0.5 * (prow[jj] + ma[jj * kLo + i]);
      }
      if (live)
        for (int g = il; g < n * kRec; g += W)
          scr_c[t0 * kRec + g] = stage(b)[g / kRec * kStep + g % kRec];
    }
  } else if constexpr (kPass == 2) {
    // 2. backward: r_{t-1} = where(obs, z v/f, 0) + L' r_t
    // (kalman.py:315-323) = where(obs, z v/f, 0) + T' r_t - z (K . r_t),
    // chunks in reverse; r_{t-1} replaces the first D of slot t. nz holds
    // T''s non-zeros: this lane's row of T' is column i of T.
    auto stage2 = [&](int j, int b) {
      stage_run(stage(b), scr_c + j * kChunk * kRec, chunk_len(j) * kRec, 1,
                1);
    };
    double ev[kOwnNz];
    int ec[kOwnNz], k_more, k_end;
    own_row(nz, i, pc, ev, ec, k_more, k_end);
    double r_i = 0.0;
    stage2(n_chunks - 1, 0);
    async_commit();
    bool o_n = obs == nullptr || obs[t_len - 1] != 0;
    double z_n = act ? zt[(t_len - 1) * D + i] : 0.0;
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
        const double zi = z_n;
        if (t > 0 && act) z_n = zt[(t - 1) * D + i];
        const double vf = slot[0];
        const double ki = act ? slot[1 + i] : 0.0;
        double* xr = ex + (t & 1) * kVec;  // r_t
        if (act) xr[i] = r_i;
        const double kr = group_sum<W>(ki * r_i, lane);  // K . r_t
        __syncwarp();  // the other parity's readers are two steps behind
        const double tr = own_row_dot(nz, pc, pv, ev, ec, k_more, k_end,
                                      [&](int m) { return xr[m]; });
        r_i = (ob ? zi * vf : 0.0) + (tr - zi * kr);
        if (act) slot[i] = r_i;  // lane i - 1 read K_{i-1} there
      }
      __syncwarp();
      store_run(scr_c + t0 * kRec, stage(b), n * kRec);
      __syncwarp();
    }
  } else {
    // 3. forward state: alpha_1 = P0 r_0, alpha_{t+1} = T alpha_t +
    // R Q_t R' r_t (kalman.py:325, :345-350), added to alpha+ regenerated
    // from alpha_1 and w as pass 1 made it (:481); a chunk holds the slots
    // (r in their first D), w [D] a step at kChunk kRec (the draw replaces
    // it) and u_{t-1} [D] a step at kChunk (kRec + D)
    double* out_c = out + static_cast<long long>(c) * t_len * D;
    double qrow[D];
#pragma unroll
    for (int m = 0; m < D; ++m) qrow[m] = q_c[i * D + m];  // row i
    constexpr int kUOff = kChunk * (kRec + D);
    auto stage3 = [&](int j, int b) {
      const int t0 = j * kChunk;
      stage_run(stage(b), scr_c + t0 * kRec, chunk_len(j) * kRec, 1, 1);
      stage_run(stage(b) + kChunk * kRec, w_c + t0 * D, w_len(j) * D, 1, 1);
      const int s0 = j == 0 ? 1 : 0;
      stage_run(stage(b) + kUOff + s0 * D, u_c + (t0 - 1 + s0) * D,
                (chunk_len(j) - s0) * D, 1, 1);
    };
    double ev[kOwnNz];
    int ec[kOwnNz], k_more, k_end;
    own_row(nz, i, pc, ev, ec, k_more, k_end);
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
          // row i of R Q_{t-1} R' = (u_i u_m) R Q R'[i][m]
          const double* us = stage(b) + kUOff + s * D;
          const double ui = us[i];
          double qr = ((ui * us[0]) * qrow[0]) * rs[0];
#pragma unroll
          for (int m = 1; m < D; ++m)
            qr = qr + ((ui * us[m]) * qrow[m]) * rs[m];
          // (T alpha-hat_{t-1})_i over row i's non-zeros
          ah = own_row_dot(nz, pc, pv, ev, ec, k_more, k_end,
                           [&](int m) { return xa[m]; }) + qr;
        }
        const double draw = sim_i + ah;
        if (t < t_len - 1)  // (T alpha+_t)_i
          sim_i = own_row_dot(nz, pc, pv, ev, ec, k_more, k_end,
                              [&](int m) { return xa[kVec + m]; }) + ws[i];
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

// ---- K1w's group kernel ---------------------------------------------------

// The loglik's layout: a group of W lanes a series, kPerWarp series a warp,
// kUnits a block. A series' shared memory, 16-byte aligned: P in two
// buffers X and Y (D x kLd), the exchange vectors P z and a (D each) and z
// (D).
template <typename T, int D>
struct WideLoglik {
  static constexpr int kW = group_lanes(D);
  static constexpr int kPerWarp = kWarp / kW;
  static constexpr int kUnits = kBlock / kWarp * kPerWarp;
  static constexpr int kLd = D + 1;
  static constexpr int kUnitBytes =
      (2 * D * kLd * static_cast<int>(sizeof(T)) +
       3 * D * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  // the column of R Q R' stays in registers while it costs at most 16 of
  // them (float32 at every d, float64 to d = 8) and is read from the cache
  // past that
  static constexpr bool kQInRegisters = D * sizeof(T) <= 64;
  static constexpr int kMaxBytes = kUnits * kUnitBytes;
  static_assert(kMaxBytes <= kSmemPerSm - kSmemPerBlock, "the loglik's layout");
};

// K1w: the loglik of each system b over series b / per_series of y
// [n_series, T], and with vout the innovations v and f [B, T]. Lane i < D
// of a system's group holds row i of T and a, the system's P is in shared
// memory; a filter step is K2w's pass 1 without alpha+: lane i forms row i
// of P z and of T P (into Y), publishes P z and a; then K_i = (T P z)_i /
// f, its own row of L = T - K z' and column i of P' = (T P) L' + R Q R'
// over X; then row i of 0.5 (P' + P'^T), the diagonal exact, into Y; three
// __syncwarp()s a step. z'a and z'P z are group butterflies (the same bits
// on every lane of the group, so the groups never diverge and repeated
// launches are bit-identical). A group past the last shadows it and writes
// nothing; lanes i >= D shadow row 0. (A time-varying system takes
// loglik_tv_warp_kernel.)
template <typename T, int D>
__global__ void __launch_bounds__(kBlock)
    wide_loglik_kernel(const T* __restrict__ z, const T* __restrict__ tm,
                       const T* __restrict__ rqr, const T* __restrict__ h,
                       const T* __restrict__ a0, const T* __restrict__ p0,
                       const T* __restrict__ y,
                       const unsigned char* __restrict__ obs,
                       T* __restrict__ ll, T* __restrict__ vout,
                       T* __restrict__ fout, int batch, int t_len,
                       int per_series, int tm_stride, int z_stride) {
  using L = WideLoglik<T, D>;
  constexpr int W = L::kW, kLd = L::kLd;
  BOOM_SHARED_BYTES(smem_raw);
  const int lane = threadIdx.x % kWarp;
  const int il = lane % W;
  const bool act = il < D;
  const int i = act ? il : 0;
  const int ub = threadIdx.x / kWarp * L::kPerWarp + lane / W;
  const long long u_at =
      static_cast<long long>(blockIdx.x) * (blockDim.x / kWarp * L::kPerWarp) +
      ub;
  const bool live = u_at < batch;
  const int b = static_cast<int>(live ? u_at : batch - 1);
  unsigned char* unit = smem_raw + ub * L::kUnitBytes;
  T* px = reinterpret_cast<T*>(unit);  // P
  T* py = px + D * kLd;                // T P, then the next P
  T* xpz = py + D * kLd;               // P z
  T* xa = xpz + D;                     // a
  T* zv = xa + D;

  const long long bd = static_cast<long long>(b) * D;
  const T* tm_b = tm + static_cast<long long>(b) * tm_stride;
  const T* q_b = rqr + bd * D;
  const T* y_b = y + static_cast<long long>(b / per_series) * t_len;
  T trow[D], qv[L::kQInRegisters ? D : 1];
#pragma unroll
  for (int j = 0; j < D; ++j) trow[j] = tm_b[i * D + j];
  if constexpr (L::kQInRegisters) {
#pragma unroll
    for (int j = 0; j < D; ++j) qv[j] = q_b[j * D + i];  // column i
  }
  for (int k = il; k < D * D; k += W) {
    const int r = k / D;
    px[r * kLd + (k - r * D)] = p0[bd * D + k];
  }
  const T zi = act ? z[static_cast<long long>(b) * z_stride + i] : T(0);
  if (act) zv[i] = zi;
  T a_i = a0[bd + i];
  // the column of R Q R'
  auto q_of = [&](int jj) {
    if constexpr (L::kQInRegisters)
      return qv[jj];
    else
      return q_b[jj * D + i];
  };
  const T hh = h[b];
  const T zero(0);
  T acc = zero;
  T y_n = y_b[0];
  bool o_n = obs == nullptr || obs[0] != 0;
  __syncwarp();
  for (int t = 0; t < t_len; ++t) {
    const T yt = y_n;
    const bool ob = o_n;
    if (t + 1 < t_len) {
      y_n = y_b[t + 1];
      o_n = obs == nullptr || obs[t + 1] != 0;
    }
    T pz = px[i * kLd] * zv[0];  // P z, row i
#pragma unroll
    for (int j = 1; j < D; ++j) pz = pz + px[i * kLd + j] * zv[j];
    const T za = group_sum<W>(zi * a_i, lane);
    const T f = group_sum<W>(zi * pz, lane) + hh;
    const T v = ob ? yt - za : zero;
    const T rf = reciprocal(f);
    // (T P) row i into Y
#pragma unroll
    for (int jj = 0; jj < D; ++jj) {
      T tp = trow[0] * px[jj];
#pragma unroll
      for (int m = 1; m < D; ++m) tp = tp + trow[m] * px[m * kLd + jj];
      if (act) py[i * kLd + jj] = tp;
    }
    if (act) {
      xpz[i] = pz;
      xa[i] = a_i;
    }
    __syncwarp();  // P z, a and T P are whole; P is read
    T tpz = trow[0] * xpz[0], ta = trow[0] * xa[0];
#pragma unroll
    for (int m = 1; m < D; ++m) {
      tpz = tpz + trow[m] * xpz[m];
      ta = ta + trow[m] * xa[m];
    }
    const T k = ob ? tpz * rf : zero;
    // column i of P' = (T P) L' + R Q R', L row i = T row i - K_i z'
#pragma unroll
    for (int jj = 0; jj < D; ++jj) {
      T pn = (trow[0] - k * zv[0]) * py[jj * kLd];
#pragma unroll
      for (int m = 1; m < D; ++m)
        pn = pn + (trow[m] - k * zv[m]) * py[jj * kLd + m];
      pn = pn + q_of(jj);
      if (act) px[jj * kLd + i] = pn;
    }
    a_i = ta + k * v;
    if (vout != nullptr && live && il == 0) {
      vout[static_cast<long long>(b) * t_len + t] = v;
      fout[static_cast<long long>(b) * t_len + t] = f;
    }
    if (ob) acc = acc + log_density(v, f, rf);
    __syncwarp();  // P' is whole in X
    // 0.5 (P' + P'^T), the diagonal P'_ii exactly, row i into Y
    if (act) {
      for (int jj = 0; jj < D; ++jj)
        py[i * kLd + jj] =
            jj == i ? px[i * kLd + i]
                    : T(0.5) * (px[i * kLd + jj] + px[jj * kLd + i]);
    }
    __syncwarp();  // P is whole in Y
    T* swap = px;
    px = py;
    py = swap;
  }
  if (live && il == 0) ll[b] = acc;
}

// ---- K1w: a thread a system ----------------------------------------------

// Entry (i, j) of a symmetric D x D matrix's upper triangle, row by row.
// Not recursive, so that it inlines and folds in the unrolled loops (a
// register array indexed by a value known only at run time lives in local
// memory).
template <int D>
__host__ __device__ __forceinline__ constexpr int upper(int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i)
                : j * D - j * (j - 1) / 2 + (i - j);
}

// float32 K1w takes the thread kernel to this d; past it, and in float64,
// the group kernel (wide_loglik_kernel<T, D>)
constexpr int kThreadLoglikMaxD = 13;

// The thread kernel's T where every system has the same one (kSharedT): in
// the constant bank, so that each multiply-add reads its entry of T as an
// operand, no load at all. Copied there on the launch's stream before each
// launch (cudaMemcpyToSymbolAsync from the device, no host sync): launches
// on other streams at once would share it.
__constant__ float c_tm[kThreadLoglikMaxD * kThreadLoglikMaxD];

// The thread kernel's layout: a block is one warp, a thread a system. Its
// shared memory (floats, each part 16-byte aligned): where each system has
// its own T, the warp's 32 matrices entry-major (entry e of thread r at e
// kPitch + r: a warp's load meets 32 banks); the upper triangle of 0.5
// (R Q R' + (R Q R')') and P' (each thread writes and reads back only its
// own), entry-major; two stage buffers of y, a row of kChunk steps (pitch
// kChunk + 1) for each series the warp reads; with the innovations, v and
// f of a chunk, a row a thread.
template <int D, bool kSharedT>
struct ThreadLoglik {
  static constexpr int kUpper = D * (D + 1) / 2;
  static constexpr int kPitch = kWarp + 1;
  static constexpr int kChunk = 8;
  static constexpr int align(int n) { return (n + 3) / 4 * 4; }
  static constexpr int kTm = kSharedT ? 0 : align(D * D * kPitch);
  static constexpr int kQ = align(kUpper * kPitch);
  static constexpr int kStage = align(kWarp * (kChunk + 1));
  static constexpr int bytes(bool innovations) {
    return (kTm + 2 * kQ + (innovations ? 4 : 2) * kStage) * 4;
  }
  static_assert(D <= kThreadLoglikMaxD &&
                    bytes(true) <= kSmemPerSm - kSmemPerBlock,
                "K1w's thread layout");
};

// Resident one-warp blocks an SM that __launch_bounds__ asks for: 16 to
// d = 8, four a scheduler of the SM at most 128 registers each (17 would
// put five on one scheduler and leave 96: d = 8 then spilled 140 bytes);
// 8 (255 registers) past it.
__host__ __device__ constexpr int thread_loglik_min_blocks(int d) {
  return d <= 8 ? 16 : 8;
}

// Row i of T into r: the constant bank's entries (kSharedT), or the
// thread's own from shared memory through volatile loads, so that the
// compiler loads a row where it is used and does not keep the rows of one
// step's unrolled loops live in registers from one row to the next.
template <int D, bool kSharedT>
__device__ __forceinline__ void t_row(float (&r)[D], const float* tsm, int i,
                                      int lane) {
  if constexpr (kSharedT) {
#pragma unroll
    for (int m = 0; m < D; ++m) r[m] = c_tm[i * D + m];
  } else {
    const volatile float* own = tsm + lane;
#pragma unroll
    for (int m = 0; m < D; ++m)
      r[m] = own[(i * D + m) * ThreadLoglik<D, kSharedT>::kPitch];
  }
}

// K1w (float32, 7 <= d <= kThreadLoglikMaxD): the loglik of each system b
// over series b / per_series of y [n_series, T], and with vout the
// innovations v and f [B, T], as wide_loglik_kernel<T, D> computes
// them. A thread a system, a block a warp: P is the upper triangle in the
// thread's registers, and a step is the symmetric Riccati step as the
// measurement update, then the time update:
//   v = y - z'a, P z, f = z'P z + h; where observed a += P z v / f and
//   P -= (P z)(P z)' / f (unobserved: both stay);
//   a' = T a; P' = T P T' + R Q R', a row m of T P at a time and from it
//   the upper triangle's row of m T', into shared memory, read back into
//   P at the end of the step;
// the same function as the plain version's (T P) L' + R Q R',
// symmetrised, with L = T - K z', K = T P z / f. No lane exchanges
// anything during a step: the warp meets only once a chunk of y. P0 and
// R Q R' are symmetrised as they are read. A thread past the batch shadows
// the last system and writes nothing.
template <int D, bool kSharedT>
__global__ void __launch_bounds__(kWarp, thread_loglik_min_blocks(D))
    loglik_thread_kernel(const float* __restrict__ z,
                         const float* __restrict__ tm,
                         const float* __restrict__ rqr,
                         const float* __restrict__ h,
                         const float* __restrict__ a0,
                         const float* __restrict__ p0,
                         const float* __restrict__ y,
                         const unsigned char* __restrict__ obs,
                         float* __restrict__ ll, float* __restrict__ vout,
                         float* __restrict__ fout, int batch, int t_len,
                         int per_series, int z_stride) {
  using L = ThreadLoglik<D, kSharedT>;
  using T = float;
  constexpr int kP = L::kPitch, kChunk = L::kChunk, kSp = kChunk + 1;
  constexpr int kDD = D * D;
  BOOM_SHARED_BYTES(smem_raw);
  T* tsm = reinterpret_cast<T*>(smem_raw);
  T* qsm = tsm + L::kTm;
  T* nsm = qsm + L::kQ;          // P' (upper triangle)
  T* ysm = nsm + L::kQ;          // two stage buffers of y
  T* vsm = ysm + 2 * L::kStage;  // v, then f, of a chunk
  T* fsm = vsm + L::kStage;
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kWarp;
  const int last = (batch - b0 < kWarp ? batch : b0 + kWarp) - 1;
  const bool live = b0 + lane <= last;
  const int b = live ? b0 + lane : last;
  auto sys = [&](int r) { return b0 + r <= last ? b0 + r : last; };

  // the warp's constants, once a launch
  if constexpr (!kSharedT) {
    for (int g = lane; g < kWarp * kDD; g += kWarp) {
      const int r = g / kDD, e = g - r * kDD;
      tsm[e * kP + r] = tm[static_cast<long long>(sys(r)) * kDD + e];
    }
  }
  for (int g = lane; g < kWarp * kDD; g += kWarp) {
    const int r = g / kDD, e = g - r * kDD, i = e / D, j = e - i * D;
    if (j < i) continue;
    const T* q = rqr + static_cast<long long>(sys(r)) * kDD;
    qsm[upper<D>(i, j) * kP + r] = T(0.5) * (q[i * D + j] + q[j * D + i]);
  }
  T zk[D], a[D], p[L::kUpper];
  const T* p0_b = p0 + static_cast<long long>(b) * kDD;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    zk[i] = z[static_cast<long long>(b) * z_stride + i];
    a[i] = a0[static_cast<long long>(b) * D + i];
#pragma unroll
    for (int j = i; j < D; ++j)
      p[upper<D>(i, j)] = T(0.5) * (p0_b[i * D + j] + p0_b[j * D + i]);
  }
  const T hh = h[b];
  // 0.5 (R Q R' + (R Q R')')(u) at qs[u kP], P'(u) at pn[u kP]: volatile,
  // so that the compiler neither hoists the one out of the step loop nor
  // forwards the other from its stores to its loads, either of which would
  // keep 36-91 more values live in registers
  const volatile T* qs = qsm + lane;
  volatile T* pn = nsm + lane;

  // y, a chunk of steps ahead: the rows of the warp's series
  const int s_lo = b0 / per_series;
  const int rows = last / per_series - s_lo + 1;
  const int row = b / per_series - s_lo;
  const T* y_lo = y + static_cast<long long>(s_lo) * t_len;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;
  auto stage = [&](int j, int buf) {
    const int t0 = j * kChunk;
    const int n = t_len - t0 < kChunk ? t_len - t0 : kChunk;
    T* dst = ysm + buf * L::kStage;
    for (int g = lane; g < rows * kChunk; g += kWarp) {
      const int r = g / kChunk, k = g - r * kChunk;
      if (k < n)
        copy_async<sizeof(T)>(dst + r * kSp + k,
                              y_lo + static_cast<long long>(r) * t_len + t0 +
                                  k);
    }
  };
  T acc = T(0);
  bool o_n = obs == nullptr || obs[0] != 0;
  __syncwarp();  // the constants are whole
  stage(0, 0);
  async_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int buf = j & 1, t0 = j * kChunk;
    const int n = t_len - t0 < kChunk ? t_len - t0 : kChunk;
    if (j + 1 < n_chunks) stage(j + 1, buf ^ 1);
    async_commit();
    async_wait<1>();
    __syncwarp();  // chunk j of y is whole in buffer buf
    const T* ys = ysm + buf * L::kStage + row * kSp;
    for (int s = 0; s < n; ++s) {
      const int t = t0 + s;
      const bool ob = o_n;
      if (t + 1 < t_len) o_n = obs == nullptr || obs[t + 1] != 0;
      // the measurement update
      const T v = ob ? ys[s] - dot<D>(zk, a) : T(0);
      T pz[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T acc_i = p[upper<D>(i, 0)] * zk[0];
#pragma unroll
        for (int k = 1; k < D; ++k)
          acc_i = acc_i + p[upper<D>(i, k)] * zk[k];
        pz[i] = acc_i;
      }
      const T f = dot<D>(zk, pz) + hh;
      const T rf = reciprocal(f);
      const T vf = v * rf;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        a[i] = a[i] + pz[i] * vf;
        const T ki = ob ? pz[i] * rf : T(0);
#pragma unroll
        for (int k = i; k < D; ++k)
          p[upper<D>(i, k)] = p[upper<D>(i, k)] - ki * pz[k];
      }
      if (ob) acc = acc + log_density(v, f, rf);
      if (vout != nullptr) {
        vsm[lane * kSp + s] = v;
        fsm[lane * kSp + s] = f;
      }
      // the time update, a row of T P at a time
      T an[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T ti[D];
        t_row<D, kSharedT>(ti, tsm, i, lane);
        an[i] = dot<D>(ti, a);
        T m[D];  // row i of T P
#pragma unroll
        for (int k = 0; k < D; ++k) {
          T acc_k = ti[0] * p[upper<D>(0, k)];
#pragma unroll
          for (int l = 1; l < D; ++l)
            acc_k = acc_k + ti[l] * p[upper<D>(l, k)];
          m[k] = acc_k;
        }
#pragma unroll
        for (int k = i; k < D; ++k) {
          T tk[D];
          t_row<D, kSharedT>(tk, tsm, k, lane);
          const int u = upper<D>(i, k);
          pn[u * kP] = dot<D>(m, tk) + qs[u * kP];
        }
      }
#pragma unroll
      for (int i = 0; i < D; ++i) a[i] = an[i];
#pragma unroll
      for (int k = 0; k < L::kUpper; ++k) p[k] = pn[k * kP];
    }
    if (vout != nullptr) {
      __syncwarp();  // v and f of the chunk are whole
      for (int g = lane; g < kWarp * n; g += kWarp) {
        const int r = g / n, k = g - r * n;
        if (b0 + r > last) break;
        const long long at = static_cast<long long>(b0 + r) * t_len + t0 + k;
        vout[at] = vsm[r * kSp + k];
        fout[at] = fsm[r * kSp + k];
      }
    }
    __syncwarp();  // buffer buf, v and f are read before they are refilled
  }
  if (live) ll[b] = acc;
}

// ---- J1, J2: the loglik's derivatives along directions -------------------

// The most directions J1 and J2 take.
constexpr int kMaxDirections = 16;

// Unit e's directions (di, dj): in J1 (kOrder 1) entry e is direction e; in
// J2 the e-th pair i <= j of the upper triangle, row by row.
template <int kOrder>
__device__ __forceinline__ void unit_directions(int e, int n_dirs, int& di,
                                                int& dj) {
  di = e;
  dj = e;
  if constexpr (kOrder == 2) {
    di = 0;
    int left = e;
    while (left >= n_dirs - di) left -= n_dirs - di++;
    dj = di + left;
  }
}

// (i, j), i <= j, of entry k of a D x D upper triangle, row by row.
template <int D>
__device__ __forceinline__ void upper_entry(int k, int& i, int& j) {
  i = 0;
  while (k >= D - i) k -= D - i++;
  j = i + k;
}

// Entry (i, j) of 0.5 (m + m') for a row-major D x D matrix m.
template <int D>
__device__ __forceinline__ double sym_entry(const double* m, int i, int j) {
  return 0.5 * (m[i * D + j] + m[j * D + i]);
}

// Entry (i, j) of the unit's R Q R', symmetrised, with its derivatives along
// its directions di and dj (dm [K, D, D]).
template <int D>
__device__ __forceinline__ Seed<double> q_seed(const double* q_b,
                                               const double* dm, int di,
                                               int dj, int i, int j) {
  return {sym_entry<D>(q_b, i, j), sym_entry<D>(dm + di * D * D, i, j),
          sym_entry<D>(dm + dj * D * D, i, j)};
}

// The unit's loglik and its derivatives into ll [B], grad [B, K] and (J2)
// hess [B, K, K]: entry 0 writes the value, a unit along (i, i) grad_i.
template <int kOrder>
__device__ __forceinline__ void write_jet(const Tangent<double, kOrder>& acc,
                                          int b, int e, int di, int dj,
                                          int n_dirs, double* ll,
                                          double* grad, double* hess) {
  const long long bk = static_cast<long long>(b) * n_dirs;
  if (e == 0) ll[b] = acc.v;
  if (di == dj) grad[bk + di] = acc.a;
  if constexpr (kOrder == 2) {
    hess[(bk + di) * n_dirs + dj] = acc.c;
    hess[(bk + dj) * n_dirs + di] = acc.c;
  }
}

// sum_m x(m) c(m) over m < D, left to right (kParts 1) or in two partial
// sums, the even and the odd terms, added at the end (kParts 2: a chain of
// ceil(D / 2) + 1 additions for one more instruction).
template <int D, int kParts, typename S, class X, class C>
__device__ __forceinline__ S dot_parts(X x, C c) {
  S even = x(0) * c(0);
  if constexpr (D == 1) {
    return even;
  } else if constexpr (kParts == 1) {
#pragma unroll
    for (int m = 1; m < D; ++m) even = even + x(m) * c(m);
    return even;
  } else {
    S odd = x(1) * c(1);
#pragma unroll
    for (int m = 2; m < D; m += 2) {
      even = even + x(m) * c(m);
      if (m + 1 < D) odd = odd + x(m + 1) * c(m + 1);
    }
    return even + odd;
  }
}

// One step's log density as log_density(v, f, rf) gives it, but for its
// log f value term: -0.5 (log 2 pi + v v / f) with the derivatives of
// -0.5 log f. The jets add -0.5 sum_t log f_t a chunk of steps at a time,
// whose logs (a chain of ~30 dependent operations each) then run side by
// side instead of one a step.
template <int K>
__device__ __forceinline__ Tangent<double, K> log_density_but_log(
    const Tangent<double, K>& v, const Tangent<double, K>& f,
    const Tangent<double, K>& rf) {
  Tangent<double, K> lf;
  lf.v = kLog2Pi;
  lf.a = f.a * rf.v;
  if constexpr (K == 2) {
    lf.b = f.b * rf.v;
    lf.c = f.c * rf.v - lf.a * lf.b;
  }
  return -0.5 * (lf + v * v * rf);
}

// The warp form's layout (one unit a block of one warp). Shared memory, D
// + 1 rows of kLd = D + 1 entries each: X (tangents) holds P in its first
// D rows and columns, a as row D, and T P z in column D (rows < D); Y
// (tangents) receives the products of phase 1, [P; a] [T' z] (W = P T' in
// its first D rows and columns, P z in column D, T a in row D, z'a at (D,
// D)); B (doubles) holds T in its first D rows and z as row D; z'P z goes
// to X at (D, D). A step's
// products are jobs, each a sum over m < D of a tangent row or column
// times a row of B, spread over the lanes in rounds (job lane + 32 r):
// phase 1 every (i, j) <= (D, D) of Y, X row i by B row j (kJobs1); phase
// 2 T W on P's upper triangle, W column j by B row i (the lane keeps its
// own for phase 3, where it forms the same entries of P'), then T P z,
// Y column D by B row j, and z'P z, Y column D by B row D (kJobs2).
template <int D, int kOrder>
struct JetWarp {
  using S = Tangent<double, kOrder>;
  static constexpr int kLd = D + 1;
  static constexpr int kU = D * (D + 1) / 2;
  static constexpr int kJobs1 = (D + 1) * (D + 1);
  static constexpr int kJobs2 = kU + D + 1;
  static constexpr int kRounds1 = (kJobs1 + kWarp - 1) / kWarp;
  static constexpr int kRounds2 = (kJobs2 + kWarp - 1) / kWarp;
  static constexpr int kOwnP = (kU + kWarp - 1) / kWarp;
  static constexpr int kY = (D + 1) * kLd;  // Y after X, in tangents
  static constexpr int kBytes =
      2 * kY * static_cast<int>(sizeof(S)) +
      (D + 1) * kLd * static_cast<int>(sizeof(double));
  static_assert(kBytes <= 48 * 1024, "the jets' warp layout");
};

// J1 (kOrder 1, S a dual number) and J2 (kOrder 2, a hyper-dual number) a
// warp a unit, a block one unit: the loglik of system b over series b /
// per_series of y [n_series, T] with its derivatives along the unit's
// directions (h = h0 + sum_k c_k dh_k, R Q R' = Q0 + sum_k c_k dm_k at c =
// 0; h and rqr hold h0 and Q0). Unit (b, e): in J1 entry e is direction e;
// in J2 the e-th pair (i, j), i <= j, and pair (i, i) also gives grad_i.
// Each unit carries the value chain itself, so units never exchange data.
// P is in shared memory and a step's products are spread over the lanes
// (JetWarp). A step, three __syncwarp()s:
//   1. the jobs of W = P T', P z, T a and z'a;
//   2. the jobs of T W (P's upper triangle), T P z and z'P z;
//   3. every lane forms f = z'P z + h and 1 / f (the same bits on every
//      lane) and v; P'_ij = (T W)_ij - (T P z)_i (T P z)_j / f + (R Q
//      R')_ij into both halves of P, a'_i = (T a)_i + (T P z)_i v / f;
// the symmetric step T (P - P z z'P / f) T' + R Q R' (unobserved: T P T' +
// R Q R', a' = T a), the plain version's function, (T P) L' + R Q R'
// symmetrised, with L = T - K z', K = T P z / f.
// Each sum over m (dot_parts) reads at offsets fixed at compile time from
// the job's row or column. y and the mask come a chunk
// of 32 steps at a time, a step a lane (the next chunk's loads in flight),
// and a step takes its own by a shuffle; lane s keeps step s's f and the
// chunk's 32 logs run one a lane at its end, summed by a fixed butterfly
// (the same bits on every lane).
template <int D, int kOrder>
__global__ void __launch_bounds__(kWarp)
    jet_warp_kernel(const double* __restrict__ z,
                    const double* __restrict__ tm,
                    const double* __restrict__ rqr,
                    const double* __restrict__ h,
                    const double* __restrict__ a0,
                    const double* __restrict__ p0,
                    const double* __restrict__ y,
                    const unsigned char* __restrict__ obs,
                    const double* __restrict__ dh,
                    const double* __restrict__ dm, double* __restrict__ ll,
                    double* __restrict__ grad, double* __restrict__ hess,
                    int t_len, int per_series, int n_dirs) {
  using L = JetWarp<D, kOrder>;
  using S = typename L::S;
  constexpr int kLd = L::kLd;
  // J1's sums run left to right, J2's in two partial sums: the faster of
  // the two for each at d = 4-13 (PERF.md; issue, not the chain, holds
  // them)
  constexpr int kParts = kOrder == 1 ? 1 : 2;
  auto sum = [](auto x, auto c) { return dot_parts<D, kParts, S>(x, c); };
  BOOM_SHARED_BYTES(smem_raw);
  S* xs = reinterpret_cast<S*>(smem_raw);  // P, a, T P z
  S* ys = xs + L::kY;                      // W, P z, T a, z'a
  double* bs = reinterpret_cast<double*>(ys + L::kY);  // T, z
  const int lane = threadIdx.x;
  const int entries = kOrder == 1 ? n_dirs : n_dirs * (n_dirs + 1) / 2;
  const int b = blockIdx.x / entries;
  const int e = blockIdx.x - b * entries;
  int di, dj;
  unit_directions<kOrder>(e, n_dirs, di, dj);
  const long long bd = static_cast<long long>(b) * D;
  const double* tm_b = tm + bd * D;
  const double* p0_b = p0 + bd * D;
  for (int k = lane; k < D * D; k += kWarp) {
    const int i = k / D, j = k - i * D;
    bs[i * kLd + j] = tm_b[k];
    xs[i * kLd + j] = S(sym_entry<D>(p0_b, i, j));
  }
  if (lane < D) {
    bs[D * kLd + lane] = z[bd + lane];
    xs[D * kLd + lane] = S(a0[bd + lane]);
  }
  // the lane's jobs: phase 1 (X row, B row), phase 2 (Y column, B row);
  // a lane past the last job of a round does job 0 and writes nothing
  int x1[L::kRounds1], b1[L::kRounds1], y2[L::kRounds2], b2[L::kRounds2];
#pragma unroll
  for (int r = 0; r < L::kRounds1; ++r) {
    const int k = lane + r * kWarp < L::kJobs1 ? lane + r * kWarp : 0;
    x1[r] = k / kLd;
    b1[r] = k - x1[r] * kLd;
  }
  int pi[L::kOwnP], pj[L::kOwnP];
#pragma unroll
  for (int r = 0; r < L::kRounds2; ++r) {
    const int k = lane + r * kWarp < L::kJobs2 ? lane + r * kWarp : 0;
    int i, j;
    if (k < L::kU) {  // (T W)_ij = W column j . T row i
      upper_entry<D>(k, i, j);
    } else {  // (T P z)_i = (P z) . T row i; i = D: z'P z
      i = k - L::kU;
      j = D;
    }
    y2[r] = j;
    b2[r] = i;
    if (r < L::kOwnP) {
      pi[r] = i;
      pj[r] = j;
    }
  }
  Seed<double> qv[L::kOwnP];
#pragma unroll
  for (int r = 0; r < L::kOwnP; ++r)
    qv[r] = q_seed<D>(rqr + bd * D, dm, di, dj, pi[r] < D ? pi[r] : 0,
                      pj[r] < D ? pj[r] : 0);
  const Seed<double> hh{h[b], dh[di], dh[dj]};
  const double* y_b = y + static_cast<long long>(b / per_series) * t_len;
  const S zero(0.0);
  S acc = zero;
  double log_f = 0.0;  // sum of log f over the observed steps
  double y_next = lane < t_len ? y_b[lane] : 0.0;
  int o_next = lane < t_len && (obs == nullptr || obs[lane] != 0);
  __syncwarp();  // P, a, T and z are whole
  for (int t0 = 0; t0 < t_len; t0 += kWarp) {
    const double y_mine = y_next;
    const int o_mine = o_next;
    const int tn = t0 + kWarp + lane;
    if (tn < t_len) {
      y_next = y_b[tn];
      o_next = obs == nullptr || obs[tn] != 0;
    }
    const int n = t_len - t0 < kWarp ? t_len - t0 : kWarp;
    double f_mine = 1.0;  // step lane's f (1: no step, or unobserved)
    for (int s = 0; s < n; ++s) {
      const double yt = shfl(y_mine, s);
      const bool ob = __shfl_sync(kFull, o_mine, s) != 0;
      // 1. Y = [P; a] [T' z]
#pragma unroll
      for (int r = 0; r < L::kRounds1; ++r) {
        const S* xr = xs + x1[r] * kLd;
        const double* br = bs + b1[r] * kLd;
        const S x = sum([&](int m) { return xr[m]; },
                        [&](int m) { return br[m]; });
        if (lane + r * kWarp < L::kJobs1) ys[x1[r] * kLd + b1[r]] = x;
      }
      __syncwarp();  // Y is whole; P and a are read
      // 2. T W (kept), T P z and z'P z (into X's column D)
      S tw[L::kRounds2];
#pragma unroll
      for (int r = 0; r < L::kRounds2; ++r) {
        const S* yc = ys + y2[r];
        const double* br = bs + b2[r] * kLd;
        tw[r] = sum([&](int m) { return yc[m * kLd]; },
                    [&](int m) { return br[m]; });
        if (y2[r] == D && lane + r * kWarp < L::kJobs2)
          xs[b2[r] * kLd + D] = tw[r];
      }
      __syncwarp();  // T P z and z'P z are whole; W and P z are read
      // 3. f, 1 / f, v; P' and a'
      const S f = xs[D * kLd + D] + hh;
      const S v = ob ? yt - ys[D * kLd + D] : zero;
      const S rf = reciprocal(f);
      const S rk = ob ? rf : zero;  // no gain where y_t is missing
#pragma unroll
      for (int r = 0; r < L::kOwnP; ++r) {
        const S pn = (tw[r] - (xs[pi[r] * kLd + D] * xs[pj[r] * kLd + D]) * rk)
                     + qv[r];
        if (lane + r * kWarp < L::kU) {
          xs[pi[r] * kLd + pj[r]] = pn;
          xs[pj[r] * kLd + pi[r]] = pn;
        }
      }
      if (lane < D)
        xs[D * kLd + lane] =
            ys[D * kLd + lane] + xs[lane * kLd + D] * (v * rf);
      if (ob) {
        acc = acc + log_density_but_log(v, f, rf);
        if (lane == s) f_mine = f.v;
      }
      __syncwarp();  // P' and a' are whole; T a and T P z are read
    }
    // the chunk's logs, a step a lane, summed by a fixed butterfly
    double lg = log(f_mine);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      lg = lg + shfl(lg, lane ^ off);
    log_f = log_f + lg;
  }
  acc.v = acc.v - 0.5 * log_f;
  if (lane == 0) write_jet<kOrder>(acc, b, e, di, dj, n_dirs, ll, grad, hess);
}

// ---- K1w's time-varying form: a warp a system ----------------------------

// 1 / f as reciprocal() gives it, log f as the kernels' log densities take
// it (float32: logf).
__device__ __forceinline__ float log_of(float x) { return logf(x); }
__device__ __forceinline__ double log_of(double x) { return log(x); }

// The time-varying form's layout, J1's (JetWarp) without the tangents: a
// block of one warp a system. Shared memory of the kernel's type T, D + 1
// rows of kLd = D + 1 entries each: X holds P in its first D rows and
// columns, a as row D, T P z in column D (rows < D) and z'P z at (D, D); Y
// receives phase 1's [P; a] [T' z] (W = P T' in its first D rows and
// columns, P z in column D, T a in row D, z'a at (D, D)); B holds T (rows
// < D; z_t, row D of the products, is read from the stage); then two
// stage buffers of kChunk steps, each z_t [kChunk][D], then the system's
// u_t [kChunk][D]; with the calendar's T_t, B2 (kX more) holds its second
// matrix after them. A step's products are jobs spread over the lanes in
// rounds (job lane + 32 r): phase 1 every (i, j) <= (D, D) of Y, X row i
// by [T; z_t] row j (kJobs1); phase 2 T W on P's upper triangle, T row i
// by W column j (the lane keeps its own for phase 3, where it forms the
// same entries of P'), then T P z, T row i by Y column D, and z'P z, z_t
// by Y column D (kJobs2).
template <typename T, int D>
struct TvWarp {
  static constexpr int kLd = D + 1;
  static constexpr int kU = D * (D + 1) / 2;  // P's upper triangle
  static constexpr int kJobs1 = (D + 1) * (D + 1);
  static constexpr int kJobs2 = kU + D + 1;
  static constexpr int kRounds1 = (kJobs1 + kWarp - 1) / kWarp;
  static constexpr int kRounds2 = (kJobs2 + kWarp - 1) / kWarp;
  static constexpr int kOwnP = (kU + kWarp - 1) / kWarp;
  static constexpr int kChunk = kWarp;
  static constexpr int kX = (D + 1) * kLd;
  static constexpr int kStage = 2 * kChunk * D;  // z_t, u_t of a chunk
  static constexpr int kBytes =
      (3 * kX + 2 * kStage) * static_cast<int>(sizeof(T));
  static_assert(kBytes + kX * static_cast<int>(sizeof(T)) <= 48 * 1024,
                "K1w's time-varying layout, the calendar's second T too");
};

// K1w of a time-varying system (z_t of zt [T, D], one for every system; h_t
// = h hs[t]; R Q_t R' = (u_t u_t') o R Q R', u_t of u [., T, D] at u + b
// u_stride, R a 0/1 selection): the loglik of system b (block b) over
// series b / per_series of y [n_series, T], and with vout the innovations
// v and f [B, T]; T of tm at tm + b tm_stride (0: one for every system).
// With the calendar's T_t (`sel` [T] bytes, not nullptr) two matrices lie
// there, B and B2 hold them, and step t reads the one sel[t] names (the
// same for every system), staged with y a step a lane.
// A warp a system, so that phase 8's 200 draws take 200 warps, a block
// each, and a step's work spreads over 32 lanes. A step is the symmetric
// Riccati step,
//   P' = T P T' - (T P z)(T P z)' / f + R Q_t R', a' = T a + T P z v / f,
// the plain version's (T P) L' + R Q_t R' (L = T - K z', K = T P z / f)
// symmetrised, to rounding (unobserved: T P T' + R Q_t R', T a), in three
// phases, a __syncwarp() each:
//   1. the jobs of W = P T', P z, T a and z'a;
//   2. the jobs of T W (P's upper triangle), T P z and z'P z;
//   3. every lane forms f = z'P z + h_t and 1 / f (the same bits on every
//      lane) and v; P'_ij into both halves of X, a'_i into row D.
// Each phase loads and computes before it stores: a warp alone on its
// scheduler would otherwise wait out a shared-memory load behind every
// store. z_t and the system's u_t come a chunk of 32 steps ahead by
// cp.async, double-buffered; y, the mask and h_scale a step a lane, the
// next chunk's loads in flight, taken by a shuffle. Lane s keeps step s's
// f and v: the chunk's logs of f run one a lane at its end, summed by a
// fixed butterfly (the same bits on every lane), and v and f leave as one
// row of the chunk's steps.
template <typename T, int D>
__global__ void __launch_bounds__(kWarp)
    loglik_tv_warp_kernel(const T* __restrict__ tm,
                          const T* __restrict__ rqr,
                          const T* __restrict__ h,
                          const T* __restrict__ a0,
                          const T* __restrict__ p0,
                          const T* __restrict__ y,
                          const unsigned char* __restrict__ obs,
                          const T* __restrict__ zt,
                          const T* __restrict__ hs,
                          const T* __restrict__ u, long long u_stride,
                          T* __restrict__ ll, T* __restrict__ vout,
                          T* __restrict__ fout, int t_len, int per_series,
                          int tm_stride,
                          const unsigned char* __restrict__ sel) {
  using L = TvWarp<T, D>;
  constexpr int kLd = L::kLd, kChunk = L::kChunk;
  auto sum = [](auto x, auto c) { return dot_parts<D, 2, T>(x, c); };
  BOOM_SHARED_BYTES(smem_raw);
  T* xs = reinterpret_cast<T*>(smem_raw);  // P, a, T P z, z'P z
  T* ys = xs + L::kX;                      // W, P z, T a, z'a
  T* bs = ys + L::kX;                      // T
  T* stage0 = bs + L::kX;
  T* bs2 = stage0 + 2 * L::kStage;  // the calendar's second T
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const long long bd = static_cast<long long>(b) * D;
  const T* tm_b = tm + static_cast<long long>(b) * tm_stride;
  const T* p0_b = p0 + bd * D;
  const T* q_b = rqr + bd * D;
  for (int k = lane; k < D * D; k += kWarp) {
    const int i = k / D, j = k - i * D;
    xs[i * kLd + j] = T(0.5) * (p0_b[i * D + j] + p0_b[j * D + i]);
    bs[i * kLd + j] = tm_b[k];
    if (sel != nullptr) bs2[i * kLd + j] = tm_b[D * D + k];
  }
  if (lane < D) xs[D * kLd + lane] = a0[bd + lane];
  // the lane's jobs: phase 1 (X row, [T; z] row), phase 2 (Y column, T
  // row); a lane past the last job of a round does job 0 and writes nothing
  int x1[L::kRounds1], b1[L::kRounds1], y2[L::kRounds2], b2[L::kRounds2];
#pragma unroll
  for (int r = 0; r < L::kRounds1; ++r) {
    const int k = lane + r * kWarp < L::kJobs1 ? lane + r * kWarp : 0;
    x1[r] = k / kLd;
    b1[r] = k - x1[r] * kLd;
  }
  int pi[L::kOwnP], pj[L::kOwnP];
#pragma unroll
  for (int r = 0; r < L::kRounds2; ++r) {
    const int k = lane + r * kWarp < L::kJobs2 ? lane + r * kWarp : 0;
    int i, j;
    if (k < L::kU) {  // (T W)_ij = W column j . T row i
      upper_entry<D>(k, i, j);
    } else {  // (T P z)_i = (P z) . T row i; i = D: z'P z
      i = k - L::kU;
      j = D;
    }
    y2[r] = j;
    b2[r] = i;
    if (r < L::kOwnP) {
      pi[r] = i;
      pj[r] = j;
    }
  }
  // R Q R' (symmetrised) at the lane's entries of P
  T qv[L::kOwnP];
#pragma unroll
  for (int r = 0; r < L::kOwnP; ++r) {
    const int i = pi[r] < D ? pi[r] : 0, j = pj[r] < D ? pj[r] : 0;
    qv[r] = T(0.5) * (q_b[i * D + j] + q_b[j * D + i]);
  }
  const T hh = h[b];
  const T* y_b = y + static_cast<long long>(b / per_series) * t_len;
  const T* u_b = u + static_cast<long long>(b) * u_stride;
  // z_t and u_t of the chunk from step t0 into stage buffer buf
  auto stage = [&](int t0, int buf) {
    const int n = t_len - t0 < kChunk ? t_len - t0 : kChunk;
    T* zb = stage0 + buf * L::kStage;
    T* ub = zb + kChunk * D;
    const long long at = static_cast<long long>(t0) * D;
    for (int g = lane; g < n * D; g += kWarp) {
      copy_async<sizeof(T)>(zb + g, zt + at + g);
      copy_async<sizeof(T)>(ub + g, u_b + at + g);
    }
  };
  T y_next = lane < t_len ? y_b[lane] : T(0);
  T s_next = lane < t_len ? hs[lane] : T(1);
  int o_next = lane < t_len && (obs == nullptr || obs[lane] != 0);
  int c_next = lane < t_len && sel != nullptr ? sel[lane] : 0;
  T acc(0), log_f(0);  // log f summed over the observed steps
  stage(0, 0);
  async_commit();
  __syncwarp();  // P, a and T are whole
  for (int t0 = 0, buf = 0; t0 < t_len; t0 += kChunk, buf ^= 1) {
    const T y_mine = y_next, s_mine = s_next;
    const int o_mine = o_next, c_mine = c_next;
    const int tn = t0 + kChunk + lane;
    if (tn < t_len) {
      y_next = y_b[tn];
      s_next = hs[tn];
      o_next = obs == nullptr || obs[tn] != 0;
      c_next = sel != nullptr ? sel[tn] : 0;
    }
    if (t0 + kChunk < t_len) stage(t0 + kChunk, buf ^ 1);
    async_commit();
    async_wait<1>();
    __syncwarp();  // this chunk's z_t and u_t are whole
    const T* zb = stage0 + buf * L::kStage;
    const T* ub = zb + kChunk * D;
    const int n = t_len - t0 < kChunk ? t_len - t0 : kChunk;
    T f_log(1), v_out(0), f_out(0);  // step lane's (f_log 1: no step or
                                     // unobserved)
    for (int s = 0; s < n; ++s) {
      const T yt = shfl(y_mine, s), st = shfl(s_mine, s);
      const bool ob = __shfl_sync(kFull, o_mine, s) != 0;
      const T* bt = __shfl_sync(kFull, c_mine, s) != 0 ? bs2 : bs;  // T_t
      const T* zr = zb + s * D;
      const T* ur = ub + s * D;
      // 1. Y = [P; a] [T' z]
      T y1[L::kRounds1];
#pragma unroll
      for (int r = 0; r < L::kRounds1; ++r) {
        const T* xr = xs + x1[r] * kLd;
        const T* br = b1[r] < D ? bt + b1[r] * kLd : zr;
        y1[r] = sum([&](int m) { return xr[m]; },
                    [&](int m) { return br[m]; });
      }
#pragma unroll
      for (int r = 0; r < L::kRounds1; ++r)
        if (lane + r * kWarp < L::kJobs1) ys[x1[r] * kLd + b1[r]] = y1[r];
      __syncwarp();  // Y is whole; P and a are read
      // 2. T W (kept), T P z and z'P z (into X's column D)
      T tw[L::kRounds2];
#pragma unroll
      for (int r = 0; r < L::kRounds2; ++r) {
        const T* yc = ys + y2[r];
        const T* br = b2[r] < D ? bt + b2[r] * kLd : zr;
        tw[r] = sum([&](int m) { return yc[m * kLd]; },
                    [&](int m) { return br[m]; });
      }
#pragma unroll
      for (int r = 0; r < L::kRounds2; ++r)
        if (y2[r] == D && lane + r * kWarp < L::kJobs2)
          xs[b2[r] * kLd + D] = tw[r];
      __syncwarp();  // T P z and z'P z are whole; W and P z are read
      // 3. f, 1 / f, v; P' and a': every load, then every store
      const T f = xs[D * kLd + D] + hh * st;
      const T v = ob ? yt - ys[D * kLd + D] : T(0);
      const T rf = reciprocal(f);
      const T rk = ob ? rf : T(0);  // no gain where y_t is missing
      T pn[L::kOwnP];
#pragma unroll
      for (int r = 0; r < L::kOwnP; ++r) {
        const int i = pi[r] < D ? pi[r] : 0, j = pj[r] < D ? pj[r] : 0;
        pn[r] = (tw[r] - (xs[i * kLd + D] * xs[j * kLd + D]) * rk) +
                (ur[i] * ur[j]) * qv[r];
      }
      const int ia = lane < D ? lane : 0;
      const T an = ys[D * kLd + ia] + xs[ia * kLd + D] * (v * rf);
#pragma unroll
      for (int r = 0; r < L::kOwnP; ++r) {
        if (lane + r * kWarp < L::kU) {
          xs[pi[r] * kLd + pj[r]] = pn[r];
          xs[pj[r] * kLd + pi[r]] = pn[r];
        }
      }
      if (lane < D) xs[D * kLd + lane] = an;
      if (ob) acc = acc + T(-0.5) * (T(kLog2Pi) + v * v * rf);
      if (lane == s) {
        f_log = ob ? f : T(1);
        v_out = v;
        f_out = f;
      }
      __syncwarp();  // P' and a' are whole; T a and T P z are read
    }
    // the chunk's logs, a step a lane, summed by a fixed butterfly
    T lg = log_of(f_log);
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      lg = lg + shfl(lg, lane ^ off);
    log_f = log_f + lg;
    if (vout != nullptr && lane < n) {
      const long long at = static_cast<long long>(b) * t_len + t0 + lane;
      vout[at] = v_out;
      fout[at] = f_out;
    }
  }
  if (lane == 0) ll[b] = acc - T(0.5) * log_f;
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

template <int D, int kPass, bool kTv>
cudaError_t launch_wide_pass(const void* z, const void* tm, const void* rqr,
                             const void* h, const void* p0,
                             const void* alpha1, const void* w,
                             const void* eps, const void* y, const void* obs,
                             void* scratch, void* out, int batch, int t_len,
                             const void* zt, const void* hs, const void* u,
                             long long u_stride, const void* sel,
                             long long tm_stride, int threads,
                             cudaStream_t st) {
  using S = Wide<D, kPass, kTv>;
  auto kernel = smoother_wide_kernel<D, kPass, kTv>;
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
      t_len, static_cast<const double*>(zt), static_cast<const double*>(hs),
      static_cast<const double*>(u), u_stride,
      static_cast<const unsigned char*>(sel), tm_stride);
  return cudaGetLastError();
}

// K2w's three passes, one launch each on the stream (each reads what the
// one before it wrote).
template <int D, bool kTv>
int launch_smoother_wide(const void* z, const void* tm, const void* rqr,
                         const void* h, const void* p0, const void* alpha1,
                         const void* w, const void* eps, const void* y,
                         const void* obs, void* scratch, void* out,
                         int batch, int t_len, const void* zt, const void* hs,
                         const void* u, long long u_stride, const void* sel,
                         long long tm_stride, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_wide_pass<D, 1, kTv>(
      z, tm, rqr, h, p0, alpha1, w, eps, y, obs, scratch, out, batch, t_len,
      zt, hs, u, u_stride, sel, tm_stride, threads, st);
  if (err == cudaSuccess)
    err = launch_wide_pass<D, 2, kTv>(z, tm, rqr, h, p0, alpha1, w, eps, y,
                                      obs, scratch, out, batch, t_len, zt, hs,
                                      u, u_stride, sel, tm_stride, threads,
                                      st);
  if (err == cudaSuccess)
    err = launch_wide_pass<D, 3, kTv>(z, tm, rqr, h, p0, alpha1, w, eps, y,
                                      obs, scratch, out, batch, t_len, zt, hs,
                                      u, u_stride, sel, tm_stride, threads,
                                      st);
  return static_cast<int>(err);
}

// T's non-zeros from its CSR form (rowptr [d + 1], cols and vals of row r
// at [rowptr[r], rowptr[r + 1])) as the structured form's NzT: of T, or
// with `transpose` of T'. False where the CSR is not one of a d x d matrix
// (a column out of range or twice in a row).
bool nz_of(NzT* out, int d, const int* rowptr, const int* cols,
           const double* vals, bool transpose) {
  if (d < 1 || d > kMaxNzD || rowptr[0] != 0) return false;
  bool seen[kMaxNzD][kMaxNzD] = {};
  double tm[kMaxNzD][kMaxNzD] = {};
  for (int r = 0; r < d; ++r) {
    if (rowptr[r + 1] < rowptr[r] || rowptr[r + 1] > d * d) return false;
    for (int k = rowptr[r]; k < rowptr[r + 1]; ++k) {
      const int col = cols[k];
      if (col < 0 || col >= d || seen[r][col]) return false;
      seen[r][col] = true;
      tm[r][col] = vals[k];
    }
  }
  std::memset(out, 0, sizeof(NzT));
  int k = 0;
  for (int r = 0; r < d; ++r) {
    bool first = true;
    out->obeg[r] = static_cast<unsigned char>(k);
    for (int col = 0; col < d; ++col) {
      const int a = transpose ? col : r, b = transpose ? r : col;
      if (!seen[a][b]) continue;
      if (first) {
        out->pcol[r] = static_cast<unsigned char>(col);
        out->pval[r] = tm[a][b];
        first = false;
      } else {
        out->orow[k] = static_cast<unsigned char>(r);
        out->ocol[k] = static_cast<unsigned char>(col);
        out->oval[k] = tm[a][b];
        ++k;
      }
    }
  }
  for (int r = d; r <= kMaxNzD; ++r)
    out->obeg[r] = static_cast<unsigned char>(k);
  return true;
}

template <int D, int kPass>
cudaError_t launch_nz_pass(const NzT& nz, const void* rqr, const void* h,
                           const void* p0, const void* alpha1, const void* w,
                           const void* eps, const void* y, const void* obs,
                           void* scratch, void* out, int batch, int t_len,
                           const void* zt, const void* hs, const void* u,
                           long long u_stride, int threads,
                           cudaStream_t st) {
  using S = WideNz<D, kPass>;
  auto kernel = smoother_wide_nz_kernel<D, kPass>;
  static const cudaError_t attr = allow_shared(kernel, S::kBlockBytes);
  if (attr != cudaSuccess) return attr;
  const int chains = threads / kWarp * S::kPerWarp;
  const int blocks = (batch + chains - 1) / chains;
  kernel<<<blocks, threads, (chains * S::kDoubles + S::kBlk) * 8, st>>>(
      nz, static_cast<const double*>(rqr), static_cast<const double*>(h),
      static_cast<const double*>(p0), static_cast<const double*>(alpha1),
      static_cast<const double*>(w), static_cast<const double*>(eps),
      static_cast<const double*>(y), static_cast<const unsigned char*>(obs),
      static_cast<double*>(scratch), static_cast<double*>(out), batch,
      t_len, static_cast<const double*>(zt), static_cast<const double*>(hs),
      static_cast<const double*>(u), u_stride);
  return cudaGetLastError();
}

// K2w's structured time-varying form: its three passes, T's non-zeros in
// passes 1 and 3, T''s in pass 2.
template <int D>
int launch_smoother_wide_nz(const NzT& t_nz, const NzT& tt_nz,
                            const void* rqr, const void* h, const void* p0,
                            const void* alpha1, const void* w,
                            const void* eps, const void* y, const void* obs,
                            void* scratch, void* out, int batch, int t_len,
                            const void* zt, const void* hs, const void* u,
                            long long u_stride, int threads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_nz_pass<D, 1>(
      t_nz, rqr, h, p0, alpha1, w, eps, y, obs, scratch, out, batch, t_len,
      zt, hs, u, u_stride, threads, st);
  if (err == cudaSuccess)
    err = launch_nz_pass<D, 2>(tt_nz, rqr, h, p0, alpha1, w, eps, y, obs,
                               scratch, out, batch, t_len, zt, hs, u,
                               u_stride, threads, st);
  if (err == cudaSuccess)
    err = launch_nz_pass<D, 3>(t_nz, rqr, h, p0, alpha1, w, eps, y, obs,
                               scratch, out, batch, t_len, zt, hs, u,
                               u_stride, threads, st);
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

// K1w's group kernel over `batch` systems: one launch.
template <typename T, int D>
int launch_wide_loglik(const void* z, const void* tm, const void* rqr,
                       const void* h, const void* a0, const void* p0,
                       const void* y, const void* obs, void* ll, void* vout,
                       void* fout, int batch, int t_len, int n_series,
                       int tm_stride, int z_stride, int threads,
                       void* stream) {
  using L = WideLoglik<T, D>;
  auto kernel = wide_loglik_kernel<T, D>;
  static const cudaError_t attr = allow_shared(kernel, L::kMaxBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int per_block = threads / kWarp * L::kPerWarp;
  const long long blocks =
      (static_cast<long long>(batch) + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(blocks);
  const int bytes = per_block * L::kUnitBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, threads, bytes, st>>>(
      static_cast<const T*>(z), static_cast<const T*>(tm),
      static_cast<const T*>(rqr), static_cast<const T*>(h),
      static_cast<const T*>(a0), static_cast<const T*>(p0),
      static_cast<const T*>(y), static_cast<const unsigned char*>(obs),
      static_cast<T*>(ll), static_cast<T*>(vout), static_cast<T*>(fout),
      batch, t_len, batch / n_series, tm_stride, z_stride);
  return static_cast<int>(cudaGetLastError());
}

// K1w's thread kernel over `batch` systems: one launch, one warp a block;
// a T shared by every system goes to the constant bank first.
template <int D, bool kSharedT>
int launch_thread_loglik(const void* z, const void* tm, const void* rqr,
                         const void* h, const void* a0, const void* p0,
                         const void* y, const void* obs, void* ll, void* vout,
                         void* fout, int batch, int t_len, int n_series,
                         int z_stride, void* stream) {
  using L = ThreadLoglik<D, kSharedT>;
  auto kernel = loglik_thread_kernel<D, kSharedT>;
  static const cudaError_t attr = allow_shared(kernel, L::bytes(true));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (kSharedT) {
    const cudaError_t err =
        cudaMemcpyToSymbolAsync(c_tm, tm, D * D * sizeof(float), 0,
                                cudaMemcpyDeviceToDevice, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (batch + kWarp - 1) / kWarp;
  kernel<<<blocks, kWarp, L::bytes(vout != nullptr), st>>>(
      static_cast<const float*>(z), static_cast<const float*>(tm),
      static_cast<const float*>(rqr), static_cast<const float*>(h),
      static_cast<const float*>(a0), static_cast<const float*>(p0),
      static_cast<const float*>(y), static_cast<const unsigned char*>(obs),
      static_cast<float*>(ll), static_cast<float*>(vout),
      static_cast<float*>(fout), batch, t_len, batch / n_series, z_stride);
  return static_cast<int>(cudaGetLastError());
}

// K1w's layout bits: T is one [d, d] matrix of every system, z one [d]
// vector (a stride-0 field of the wrapper's)
constexpr int kSharedTm = 1, kSharedZ = 2;

template <typename T, int D>
int launch_loglik_wide(const void* z, const void* tm, const void* rqr,
                       const void* h, const void* a0, const void* p0,
                       const void* y, const void* obs, void* ll, void* vout,
                       void* fout, int batch, int t_len, int n_series,
                       int shared, int threads, void* stream) {
  const int tm_stride = shared & kSharedTm ? 0 : D * D;
  const int z_stride = shared & kSharedZ ? 0 : D;
  if constexpr (sizeof(T) == 4 && D <= kThreadLoglikMaxD) {
    return tm_stride == 0
               ? launch_thread_loglik<D, true>(z, tm, rqr, h, a0, p0, y, obs,
                                               ll, vout, fout, batch, t_len,
                                               n_series, z_stride, stream)
               : launch_thread_loglik<D, false>(z, tm, rqr, h, a0, p0, y, obs,
                                                ll, vout, fout, batch, t_len,
                                                n_series, z_stride, stream);
  } else {
    return launch_wide_loglik<T, D>(z, tm, rqr, h, a0, p0, y, obs, ll, vout,
                                    fout, batch, t_len, n_series, tm_stride,
                                    z_stride, threads, stream);
  }
}

bool bad_series(int batch, int t_len, int n_series, int threads) {
  return batch < 0 || t_len < 1 || n_series < 1 || bad_block(threads) ||
         (batch > 0 && batch % n_series != 0);
}

template <typename T>
int dispatch_loglik_wide(const void* z, const void* tm, const void* rqr,
                         const void* h, const void* a0, const void* p0,
                         const void* y, const void* obs, void* ll,
                         void* vout, void* fout, int batch, int t_len,
                         int n_series, int d, int shared, int threads,
                         void* stream) {
  if (bad_series(batch, t_len, n_series, threads) ||
      (vout == nullptr) != (fout == nullptr) ||
      (shared & ~(kSharedTm | kSharedZ)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  switch (d) {
#define BOOM_LOGLIK_WIDE_CASE(D)                                            \
  case D:                                                                   \
    return launch_loglik_wide<T, D>(z, tm, rqr, h, a0, p0, y, obs, ll,      \
                                    vout, fout, batch, t_len, n_series,     \
                                    shared, threads, stream);
    BOOM_LOGLIK_WIDE_CASE(7) BOOM_LOGLIK_WIDE_CASE(8)
    BOOM_LOGLIK_WIDE_CASE(9) BOOM_LOGLIK_WIDE_CASE(10)
    BOOM_LOGLIK_WIDE_CASE(11) BOOM_LOGLIK_WIDE_CASE(12)
    BOOM_LOGLIK_WIDE_CASE(13) BOOM_LOGLIK_WIDE_CASE(14)
    BOOM_LOGLIK_WIDE_CASE(15) BOOM_LOGLIK_WIDE_CASE(16)
#undef BOOM_LOGLIK_WIDE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K1w of a time-varying system over `batch` systems: one launch, a block
// (one warp) a system.
template <typename T, int D>
int launch_tv_warp(const void* tm, const void* rqr, const void* h,
                   const void* a0, const void* p0, const void* y,
                   const void* obs, const void* zt, const void* hs,
                   const void* u, long long u_stride, void* ll, void* vout,
                   void* fout, int batch, int t_len, int n_series,
                   int tm_stride, const void* sel, void* stream) {
  auto kernel = loglik_tv_warp_kernel<T, D>;
  const int bytes =
      TvWarp<T, D>::kBytes +
      (sel != nullptr ? TvWarp<T, D>::kX * static_cast<int>(sizeof(T)) : 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<batch, kWarp, bytes, st>>>(
      static_cast<const T*>(tm), static_cast<const T*>(rqr),
      static_cast<const T*>(h), static_cast<const T*>(a0),
      static_cast<const T*>(p0), static_cast<const T*>(y),
      static_cast<const unsigned char*>(obs), static_cast<const T*>(zt),
      static_cast<const T*>(hs), static_cast<const T*>(u), u_stride,
      static_cast<T*>(ll), static_cast<T*>(vout), static_cast<T*>(fout),
      t_len, batch / n_series, tm_stride,
      static_cast<const unsigned char*>(sel));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_loglik_wide_tv(const void* tm, const void* rqr, const void* h,
                            const void* a0, const void* p0, const void* y,
                            const void* obs, const void* zt, const void* hs,
                            const void* u, const void* sel, void* ll,
                            void* vout, void* fout, int batch, int t_len,
                            int n_series, int d, int shared,
                            long long u_stride, void* stream) {
  if (batch < 0 || t_len < 1 || n_series < 1 ||
      (batch > 0 && batch % n_series != 0) ||
      (vout == nullptr) != (fout == nullptr) || u_stride < 0 ||
      (shared & ~kSharedTm) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int tm_stride =
      shared & kSharedTm ? 0 : (sel != nullptr ? 2 : 1) * d * d;
  switch (d) {
#define BOOM_LOGLIK_WIDE_TV_CASE(D)                                         \
  case D:                                                                   \
    return launch_tv_warp<T, D>(tm, rqr, h, a0, p0, y, obs, zt, hs, u,      \
                                u_stride, ll, vout, fout, batch, t_len,     \
                                n_series, tm_stride, sel, stream);
    BOOM_LOGLIK_WIDE_TV_CASE(7) BOOM_LOGLIK_WIDE_TV_CASE(8)
    BOOM_LOGLIK_WIDE_TV_CASE(9) BOOM_LOGLIK_WIDE_TV_CASE(10)
    BOOM_LOGLIK_WIDE_TV_CASE(11) BOOM_LOGLIK_WIDE_TV_CASE(12)
    BOOM_LOGLIK_WIDE_TV_CASE(13) BOOM_LOGLIK_WIDE_TV_CASE(14)
    BOOM_LOGLIK_WIDE_TV_CASE(15) BOOM_LOGLIK_WIDE_TV_CASE(16)
#undef BOOM_LOGLIK_WIDE_TV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// J1 or J2 over `batch` systems: one launch, a block (one warp) a unit.
template <int D, int kOrder>
int launch_jet(const void* z, const void* tm, const void* rqr, const void* h,
               const void* a0, const void* p0, const void* y, const void* obs,
               const void* dh, const void* dm, void* ll, void* grad,
               void* hess, int batch, int t_len, int n_series, int n_dirs,
               void* stream) {
  const long long units =
      static_cast<long long>(batch) *
      (kOrder == 1 ? n_dirs : n_dirs * (n_dirs + 1) / 2);
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = jet_warp_kernel<D, kOrder>;
  const int grid = static_cast<int>(units);
  const int bytes = JetWarp<D, kOrder>::kBytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kWarp, bytes, st>>>(
      static_cast<const double*>(z), static_cast<const double*>(tm),
      static_cast<const double*>(rqr), static_cast<const double*>(h),
      static_cast<const double*>(a0), static_cast<const double*>(p0),
      static_cast<const double*>(y), static_cast<const unsigned char*>(obs),
      static_cast<const double*>(dh), static_cast<const double*>(dm),
      static_cast<double*>(ll), static_cast<double*>(grad),
      static_cast<double*>(hess), t_len, batch / n_series, n_dirs);
  return static_cast<int>(cudaGetLastError());
}

template <int kOrder>
int dispatch_jet(const void* z, const void* tm, const void* rqr,
                 const void* h, const void* a0, const void* p0,
                 const void* y, const void* obs, const void* dh,
                 const void* dm, void* ll, void* grad, void* hess, int batch,
                 int t_len, int n_series, int d, int n_dirs, void* stream) {
  switch (d) {
#define BOOM_JET_CASE(D)                                                    \
  case D:                                                                   \
    return launch_jet<D, kOrder>(z, tm, rqr, h, a0, p0, y, obs, dh, dm, ll, \
                                 grad, hess, batch, t_len, n_series, n_dirs,\
                                 stream);
    BOOM_JET_CASE(1) BOOM_JET_CASE(2) BOOM_JET_CASE(3) BOOM_JET_CASE(4)
    BOOM_JET_CASE(5) BOOM_JET_CASE(6) BOOM_JET_CASE(7) BOOM_JET_CASE(8)
    BOOM_JET_CASE(9) BOOM_JET_CASE(10) BOOM_JET_CASE(11) BOOM_JET_CASE(12)
    BOOM_JET_CASE(13) BOOM_JET_CASE(14) BOOM_JET_CASE(15) BOOM_JET_CASE(16)
#undef BOOM_JET_CASE
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
// aligned; 1 <= d <= 16. K1w (7 <= d <= 16) and the jets (float64, 1 <= d
// <= 16): z, tm, rqr, h, a0 [B, d], p0 as K2w's; y [S, T] (S = n_series,
// dividing B: system b reads series b / (B / S)), obs [T] bytes or nullptr;
// ll [B]; K1w's vout and fout [B, T] (both nullptr: no innovations) and
// its `shared` bits: kSharedTm, tm is one [d, d] matrix of every system;
// kSharedZ, z is one [d] vector; the jets' directions dh [K] and dm [K, d,
// d] (1 <= K <= kMaxDirections), grad [B, K], hess [B, K, K] (order 2).
// threads: a multiple of 32 up to 128 (K1w's thread kernel and the jets
// take blocks of one warp whatever it is). stream: a cudaStream_t. Returns the
// cudaError_t of the launch (0 = success).
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
    return launch_smoother_wide<D, false>(z, tm, rqr, h, p0, alpha1, w, eps, \
                                          y, obs, scratch, out, batch, t_len,\
                                          nullptr, nullptr, nullptr, 0,     \
                                          nullptr, D * D, threads, stream);
    BOOM_WIDE_CASE(7) BOOM_WIDE_CASE(8) BOOM_WIDE_CASE(9) BOOM_WIDE_CASE(10)
    BOOM_WIDE_CASE(11) BOOM_WIDE_CASE(12) BOOM_WIDE_CASE(13)
    BOOM_WIDE_CASE(14) BOOM_WIDE_CASE(15) BOOM_WIDE_CASE(16)
#undef BOOM_WIDE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2w of a time-varying system (smoother_wide_kernel<D, pass, true>): the
// static entry's arrays without z, then zt [T, d] (one z_t for every
// chain), hs [T] (h_t = h hs[t]) and u [U, T, d] with u_stride = T d (U =
// B) or 0 (U = 1), R a 0/1 selection with at most one 1 a row. sel
// nullptr: tm [B, d, d], a chain's T, or one [d, d] of every chain with
// `shared` 1; the calendar's T_t: sel [T] bytes (0 or 1), step t takes
// matrix sel[t] of tm [B, 2, d, d], or of [2, d, d] with `shared` 1.
extern "C" int boom_kalman_smoother_wide_tv_f64(
    const void* tm, const void* rqr, const void* h, const void* p0,
    const void* alpha1, const void* w, const void* eps, const void* y,
    const void* obs, const void* zt, const void* hs, const void* u,
    const void* sel, void* scratch, void* out, int batch, int t_len,
    long long u_stride, int shared, int d, int threads, void* stream) {
  if (batch < 0 || t_len < 1 || bad_block(threads) || u_stride < 0 ||
      (shared & ~1) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long tm_stride =
      shared ? 0 : static_cast<long long>(sel != nullptr ? 2 : 1) * d * d;
  switch (d) {
#define BOOM_WIDE_TV_CASE(D)                                                \
  case D:                                                                   \
    return launch_smoother_wide<D, true>(nullptr, tm, rqr, h, p0, alpha1, w,\
                                         eps, y, obs, scratch, out, batch,  \
                                         t_len, zt, hs, u, u_stride, sel,   \
                                         tm_stride, threads, stream);
    BOOM_WIDE_TV_CASE(7) BOOM_WIDE_TV_CASE(8) BOOM_WIDE_TV_CASE(9)
    BOOM_WIDE_TV_CASE(10) BOOM_WIDE_TV_CASE(11) BOOM_WIDE_TV_CASE(12)
    BOOM_WIDE_TV_CASE(13) BOOM_WIDE_TV_CASE(14) BOOM_WIDE_TV_CASE(15)
    BOOM_WIDE_TV_CASE(16)
#undef BOOM_WIDE_TV_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2w's structured time-varying form (smoother_wide_nz_kernel<D, pass>),
// where every chain shares one T: the time-varying entry's arrays without
// tm, then T's non-zeros in CSR form, host arrays read before the launch
// (rowptr [d + 1] ints, cols ints and vals doubles of row r at
// [rowptr[r], rowptr[r + 1])).
extern "C" int boom_kalman_smoother_wide_nz_f64(
    const void* rqr, const void* h, const void* p0, const void* alpha1,
    const void* w, const void* eps, const void* y, const void* obs,
    const void* zt, const void* hs, const void* u, void* scratch, void* out,
    const void* rowptr, const void* cols, const void* vals, int batch,
    int t_len, long long u_stride, int d, int threads, void* stream) {
  if (batch < 0 || t_len < 1 || bad_block(threads) || u_stride < 0 ||
      rowptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  NzT t_nz, tt_nz;
  const int* rp = static_cast<const int*>(rowptr);
  const int* cl = static_cast<const int*>(cols);
  const double* vl = static_cast<const double*>(vals);
  if (!nz_of(&t_nz, d, rp, cl, vl, false) ||
      !nz_of(&tt_nz, d, rp, cl, vl, true))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  switch (d) {
#define BOOM_WIDE_NZ_CASE(D)                                                \
  case D:                                                                   \
    return launch_smoother_wide_nz<D>(t_nz, tt_nz, rqr, h, p0, alpha1, w,   \
                                      eps, y, obs, scratch, out, batch,     \
                                      t_len, zt, hs, u, u_stride, threads,  \
                                      stream);
    BOOM_WIDE_NZ_CASE(7) BOOM_WIDE_NZ_CASE(8) BOOM_WIDE_NZ_CASE(9)
    BOOM_WIDE_NZ_CASE(10) BOOM_WIDE_NZ_CASE(11) BOOM_WIDE_NZ_CASE(12)
    BOOM_WIDE_NZ_CASE(13) BOOM_WIDE_NZ_CASE(14) BOOM_WIDE_NZ_CASE(15)
    BOOM_WIDE_NZ_CASE(16)
#undef BOOM_WIDE_NZ_CASE
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

extern "C" int boom_kalman_loglik_wide_f32(
    const void* z, const void* tm, const void* rqr, const void* h,
    const void* a0, const void* p0, const void* y, const void* obs, void* ll,
    void* vout, void* fout, int batch, int t_len, int n_series, int d,
    int shared, int threads, void* stream) {
  return dispatch_loglik_wide<float>(z, tm, rqr, h, a0, p0, y, obs, ll, vout,
                                     fout, batch, t_len, n_series, d, shared,
                                     threads, stream);
}

extern "C" int boom_kalman_loglik_wide_f64(
    const void* z, const void* tm, const void* rqr, const void* h,
    const void* a0, const void* p0, const void* y, const void* obs, void* ll,
    void* vout, void* fout, int batch, int t_len, int n_series, int d,
    int shared, int threads, void* stream) {
  return dispatch_loglik_wide<double>(z, tm, rqr, h, a0, p0, y, obs, ll,
                                      vout, fout, batch, t_len, n_series, d,
                                      shared, threads, stream);
}

// K1w of a time-varying system (loglik_tv_warp_kernel): K1w's arrays
// without z, then zt [T, d], hs [T], u [U, T, d] and sel as
// boom_kalman_smoother_wide_tv_f64 takes them (the calendar's two
// matrices a system, or two for all with kSharedTm); `shared` may hold
// kSharedTm alone.
extern "C" int boom_kalman_loglik_wide_tv_f32(
    const void* tm, const void* rqr, const void* h, const void* a0,
    const void* p0, const void* y, const void* obs, const void* zt,
    const void* hs, const void* u, const void* sel, void* ll, void* vout,
    void* fout, int batch, int t_len, int n_series, int d, int shared,
    long long u_stride, void* stream) {
  return dispatch_loglik_wide_tv<float>(tm, rqr, h, a0, p0, y, obs, zt, hs,
                                        u, sel, ll, vout, fout, batch, t_len,
                                        n_series, d, shared, u_stride,
                                        stream);
}

extern "C" int boom_kalman_loglik_wide_tv_f64(
    const void* tm, const void* rqr, const void* h, const void* a0,
    const void* p0, const void* y, const void* obs, const void* zt,
    const void* hs, const void* u, const void* sel, void* ll, void* vout,
    void* fout, int batch, int t_len, int n_series, int d, int shared,
    long long u_stride, void* stream) {
  return dispatch_loglik_wide_tv<double>(tm, rqr, h, a0, p0, y, obs, zt, hs,
                                         u, sel, ll, vout, fout, batch, t_len,
                                         n_series, d, shared, u_stride,
                                         stream);
}

extern "C" int boom_kalman_jet_f64(
    const void* z, const void* tm, const void* rqr, const void* h,
    const void* a0, const void* p0, const void* y, const void* obs,
    const void* dh, const void* dm, void* ll, void* grad, void* hess,
    int batch, int t_len, int n_series, int d, int n_dirs, int order,
    int threads, void* stream) {
  if (bad_series(batch, t_len, n_series, threads) || n_dirs < 1 ||
      n_dirs > kMaxDirections || (order != 1 && order != 2) ||
      (order == 2) != (hess != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  return order == 1
             ? dispatch_jet<1>(z, tm, rqr, h, a0, p0, y, obs, dh, dm, ll,
                               grad, hess, batch, t_len, n_series, d, n_dirs,
                               stream)
             : dispatch_jet<2>(z, tm, rqr, h, a0, p0, y, obs, dh, dm, ll,
                               grad, hess, batch, t_len, n_series, d, n_dirs,
                               stream);
}

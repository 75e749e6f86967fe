// Sequential Kalman recurrences for many short series, hand-written for
// Hopper (sm_90a): one thread per series walks the T steps.
//
// Replaces the reference's XLA time scans (not Pallas kernels):
//   K1 `loglik_kernel`: boom_tpu/statespace/kalman.py `kalman_loglik`
//      (:229, its lax.scan at :282), the marginal likelihood of every
//      (chain, TIM candidate) series, d <= 6 (kalman_wide.cu's K1w takes
//      7 <= d <= 16, and its J1 and J2 the loglik's derivatives).
//   K2 `smoother_kernel`: the fused static `simulation_smoother`
//      (kalman.py:438-481, lax.scan at :476) plus `_smoother_passes`
//      (:289-350, scans at :322 and :349): the unconditional simulation
//      fused into the filter on y - y+, the backward r pass and the forward
//      state pass, in one launch; the draw is alpha+ + E_0[alpha | y - y+].
// The plain PyTorch versions are boom_tpu_torch/statespace/kalman.py.
//
// What bounds them on this card. Each series is a chain of T dependent
// steps of d x d algebra (4d^3 + 8d^2 + 3d flops a filter step).
//
// K1 at the bsts_llt shape (4096 chains x 17 = 69,632 series, T=500, d=2,
// float32) is bound by instruction issue: 2,176 warps over the 528 warp
// schedulers of 132 SMs put 5 warps on the busiest one, and one warp's
// step is ~150 instructions in the first version (NVIDIA H100 80GB HBM3,
// 700 W: 0.114 ms at 1/16 of the batch, 0.130 at 1/4, 0.218 at all of it;
// PERF.md, Findings). So the step is cut to fewer instructions:
// y (and the mask) are staged in shared memory once a block, the mask has
// an instantiation of its own so that observed=None runs no selects, the
// symmetrization touches the upper triangle only (p_ii = pn_ii is
// 0.5 (pn_ii + pn_ii) exactly), and in float32 one correctly rounded
// reciprocal of f serves K = T P z / f and v^2 / f while log f is the
// SFU's __logf (float64 keeps the reference's divisions and log). The
// grid is laid out from the card's SM count, one block of
// ceil(B / SMs) threads an SM.
//
// K2 (4096 chains, float64) has one thread a chain, so 32 chains (one
// warp) an SM: it is latency bound. Its first version waited on a global
// load at every step of its three passes (0.61 ms for one warp on the
// whole card; 1.03 ms at 4096 chains, where the 65 MB scratch and 33 MB of
// draws no longer fit the 50 MB L2). Now every per-step stream is staged
// into shared memory a chunk of kChunk = 32 steps ahead of use with 8-byte
// cp.async, double-buffered: w and eps in pass 1, the scratch slots in
// reverse chunks in pass 2, the slots (r) and w in pass 3, plus y and the
// mask (lane l stages step t0 + l). The warp stages and writes each
// chain's rows together, 32 consecutive doubles of one row a copy or a
// store, through a buffer that holds element e of lane c's chain at
// [e * 33 + c] (a lane's step reads 32 consecutive doubles; a row copy
// strides 33, so neither side has bank conflicts). Pass 1 takes one
// correctly rounded reciprocal of f a step for K and v/f, where three f64
// divisions ran one after another, and stores (v/f, K), a slot of D + 1;
// pass 2 has no division and overwrites a slot's first D with r_{t-1};
// pass 3 regenerates alpha+ from alpha_1 and w with pass 1's operations
// and writes alpha+ + alpha-hat once, so the draw is written once. What is
// left is pass 1's f64 Riccati chain a step (PERF.md, Findings). The
// time-varying form (`smoother_kernel<D, true>`) stages its streams the
// same way: u_t's rows beside w in passes 1 and 3 (u_{t-1} in pass 3), z_t
// and h_scale a lane a step beside y and the mask, read by every lane at
// one address; its pass 3 holds 3 D + 1 doubles a step, so past d = 4 it
// stages 16 steps a chunk (SmootherSmem). K1's time-varying form
// (`loglik_tv_kernel`, phase 8's 200 draws at d = 4: seven warps on the
// card, each thread a chain of 500 dependent steps) stages z_t, h_scale,
// each system's u_t and y and the mask the same way, a chunk of 32 steps
// ahead, runs the symmetric Riccati step on P's upper triangle in
// registers (as K1w's thread kernel) and writes v and f a chunk at a time.
//
// Design. The state (a, P, the loglik) lives in registers; d is a template
// parameter (1..6), unrolled at compile time. The operation order is the
// reference's step for step: v = y - z'a, pz = P z, f = z'pz + h,
// K = (T pz) / f, L = T - K z', a' = T a + K v, P' = (T P) L' + RQR, then
// 0.5 (P' + P'^T); the `observed` mask zeroes v and K as `where(obs, ...,
// 0)` does. So K1's float64 results match the plain version to rounding
// (FMA contraction aside); K2 differs by its reciprocal of f (~1e-16
// relative a step), float32 K1 by its reciprocal and __logf, within the
// 1e-9 (float64) and 1e-4 (float32) normwise tolerances (PERF.md). No
// value is reduced across threads, so repeated launches are bit-identical.
// Layout: the systems are per series ([B, d], [B, d, d], [B]); the
// observed mask [T] is shared by all series, and so is y [T] in K2 and in
// K1 with one series; K1 also takes a series per group of systems, y [S, T]
// (bsts with a regression: y - X beta of each chain, its TIM points the
// group). K2's per-step streams are chain-major [C, T, ...] rows (a
// time-major staging was measured no faster: PERF.md, Findings).


#include <climits>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)

// The correctly rounded reciprocal.
__device__ __forceinline__ float reciprocal(float x) { return __frcp_rn(x); }
__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

// One filter step of the reference's `step_core` (kalman.py:171-187) on the
// predicted (a, P), in place: returns v and f, writes K into k. kRecip:
// K = T P z * (1 / f) with one correctly rounded reciprocal, returned in
// rf (K2, and K1 in float32), in place of the reference's d divisions,
// which the card runs one after another (each is a branchy sequence); else
// K = T P z / f (K1 in float64).
template <typename T, int D, bool kRecip>
__device__ __forceinline__ void filter_step(T (&a)[D], T (&p)[D][D], T yt,
                                            bool obs, const T (&z)[D], T h,
                                            const T (&rqr)[D][D],
                                            const T (&tm)[D][D], T& v, T& f,
                                            T (&k)[D], T& rf) {
  const T zero(0);
  T za = z[0] * a[0];
#pragma unroll
  for (int j = 1; j < D; ++j) za = za + z[j] * a[j];
  v = obs ? yt - za : zero;
  T pz[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    pz[i] = p[i][0] * z[0];
#pragma unroll
    for (int j = 1; j < D; ++j) pz[i] = pz[i] + p[i][j] * z[j];
  }
  T zpz = z[0] * pz[0];
#pragma unroll
  for (int j = 1; j < D; ++j) zpz = zpz + z[j] * pz[j];
  f = zpz + h;
  if constexpr (kRecip) rf = reciprocal(f);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T tpz = tm[i][0] * pz[0];
#pragma unroll
    for (int j = 1; j < D; ++j) tpz = tpz + tm[i][j] * pz[j];
    if constexpr (kRecip) {
      k[i] = obs ? tpz * rf : zero;
    } else {
      k[i] = obs ? tpz / f : zero;
    }
  }
  T an[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T ta = tm[i][0] * a[0];
#pragma unroll
    for (int j = 1; j < D; ++j) ta = ta + tm[i][j] * a[j];
    an[i] = ta + k[i] * v;
  }
  // P' = (T P) L' + RQR with L = T - K z', then symmetrized
  T tp[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      tp[i][j] = tm[i][0] * p[0][j];
#pragma unroll
      for (int m = 1; m < D; ++m) tp[i][j] = tp[i][j] + tm[i][m] * p[m][j];
    }
  }
  T l[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) l[i][j] = tm[i][j] - k[i] * z[j];
  }
  T pn[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = tp[i][0] * l[j][0];
#pragma unroll
      for (int m = 1; m < D; ++m) acc = acc + tp[i][m] * l[j][m];
      pn[i][j] = acc + rqr[i][j];
    }
  }
  // 0.5 (pn + pn') on the upper triangle, mirrored; on the diagonal it is
  // pn_ii exactly
#pragma unroll
  for (int i = 0; i < D; ++i) {
    a[i] = an[i];
    p[i][i] = pn[i][i];
#pragma unroll
    for (int j = i + 1; j < D; ++j) {
      p[i][j] = T(0.5) * (pn[i][j] + pn[j][i]);
      p[j][i] = p[i][j];
    }
  }
}

// One step's log density: where(obs, -0.5 (log 2 pi + log f + v v / f), 0)
// without the where. kFast (K1 in float32): v v (1 / f) and the SFU's
// __logf; else the reference's division and log.
template <typename T, bool kFast>
__device__ __forceinline__ T log_density(T v, T f, T rf) {
  if constexpr (kFast) {
    return T(-0.5) * ((T(kLog2Pi) + __logf(f)) + v * v * rf);
  } else {
    return T(-0.5) * ((T(kLog2Pi) + log(f)) + v * v / f);
  }
}

// ---- staging -------------------------------------------------------------

// The block's dynamic shared memory, 16-byte aligned.
#ifndef BOOM_SHARED_BYTES
#define BOOM_SHARED_BYTES(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

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

// 4-byte asynchronous copy of which the first `bytes` (1..4) are read and
// the rest zero-filled.
__device__ __forceinline__ void copy4_async(void* smem, const void* gmem,
                                            int bytes) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes)
               : "memory");
#else
  std::memset(smem, 0, 4);
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

// ---- K1 ------------------------------------------------------------------

// Steps of y (and of the mask) a block stages in shared memory at a time.
constexpr int kYChunk = 1024;

// K1: steps [t0, t0 + n) of the shared series y (kShared) and of the mask
// (kMasked; nullptr read as all observed) into the block's shared memory
// ys, os.
template <typename T, bool kMasked, bool kShared>
__device__ __forceinline__ void stage_y_chunk(T* ys, unsigned char* os,
                                             const T* y,
                                             const unsigned char* obs,
                                             int t0, int n) {
  __syncthreads();  // the block is done with the previous chunk
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (kShared) ys[i] = y[t0 + i];
    if (kMasked) os[i] = obs == nullptr ? 1 : obs[t0 + i];
  }
  __syncthreads();
}

// K1: one thread per series. kMasked = false: every step observed (obs is
// not read). kShared: every system reads the one series y [T], staged in
// shared memory a chunk at a time; else system b reads series b /
// per_series of y [S, T] straight from the cache, one step ahead: a block
// of bsts' 544 threads spans ~33 chains' series (17 systems a chain), whose
// 1024-step chunks would take 135 KB of shared memory, while all of y (8 MB
// at 4096 chains, float32) sits in the 50 MB L2 and a warp's load touches
// at most three series. With vout (the cached path only, so that the
// staged one keeps its step as short as it was), the innovations v and f
// of each step go to vout and fout [B, T]. Threads past the batch follow
// its last series, so that every thread reaches the barriers, and write
// nothing.
template <typename T, int D, bool kMasked, bool kShared>
__global__ void loglik_kernel(const T* __restrict__ z,
                              const T* __restrict__ tm,
                              const T* __restrict__ rqr,
                              const T* __restrict__ h,
                              const T* __restrict__ a0,
                              const T* __restrict__ p0,
                              const T* __restrict__ y,
                              const unsigned char* __restrict__ obs,
                              T* __restrict__ ll, T* __restrict__ vout,
                              T* __restrict__ fout, int batch, int t_len,
                              int per_series) {
  // float32: one reciprocal of f and __logf (PERF.md, K1's tolerance)
  constexpr bool kFast = std::is_same<T, float>::value;
  BOOM_SHARED_BYTES(smem_raw);
  T* ys = reinterpret_cast<T*>(smem_raw);
  unsigned char* os = smem_raw + kYChunk * sizeof(T);
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = idx < batch ? idx : batch - 1;
  const T* y_b = y + static_cast<long long>(b / per_series) * t_len;
  T zz[D], tt[D][D], a[D], p[D][D], q[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    zz[i] = z[b * D + i];
    a[i] = a0[b * D + i];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int ij = (b * D + i) * D + j;
      tt[i][j] = tm[ij];
      p[i][j] = p0[ij];
      q[i][j] = rqr[ij];
    }
  }
  const T hh = h[b];
  const bool innov = !kShared && vout != nullptr && idx < batch;
  T acc(0);
  T v, f, k[D], rf;
  T y_n = kShared ? T(0) : y_b[0];
  for (int t0 = 0; t0 < t_len; t0 += kYChunk) {
    const int n = t_len - t0 < kYChunk ? t_len - t0 : kYChunk;
    if (kShared || kMasked)
      stage_y_chunk<T, kMasked, kShared>(ys, os, y, obs, t0, n);
    for (int s = 0; s < n; ++s) {
      const bool o = !kMasked || os[s] != 0;
      T yt;
      if constexpr (kShared) {
        yt = ys[s];
      } else {
        yt = y_n;
        if (t0 + s + 1 < t_len) y_n = y_b[t0 + s + 1];
      }
      filter_step<T, D, kFast>(a, p, yt, o, zz, hh, q, tt, v, f, k, rf);
      if (o) acc = acc + log_density<T, kFast>(v, f, rf);
      if constexpr (!kShared) {
        if (innov) {
          vout[static_cast<long long>(b) * t_len + t0 + s] = v;
          fout[static_cast<long long>(b) * t_len + t0 + s] = f;
        }
      }
    }
  }
  if (idx < batch) ll[b] = acc;
}

// ---- K2 ------------------------------------------------------------------

// K2's block is one warp, a lane a chain; the streams are staged kChunk
// steps at a time (kChunk == kLanes: lane l stages step t0 + l of y, the
// mask and, in the time-varying form, z_t and h_scale; the time-varying
// form past d = 4 stages half a chunk, SmootherSmem).
constexpr int kLanes = 32;
constexpr int kChunk = 32;
static_assert(kChunk == kLanes, "a lane stages one step of y and the mask");
// A buffer holds element e of the chain of lane c at [e * kPitch + c]: a
// lane's step reads 32 consecutive doubles across the warp, and a copy of
// one chain's row (the lanes along e) strides 33 doubles, so no two lanes
// of a half-warp share a bank.
constexpr int kPitch = kLanes + 1;

// K2's shared memory: two buffers, each of kChunk steps of every chain of
// the warp (the widest pass, pass 3, holds a slot of D + 1 and w [D] a
// step, and in the time-varying form u_{t-1} [D]), then y [kChunk] and the
// mask [kChunk] of the chunk, and in the time-varying form z_t [kChunk][D]
// and h_scale [kChunk]. Two buffers of 32 steps of the time-varying form
// fit the 227 KB to d = 4; past it the time-varying form stages 16 steps.
template <int D, bool kTv = false>
struct SmootherSmem {
  static constexpr int kChunk = kTv && D > 4 ? kLanes / 2 : kLanes;
  static constexpr int kRec = D + 1;  // a step's slot: (v/f, K), later r
  static constexpr int kElems = kChunk * ((kTv ? 3 : 2) * D + 1);
  static constexpr int kY = kElems * kPitch * 8;  // byte offsets
  static constexpr int kMask = kY + kChunk * 8;
  static constexpr int kZ = (kMask + kChunk + 15) / 16 * 16;
  static constexpr int kHs = kZ + kChunk * D * 8;
  static constexpr int kBuf = kTv ? (kHs + kChunk * 8 + 15) / 16 * 16 : kZ;
  static constexpr int kBytes = 2 * kBuf;
  static_assert(kChunk <= kLanes && kBytes <= 232448,
                "two chunks must fit in 227 KB");
};

// The warp copies `count` doubles of the row of each of its chains (row of
// chain ch at base + ch * stride) into element e_of(g) of that chain's
// column of buf, asynchronously: the lanes walk g, so one copy reads 32
// consecutive doubles of a row. Chains past the batch copy its last.
template <class Map>
__device__ __forceinline__ void stage_rows(double* buf, const double* base,
                                           long long stride, int chain0,
                                           int batch, int count, Map e_of) {
  const int lane = threadIdx.x;
  const int own = batch - chain0 < kLanes ? batch - chain0 : kLanes;
  for (int g = lane; g < count; g += kLanes) {
    double* dst = buf + e_of(g) * kPitch;
    const double* src = base + chain0 * stride + g;
    if (own == kLanes) {
#pragma unroll 8
      for (int cc = 0; cc < kLanes; ++cc, src += stride)
        copy8_async(dst + cc, src);
    } else {
      for (int cc = 0; cc < kLanes; ++cc) {
        copy8_async(dst + cc, src);
        if (cc + 1 < own) src += stride;
      }
    }
  }
}

// The warp writes `count` doubles of the row of each of its live chains
// from element e_of(g) of that chain's column of buf, 32 consecutive
// doubles of a row a store.
template <class Map>
__device__ __forceinline__ void store_rows(const double* buf, double* base,
                                           long long stride, int chain0,
                                           int batch, int count, Map e_of) {
  const int lane = threadIdx.x;
  const int live = batch - chain0 < kLanes ? batch - chain0 : kLanes;
  for (int g = lane; g < count; g += kLanes) {
    const double* from = buf + e_of(g) * kPitch;
    double* dst = base + chain0 * stride + g;
    if (live == kLanes) {
#pragma unroll 8
      for (int cc = 0; cc < kLanes; ++cc, dst += stride) *dst = from[cc];
    } else {
      for (int cc = 0; cc < live; ++cc, dst += stride) *dst = from[cc];
    }
  }
}

// K2: one lane per chain; the three passes of the fused simulation
// smoother. w [C, T-1, D] = R chol(Q) eta and eps [C, T] = sqrt(h) eps_z
// are the draws' noise, alpha1 [C, D] the unconditional initial state.
// kTv (a time-varying system): step t of pass 1 reads z_t of zt [T, D],
// h_t = h * hs[t] and R Q_t R' = (u_t u_t') o R Q R' (u_t of u [., T, D]
// at u + c u_stride), pass 2 z_t, pass 3 R Q_{t-1} R'; z is not read.
// They are staged a chunk ahead as the static streams are: the u_t rows
// with w (a copy reads 32 consecutive doubles of a row), z_t and h_scale
// with y and the mask, a lane a step, read by every lane at one address.
// scratch [C, T, D+1]: pass 1 writes (v/f, K) of step t at slot t, pass 2
// overwrites its first D with r_{t-1}, pass 3 reads them. Every row is
// staged and written a chunk at a time by the whole warp (a lane writes
// back exactly the elements it staged, so a lane reads its own stores
// across passes). Lanes past the batch follow its last chain.
template <int D, bool kTv>
__global__ void __launch_bounds__(kLanes)
    smoother_kernel(const double* __restrict__ z,
                    const double* __restrict__ tm,
                    const double* __restrict__ rqr,
                    const double* __restrict__ h,
                    const double* __restrict__ p0,
                    const double* __restrict__ alpha1,
                    const double* __restrict__ w,
                    const double* __restrict__ eps,
                    const double* __restrict__ y,
                    const unsigned char* __restrict__ obs,
                    double* __restrict__ scratch, double* __restrict__ out,
                    int batch, int t_len, const double* __restrict__ zt,
                    const double* __restrict__ hs,
                    const double* __restrict__ u, long long u_stride) {
  using Sm = SmootherSmem<D, kTv>;
  constexpr int kRec = Sm::kRec, kChunk = Sm::kChunk;
  BOOM_SHARED_BYTES(smem_raw);
  const int lane = threadIdx.x;
  const int chain0 = blockIdx.x * kLanes;
  const int c = chain0 + lane < batch ? chain0 + lane : batch - 1;
  double zz[D], tt[D][D], q[D][D], a[D], p[D][D], sim[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    zz[i] = kTv ? 0.0 : z[c * D + i];
    sim[i] = alpha1[c * D + i];
    a[i] = 0.0;  // the filter on y - y+ starts from a0 = 0
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int ij = (c * D + i) * D + j;
      tt[i][j] = tm[ij];
      q[i][j] = rqr[ij];
      p[i][j] = p0[ij];
    }
  }
  const double hh = h[c];
  // a time-varying system's z_t of step s of buffer b into zz, and
  // R Q_{t'} R' into qt from u_{t'} at element e of the lane's column
  auto step_z = [&](int b, int s) {
    const double* zs = reinterpret_cast<const double*>(smem_raw +
                                                       b * Sm::kBuf + Sm::kZ);
#pragma unroll
    for (int i = 0; i < D; ++i) zz[i] = zs[s * D + i];
  };
  auto step_q = [&](const double* col, int e, double (&qt)[D][D]) {
    double ut[D];
#pragma unroll
    for (int i = 0; i < D; ++i) ut[i] = col[(e + i) * kPitch];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) qt[i][j] = (ut[i] * ut[j]) * q[i][j];
    }
  };
  const long long w_stride = static_cast<long long>(t_len - 1) * D;
  const long long s_stride = static_cast<long long>(t_len) * kRec;
  const long long o_stride = static_cast<long long>(t_len) * D;
  const int n_chunks = (t_len + kChunk - 1) / kChunk;

  auto buffer = [&](int b) {
    return reinterpret_cast<double*>(smem_raw + b * Sm::kBuf);
  };
  auto ys = [&](int b) {
    return reinterpret_cast<double*>(smem_raw + b * Sm::kBuf + Sm::kY);
  };
  auto ms = [&](int b) { return smem_raw + b * Sm::kBuf + Sm::kMask; };
  auto chunk_len = [&](int j) {
    const int left = t_len - j * kChunk;
    return left < kChunk ? left : kChunk;
  };
  auto w_len = [&](int j) {  // rows of w chunk j uses (T - 1 in all)
    const int left = t_len - 1 - j * kChunk;
    return left < kChunk ? left : kChunk;
  };
  // y (when with_y) and the mask of chunk j, one step a lane; in the
  // time-varying form also z_t and (with y) h_scale
  auto stage_series = [&](int j, int b, bool with_y) {
    const int t0 = j * kChunk, t = t0 + lane;
    const bool in = kChunk == kLanes || lane < kChunk;
    if (with_y && t < t_len && in) copy8_async(ys(b) + lane, y + t);
    if constexpr (kTv) {
      if (t < t_len && in) {
        double* zs = reinterpret_cast<double*>(smem_raw + b * Sm::kBuf +
                                               Sm::kZ);
#pragma unroll
        for (int i = 0; i < D; ++i)
          copy8_async(zs + lane * D + i,
                      zt + static_cast<long long>(t) * D + i);
        if (with_y)
          copy8_async(reinterpret_cast<double*>(smem_raw + b * Sm::kBuf +
                                                Sm::kHs) + lane,
                      hs + t);
      }
    }
    if (obs != nullptr && 4 * lane < kChunk) {
      const int left = t_len - (t0 + 4 * lane);
      if (left > 0)
        copy4_async(ms(b) + 4 * lane, obs + t0 + 4 * lane,
                    left < 4 ? left : 4);
    }
  };
  auto observed = [&](int b, int s) {
    return obs == nullptr || ms(b)[s] != 0;
  };
  auto slots = [](int g) { return g; };              // slot g of the chunk
  auto steps = [](int g) { return g + g / D; };      // [D] of a step's slot

  // 1. forward: simulate alpha+ and filter y - y+ (kalman.py:460-473); a
  // step's slot holds w_t [D] and eps_t, then (v/f, K)
  auto stage1 = [&](int j, int b) {
    const int t0 = j * kChunk;
    stage_rows(buffer(b), w + static_cast<long long>(t0) * D, w_stride,
               chain0, batch, w_len(j) * D, steps);
    stage_rows(buffer(b), eps + t0, t_len, chain0, batch, chunk_len(j),
               [](int g) { return g * (D + 1) + D; });
    if constexpr (kTv)  // u_t [D] a step after the slots
      stage_rows(buffer(b), u + static_cast<long long>(t0) * D, u_stride,
                 chain0, batch, chunk_len(j) * D,
                 [](int g) { return Sm::kChunk * (D + 1) + g; });
    stage_series(j, b, true);
  };
  stage1(0, 0);
  async_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int b = j & 1, t0 = j * kChunk, n = chunk_len(j);
    if (j + 1 < n_chunks) stage1(j + 1, b ^ 1);
    async_commit();
    async_wait<1>();
    __syncwarp();
    double* col = buffer(b) + lane;
    const double* yb = ys(b);
    // two steps a trip let step t+1's Riccati chain start under step t's
    // means and stores (faster at d=2; at d >= 5 it spills)
#pragma unroll (D <= 2 ? 2 : 1)
    for (int s = 0; s < n; ++s) {
      const int t = t0 + s;
      double* slot = col + s * kRec * kPitch;
      double ws[D];
#pragma unroll
      for (int i = 0; i < D; ++i) ws[i] = slot[i * kPitch];
      double hq = hh;
      double qt[kTv ? D : 1][kTv ? D : 1];
      if constexpr (kTv) {
        step_z(b, s);
        step_q(col, kChunk * (D + 1) + s * D, qt);
        hq = hh * reinterpret_cast<const double*>(smem_raw + b * Sm::kBuf +
                                                  Sm::kHs)[s];
      }
      double zs = zz[0] * sim[0];
#pragma unroll
      for (int i = 1; i < D; ++i) zs = zs + zz[i] * sim[i];
      const double yd = yb[s] - (zs + slot[D * kPitch]);
      double v, f, k[D], rf;
      if constexpr (kTv)
        filter_step<double, D, true>(a, p, yd, observed(b, s), zz, hq, qt,
                                     tt, v, f, k, rf);
      else
        filter_step<double, D, true>(a, p, yd, observed(b, s), zz, hh, q, tt,
                                     v, f, k, rf);
      slot[0] = v * rf;
#pragma unroll
      for (int i = 0; i < D; ++i) slot[(1 + i) * kPitch] = k[i];
      if (t < t_len - 1) {
        double sn[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          double ts = tt[i][0] * sim[0];
#pragma unroll
          for (int m = 1; m < D; ++m) ts = ts + tt[i][m] * sim[m];
          sn[i] = ts + ws[i];
        }
#pragma unroll
        for (int i = 0; i < D; ++i) sim[i] = sn[i];
      }
    }
    __syncwarp();
    store_rows(buffer(b), scratch + static_cast<long long>(t0) * kRec,
               s_stride, chain0, batch, n * kRec, slots);
    __syncwarp();  // every lane is done with buffer b before it is refilled
  }

  // 2. backward: r_{t-1} = where(obs, z v/f, 0) + L' r_t (kalman.py:315-323),
  // chunks in reverse; r_{t-1} replaces the first D of slot t
  auto stage2 = [&](int j, int b) {
    stage_rows(buffer(b), scratch + static_cast<long long>(j) * kChunk * kRec,
               s_stride, chain0, batch, chunk_len(j) * kRec, slots);
    stage_series(j, b, false);
  };
  double r[D];
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = 0.0;
  __threadfence_block();  // pass 1's stores before pass 2's copies of them
  stage2(n_chunks - 1, 0);
  async_commit();
  for (int jj = 0; jj < n_chunks; ++jj) {
    const int j = n_chunks - 1 - jj, b = jj & 1;
    const int t0 = j * kChunk, n = chunk_len(j);
    if (j > 0) stage2(j - 1, b ^ 1);
    async_commit();
    async_wait<1>();
    __syncwarp();
    double* col = buffer(b) + lane;
    for (int s = n - 1; s >= 0; --s) {
      const bool ob = observed(b, s);
      if constexpr (kTv) step_z(b, s);
      double* slot = col + s * kRec * kPitch;
      const double vf = slot[0];
      double k[D];
#pragma unroll
      for (int i = 0; i < D; ++i) k[i] = slot[(1 + i) * kPitch];
      double rn[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        double lr = (tt[0][i] - k[0] * zz[i]) * r[0];
#pragma unroll
        for (int m = 1; m < D; ++m) lr = lr + (tt[m][i] - k[m] * zz[i]) * r[m];
        rn[i] = (ob ? zz[i] * vf : 0.0) + lr;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        r[i] = rn[i];
        slot[i * kPitch] = r[i];
      }
    }
    __syncwarp();
    store_rows(buffer(b), scratch + static_cast<long long>(t0) * kRec,
               s_stride, chain0, batch, n * kRec, slots);
    __syncwarp();
  }

  // 3. forward state: alpha_1 = P0 r_0, alpha_{t+1} = T alpha_t + RQR r_t
  // (kalman.py:325, :345-350), added to alpha+ regenerated from alpha_1
  // and w as pass 1 made it (:481); the chunk holds the slots, then w [D]
  // a step at kChunk * kRec, and the draw replaces the slots' first D
  auto stage3 = [&](int j, int b) {
    const int t0 = j * kChunk;
    stage_rows(buffer(b), scratch + static_cast<long long>(t0) * kRec,
               s_stride, chain0, batch, chunk_len(j) * kRec, slots);
    stage_rows(buffer(b), w + static_cast<long long>(t0) * D, w_stride,
               chain0, batch, w_len(j) * D,
               [](int g) { return Sm::kChunk * (D + 1) + g; });
    if constexpr (kTv) {  // u_{t-1} [D] of step t after w (none at t = 0)
      const int s0 = j == 0 ? 1 : 0;
      stage_rows(buffer(b), u + static_cast<long long>(t0 - 1 + s0) * D,
                 u_stride, chain0, batch, (chunk_len(j) - s0) * D,
                 [s0](int g) { return Sm::kChunk * (2 * D + 1) + s0 * D + g; });
    }
  };
#pragma unroll
  for (int i = 0; i < D; ++i) sim[i] = alpha1[c * D + i];
  double ah[D];
  __threadfence_block();  // pass 2's stores before pass 3's copies of them
  stage3(0, 0);
  async_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int b = j & 1, t0 = j * kChunk, n = chunk_len(j);
    if (j + 1 < n_chunks) stage3(j + 1, b ^ 1);
    async_commit();
    async_wait<1>();
    __syncwarp();
    double* col = buffer(b) + lane;
    // the draw of step t into slot s, then alpha+ moves to t + 1
    auto emit = [&](int s, int t) {
      double* slot = col + s * kRec * kPitch;
#pragma unroll
      for (int i = 0; i < D; ++i) slot[i * kPitch] = sim[i] + ah[i];
      if (t < t_len - 1) {
        const double* ws = col + (kChunk * kRec + s * D) * kPitch;
        double sn[D];
#pragma unroll
        for (int i = 0; i < D; ++i) {
          double ts = tt[i][0] * sim[0];
#pragma unroll
          for (int m = 1; m < D; ++m) ts = ts + tt[i][m] * sim[m];
          sn[i] = ts + ws[i * kPitch];
        }
#pragma unroll
        for (int i = 0; i < D; ++i) sim[i] = sn[i];
      }
    };
    int s = 0;
    if (t0 == 0) {  // alpha_1 = P0 r_0, outside the steady loop
#pragma unroll
      for (int i = 0; i < D; ++i) {
        double acc = p0[(c * D + i) * D] * col[0];
#pragma unroll
        for (int m = 1; m < D; ++m)
          acc = acc + p0[(c * D + i) * D + m] * col[m * kPitch];
        ah[i] = acc;
      }
      emit(0, 0);
      s = 1;
    }
    for (; s < n; ++s) {
      const double* rs = col + s * kRec * kPitch;
      // R Q_{t-1} R' r = u_i sum_m R Q R'[i][m] (u_m r_m), u = u_{t-1}
      double ut[kTv ? D : 1], ur[kTv ? D : 1];
      if constexpr (kTv) {
#pragma unroll
        for (int i = 0; i < D; ++i) {
          ut[i] = col[(kChunk * (2 * D + 1) + s * D + i) * kPitch];
          ur[i] = ut[i] * rs[i * kPitch];
        }
      }
      double an[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        double ta = tt[i][0] * ah[0];
#pragma unroll
        for (int m = 1; m < D; ++m) ta = ta + tt[i][m] * ah[m];
        double qr;
        if constexpr (kTv) {
          qr = q[i][0] * ur[0];
#pragma unroll
          for (int m = 1; m < D; ++m) qr = qr + q[i][m] * ur[m];
          qr = ut[i] * qr;
        } else {
          qr = q[i][0] * rs[0];
#pragma unroll
          for (int m = 1; m < D; ++m) qr = qr + q[i][m] * rs[m * kPitch];
        }
        an[i] = ta + qr;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) ah[i] = an[i];
      emit(s, t0 + s);
    }
    __syncwarp();
    store_rows(buffer(b), out + static_cast<long long>(t0) * D, o_stride,
               chain0, batch, n * D, steps);
    __syncwarp();
  }
}

bool bad_launch(int batch, int threads) {
  return threads < 0 || threads > 1024 || threads % 32 != 0 || batch < 0;
}

// ---- K1's time-varying form ----------------------------------------------

// A 4- or 8-byte element global -> shared, asynchronously.
template <typename T>
__device__ __forceinline__ void copy_elem_async(T* smem, const T* gmem) {
  if constexpr (sizeof(T) == 8)
    copy8_async(smem, gmem);
  else
    copy4_async(smem, gmem, 4);
}

// Entry (i, j) of a symmetric D x D matrix's upper triangle, row by row.
template <int D>
__host__ __device__ __forceinline__ constexpr int upper(int i, int j) {
  return i <= j ? i * D - i * (i - 1) / 2 + (j - i)
                : j * D - j * (j - 1) / 2 + (i - j);
}

// K1's time-varying form's shared memory (bytes): two stage buffers of
// kSteps steps, each holding u_t [kSteps][D] and y [kSteps] of each of the
// warp's 32 systems (element e of system c at [e * kPitch + c]: a step's
// reads across the systems are consecutive), then z_t [kSteps][D],
// h_scale [kSteps] and the mask's kSteps bytes; then v and f of a chunk
// (step s of system c at [s * kPitch + c]).
template <typename T, int D>
struct LoglikTvSmem {
  static constexpr int kSteps = 32;
  static constexpr int kItem = static_cast<int>(sizeof(T));
  static constexpr int kY = kSteps * D * kPitch;  // elements of a buffer
  static constexpr int kZ = kY + kSteps * kPitch;
  static constexpr int kHs = kZ + kSteps * D;
  static constexpr int kMask = (kHs + kSteps) * kItem;  // bytes
  static constexpr int kBuf = (kMask + kSteps + 15) / 16 * 16;
  static constexpr int kVf = 2 * kBuf;
  static constexpr int kBytes = kVf + 2 * kSteps * kPitch * kItem;
  static_assert(kBytes <= 232448, "K1's time-varying layout");
};

// Stages steps [t0, t0 + n) of the streams into buffer buf,
// asynchronously: a thread its own system's u_t rows (u_c: its u at step
// 0) and y (y_c: its series) into column c, the warp z_t, h_scale and the
// mask, a step a lane.
template <typename T, int D>
__device__ __forceinline__ void stage_tv(unsigned char* buf, const T* y_c,
                                         const T* u_c,
                                         const unsigned char* obs,
                                         const T* zt, const T* hs, int c,
                                         int t0, int n) {
  using Sm = LoglikTvSmem<T, D>;
  const int lane = threadIdx.x;
  T* bt = reinterpret_cast<T*>(buf);
  const long long at = static_cast<long long>(t0) * D;
  for (int g = 0; g < n * D; ++g)
    copy_elem_async(bt + g * kPitch + c, u_c + at + g);
  for (int g = 0; g < n; ++g)
    copy_elem_async(bt + Sm::kY + g * kPitch + c, y_c + t0 + g);
  if (lane < n) {
#pragma unroll
    for (int i = 0; i < D; ++i)
      copy_elem_async(bt + Sm::kZ + lane * D + i, zt + at + lane * D + i);
    copy_elem_async(bt + Sm::kHs + lane, hs + t0 + lane);
  }
  if (obs != nullptr && 4 * lane < n)
    copy4_async(buf + Sm::kMask + 4 * lane, obs + t0 + 4 * lane,
                n - 4 * lane < 4 ? n - 4 * lane : 4);
}

// The warp writes v and f of a chunk (n steps from t0) of its systems sys0
// .. last, a row of steps a system (consecutive lanes, consecutive steps).
template <typename T>
__device__ __forceinline__ void store_vf(const T* vs, const T* fs, T* vout,
                                         T* fout, int sys0, int last,
                                         int t_len, int t0, int n) {
  const int lane = threadIdx.x;
  if (lane >= n) return;
  for (int c = 0; sys0 + c <= last; ++c) {
    const long long at = static_cast<long long>(sys0 + c) * t_len + t0 + lane;
    vout[at] = vs[lane * kPitch + c];
    fout[at] = fs[lane * kPitch + c];
  }
}

// K1 of a time-varying system (the dynamic regression's z_t, the
// observation weights' h_t, the Student trend's and the holiday's Q_t), a
// thread a system: z_t of zt [T, D] (one for every system), h_t = h hs[t]
// and R Q_t R' = (u_t u_t') o R Q R', u_t of u [., T, D] at u + b u_stride
// (u_stride 0: one for every system; R is a 0/1 selection, so that this is
// the reference's R ((q_t q_t') o Q) R' entry by entry); T of tm at tm + b
// tm_stride (0: one for every system). y [S, T] of series b / per_series
// (one series: per_series = batch); the mask (nullptr: every step
// observed); with vout the innovations v and f [B, T]. The streams come a
// chunk of 32 steps ahead (stage_tv, cp.async, double-buffered) and v, f
// leave a chunk at a time as rows. A step is the symmetric Riccati step on
// P's upper triangle in registers, ordered so that T P T' runs beside the
// chain P z -> f -> 1 / f (one thread alone on its scheduler waits out
// every latency of a chain):
//   P' = T P T' - (T P z)(T P z)' / f + R Q_t R', a' = T a + T P z v / f
// (unobserved: T P T' + R Q_t R', T a), the plain version's (T P) L' + R
// Q_t R' (L = T - K z', K = T P z / f) symmetrised, to rounding. A thread
// past the batch shadows the last system and writes nothing.
template <typename T, int D>
__global__ void __launch_bounds__(kLanes)
    loglik_tv_kernel(const T* __restrict__ tm, const T* __restrict__ rqr,
                     const T* __restrict__ h, const T* __restrict__ a0,
                     const T* __restrict__ p0, const T* __restrict__ y,
                     const unsigned char* __restrict__ obs,
                     const T* __restrict__ zt, const T* __restrict__ hs,
                     const T* __restrict__ u, T* __restrict__ ll,
                     T* __restrict__ vout, T* __restrict__ fout, int batch,
                     int t_len, int per_series, int tm_stride,
                     long long u_stride) {
  using Sm = LoglikTvSmem<T, D>;
  constexpr bool kFast = std::is_same<T, float>::value;
  constexpr int kUpper = D * (D + 1) / 2, kCh = Sm::kSteps;
  BOOM_SHARED_BYTES(smem_raw);
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * kLanes;
  const int last = (batch - b0 < kLanes ? batch : b0 + kLanes) - 1;
  const int b = b0 + lane <= last ? b0 + lane : last;
  const long long bd = static_cast<long long>(b) * D;
  const T* tm_b = tm + static_cast<long long>(b) * tm_stride;
  const T* y_b = y + static_cast<long long>(b / per_series) * t_len;
  const T* u_b = u + static_cast<long long>(b) * u_stride;
  T tt[D][D], a[D], p[kUpper], q[kUpper];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    a[i] = a0[bd + i];
#pragma unroll
    for (int j = 0; j < D; ++j) tt[i][j] = tm_b[i * D + j];
#pragma unroll
    for (int j = i; j < D; ++j) {
      p[upper<D>(i, j)] =
          T(0.5) * (p0[(bd + i) * D + j] + p0[(bd + j) * D + i]);
      q[upper<D>(i, j)] =
          T(0.5) * (rqr[(bd + i) * D + j] + rqr[(bd + j) * D + i]);
    }
  }
  const T hh = h[b];
  T* vs = reinterpret_cast<T*>(smem_raw + Sm::kVf);
  T* fs = vs + kCh * kPitch;
  auto buffer = [&](int j) { return smem_raw + (j & 1) * Sm::kBuf; };
  auto chunk_len = [&](int j) {
    return t_len - j * kCh < kCh ? t_len - j * kCh : kCh;
  };
  const int n_chunks = (t_len + kCh - 1) / kCh;
  stage_tv<T, D>(buffer(0), y_b, u_b, obs, zt, hs, lane, 0, chunk_len(0));
  async_commit();
  T acc(0);
  for (int j = 0; j < n_chunks; ++j) {
    const int t0 = j * kCh, n = chunk_len(j);
    if (j + 1 < n_chunks)
      stage_tv<T, D>(buffer(j + 1), y_b, u_b, obs, zt, hs, lane, t0 + kCh,
                     chunk_len(j + 1));
    async_commit();
    async_wait<1>();
    __syncwarp();  // chunk j is staged
    const T* bt = reinterpret_cast<const T*>(buffer(j));
    const unsigned char* bm = buffer(j) + Sm::kMask;
    // step s's inputs, loaded a step ahead (during the step before)
    T zn[D], un[D], yn, hn;
    bool on;
    auto load = [&](int s) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        zn[i] = bt[Sm::kZ + s * D + i];
        un[i] = bt[(s * D + i) * kPitch + lane];
      }
      yn = bt[Sm::kY + s * kPitch + lane];
      hn = bt[Sm::kHs + s];
      on = obs == nullptr || bm[s] != 0;
    };
    load(0);
    for (int s = 0; s < n; ++s) {
      const bool ob = on;
      T zz[D], ut[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        zz[i] = zn[i];
        ut[i] = un[i];
      }
      const T yt = yn;
      const T ht = hh * hn;
      if (s + 1 < n) load(s + 1);
      T za = zz[0] * a[0];
#pragma unroll
      for (int i = 1; i < D; ++i) za = za + zz[i] * a[i];
      const T v = ob ? yt - za : T(0);
      T pz[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T acc_i = p[upper<D>(i, 0)] * zz[0];
#pragma unroll
        for (int k = 1; k < D; ++k) acc_i = acc_i + p[upper<D>(i, k)] * zz[k];
        pz[i] = acc_i;
      }
      T f = zz[0] * pz[0];
#pragma unroll
      for (int i = 1; i < D; ++i) f = f + zz[i] * pz[i];
      f = f + ht;
      const T rf = reciprocal(f);
      const T rk = ob ? rf : T(0);  // no gain where y_t is missing
      const T vf = v * rf;
      if (ob) acc = acc + log_density<T, kFast>(v, f, rf);
      if (vout != nullptr) {
        vs[s * kPitch + lane] = v;
        fs[s * kPitch + lane] = f;
      }
      // T P z, T a; P' = T P T' - (T P z)(T P z)' / f + R Q_t R' (upper)
      T tpz[D], ta[D], pn[kUpper];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T acc_p = tt[i][0] * pz[0], acc_a = tt[i][0] * a[0];
#pragma unroll
        for (int k = 1; k < D; ++k) {
          acc_p = acc_p + tt[i][k] * pz[k];
          acc_a = acc_a + tt[i][k] * a[k];
        }
        tpz[i] = acc_p;
        ta[i] = acc_a;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T m[D];  // row i of T P
#pragma unroll
        for (int k = 0; k < D; ++k) {
          T acc_k = tt[i][0] * p[upper<D>(0, k)];
#pragma unroll
          for (int l = 1; l < D; ++l)
            acc_k = acc_k + tt[i][l] * p[upper<D>(l, k)];
          m[k] = acc_k;
        }
#pragma unroll
        for (int k = i; k < D; ++k) {
          T acc_k = m[0] * tt[k][0];
#pragma unroll
          for (int l = 1; l < D; ++l) acc_k = acc_k + m[l] * tt[k][l];
          pn[upper<D>(i, k)] = (acc_k - (tpz[i] * tpz[k]) * rk) +
                               (ut[i] * ut[k]) * q[upper<D>(i, k)];
        }
      }
#pragma unroll
      for (int i = 0; i < D; ++i) a[i] = ta[i] + tpz[i] * vf;
#pragma unroll
      for (int k = 0; k < kUpper; ++k) p[k] = pn[k];
    }
    if (vout != nullptr) {
      __syncwarp();  // v and f of the chunk are whole
      store_vf(vs, fs, vout, fout, b0, last, t_len, t0, n);
    }
    __syncwarp();  // buffer j, v and f are read before they are refilled
  }
  if (b0 + lane <= last) ll[b] = acc;
}

// K1's block size: the one given, or (threads == 0) one block of
// ceil(batch / SMs) threads, rounded up to a warp, on each SM, within what
// the kernel's registers allow.
template <typename Kernel>
int loglik_block(Kernel kernel, int batch, int threads) {
  if (threads > 0) return threads;
  int dev = 0, sms = 1;
  cudaFuncAttributes attr;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
             != cudaSuccess
      || cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
    return -1;
  const int most = attr.maxThreadsPerBlock / 32 * 32;
  const int per_sm = (batch + sms - 1) / sms;
  const int want = (per_sm + 31) / 32 * 32;
  return want < most ? want : most;
}

template <typename T, int D>
int launch_loglik(const void* z, const void* tm, const void* rqr,
                  const void* h, const void* a0, const void* p0,
                  const void* y, const void* obs, void* ll, void* vout,
                  void* fout, int batch, int t_len, int n_series,
                  int threads, void* stream) {
  if (bad_launch(batch, threads) || t_len < 1 || n_series < 1 ||
      (batch > 0 && batch % n_series != 0) ||
      (vout == nullptr) != (fout == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  // the staged series for one series without the innovations
  const bool shared = n_series == 1 && vout == nullptr;
  auto kernel = obs != nullptr ? (shared ? loglik_kernel<T, D, true, true>
                                         : loglik_kernel<T, D, true, false>)
                               : (shared ? loglik_kernel<T, D, false, true>
                                         : loglik_kernel<T, D, false, false>);
  threads = loglik_block(kernel, batch, threads);
  if (threads <= 0) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  }
  const int blocks = (batch + threads - 1) / threads;
  const int smem = kYChunk * (static_cast<int>(sizeof(T)) + 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, threads, smem, st>>>(
      static_cast<const T*>(z), static_cast<const T*>(tm),
      static_cast<const T*>(rqr), static_cast<const T*>(h),
      static_cast<const T*>(a0), static_cast<const T*>(p0),
      static_cast<const T*>(y), static_cast<const unsigned char*>(obs),
      static_cast<T*>(ll), static_cast<T*>(vout), static_cast<T*>(fout),
      batch, t_len, batch / n_series);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_loglik_tv(const void* tm, const void* rqr, const void* h,
                     const void* a0, const void* p0, const void* y,
                     const void* obs, const void* zt, const void* hs,
                     const void* u, void* ll, void* vout, void* fout,
                     int batch, int t_len, int n_series, int shared,
                     long long u_stride, void* stream) {
  if (batch < 0 || t_len < 1 || n_series < 1 ||
      (batch > 0 && batch % n_series != 0) ||
      (vout == nullptr) != (fout == nullptr) || u_stride < 0 ||
      (shared != 0 && shared != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  using Sm = LoglikTvSmem<T, D>;
  auto kernel = loglik_tv_kernel<T, D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (batch + kLanes - 1) / kLanes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, kLanes, Sm::kBytes, st>>>(
      static_cast<const T*>(tm), static_cast<const T*>(rqr),
      static_cast<const T*>(h), static_cast<const T*>(a0),
      static_cast<const T*>(p0), static_cast<const T*>(y),
      static_cast<const unsigned char*>(obs), static_cast<const T*>(zt),
      static_cast<const T*>(hs), static_cast<const T*>(u),
      static_cast<T*>(ll), static_cast<T*>(vout), static_cast<T*>(fout),
      batch, t_len, batch / n_series, shared ? 0 : D * D, u_stride);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kTv>
int launch_smoother(const void* z, const void* tm, const void* rqr,
                    const void* h, const void* p0, const void* alpha1,
                    const void* w, const void* eps, const void* y,
                    const void* obs, void* scratch, void* out, int batch,
                    int t_len, const void* zt, const void* hs, const void* u,
                    long long u_stride, int threads, void* stream) {
  if (batch < 0 || threads != kLanes || t_len < 1 || u_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  using Sm = SmootherSmem<D, kTv>;
  auto kernel = smoother_kernel<D, kTv>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::kBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (batch + kLanes - 1) / kLanes;
  const double* zd = static_cast<const double*>(z);
  const double* tmd = static_cast<const double*>(tm);
  const double* qd = static_cast<const double*>(rqr);
  const double* hd = static_cast<const double*>(h);
  const double* pd = static_cast<const double*>(p0);
  const double* a1 = static_cast<const double*>(alpha1);
  const double* wd = static_cast<const double*>(w);
  const double* ed = static_cast<const double*>(eps);
  const double* yd = static_cast<const double*>(y);
  const unsigned char* od = static_cast<const unsigned char*>(obs);
  double* sd = static_cast<double*>(scratch);
  double* outd = static_cast<double*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, kLanes, Sm::kBytes, st>>>(
      zd, tmd, qd, hd, pd, a1, wd, ed, yd, od, sd, outd, batch, t_len,
      static_cast<const double*>(zt), static_cast<const double*>(hs),
      static_cast<const double*>(u), u_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries. Every array is a contiguous device array of the entry's
// type: z [B, D], tm and rqr and p0 [B, D, D], h [B], a0 and alpha1 [B, D],
// y [T] (K1: [S, T], S = n_series dividing B, system b reading series
// b / (B / S)), obs [T] bytes, 4-byte aligned (nullptr: all observed);
// outputs ll [B], K1's vout and fout [B, T] (both nullptr: no
// innovations), out [C, T, D]; w [C, T-1, D], eps [C, T]; scratch
// [C, T, D+1]. threads: K1's block size, a multiple of 32 up to 1024, or 0
// for one block of ceil(B / SMs) threads an SM; K2's must be 32. stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
#define BOOM_LOGLIK_ENTRY(TY, TYNAME, D)                                     \
  extern "C" int boom_kalman_loglik_##TYNAME##_d##D(                         \
      const void* z, const void* tm, const void* rqr, const void* h,         \
      const void* a0, const void* p0, const void* y, const void* obs,        \
      void* ll, void* vout, void* fout, int batch, int t_len, int n_series,  \
      int threads, void* stream) {                                           \
    return launch_loglik<TY, D>(z, tm, rqr, h, a0, p0, y, obs, ll, vout,     \
                                fout, batch, t_len, n_series, threads,       \
                                stream);                                     \
  }

#define BOOM_SMOOTHER_ENTRY(TY, TYNAME, D)                                   \
  extern "C" int boom_kalman_smoother_##TYNAME##_d##D(                       \
      const void* z, const void* tm, const void* rqr, const void* h,         \
      const void* p0, const void* alpha1, const void* w, const void* eps,    \
      const void* y, const void* obs, void* scratch, void* out, int batch,   \
      int t_len, int threads, void* stream) {                                \
    return launch_smoother<D, false>(z, tm, rqr, h, p0, alpha1, w, eps, y,  \
                                     obs, scratch, out, batch, t_len,        \
                                     nullptr, nullptr, nullptr, 0, threads,  \
                                     stream);                                \
  }

// The time-varying system's K1 and K2 (loglik_tv_kernel, smoother_kernel<D,
// true>): K1's and K2's arrays without z, then zt [T, D] (one z_t for every
// system), hs [T] (h_t = h hs[t]) and u [U, T, D] with u_stride = T D
// (U = B, a u a system) or 0 (U = 1, one for every system), R a 0/1
// selection with at most one 1 a row. K1's `shared` 1: tm is one [D, D] of
// every system.
#define BOOM_LOGLIK_TV_ENTRY(TY, TYNAME, D)                                  \
  extern "C" int boom_kalman_loglik_tv_##TYNAME##_d##D(                      \
      const void* tm, const void* rqr, const void* h, const void* a0,        \
      const void* p0, const void* y, const void* obs, const void* zt,        \
      const void* hs, const void* u, void* ll, void* vout, void* fout,       \
      int batch, int t_len, int n_series, int shared, long long u_stride,    \
      void* stream) {                                                        \
    return launch_loglik_tv<TY, D>(tm, rqr, h, a0, p0, y, obs, zt, hs, u,    \
                                   ll, vout, fout, batch, t_len, n_series,   \
                                   shared, u_stride, stream);                \
  }

#define BOOM_SMOOTHER_TV_ENTRY(D)                                            \
  extern "C" int boom_kalman_smoother_tv_f64_d##D(                           \
      const void* tm, const void* rqr, const void* h, const void* p0,        \
      const void* alpha1, const void* w, const void* eps, const void* y,     \
      const void* obs, const void* zt, const void* hs, const void* u,        \
      void* scratch, void* out, int batch, int t_len, long long u_stride,    \
      int threads, void* stream) {                                           \
    return launch_smoother<D, true>(nullptr, tm, rqr, h, p0, alpha1, w, eps, \
                                    y, obs, scratch, out, batch, t_len, zt,  \
                                    hs, u, u_stride, threads, stream);       \
  }

#define BOOM_LOGLIK_ALL_D(TY, TYNAME) \
  BOOM_LOGLIK_ENTRY(TY, TYNAME, 1)    \
  BOOM_LOGLIK_ENTRY(TY, TYNAME, 2)    \
  BOOM_LOGLIK_ENTRY(TY, TYNAME, 3)    \
  BOOM_LOGLIK_ENTRY(TY, TYNAME, 4)    \
  BOOM_LOGLIK_ENTRY(TY, TYNAME, 5)    \
  BOOM_LOGLIK_ENTRY(TY, TYNAME, 6)

BOOM_LOGLIK_ALL_D(float, f32)
BOOM_LOGLIK_ALL_D(double, f64)
BOOM_SMOOTHER_ENTRY(double, f64, 1)
BOOM_SMOOTHER_ENTRY(double, f64, 2)
BOOM_SMOOTHER_ENTRY(double, f64, 3)
BOOM_SMOOTHER_ENTRY(double, f64, 4)
BOOM_SMOOTHER_ENTRY(double, f64, 5)
BOOM_SMOOTHER_ENTRY(double, f64, 6)

#define BOOM_LOGLIK_TV_ALL_D(TY, TYNAME) \
  BOOM_LOGLIK_TV_ENTRY(TY, TYNAME, 1)    \
  BOOM_LOGLIK_TV_ENTRY(TY, TYNAME, 2)    \
  BOOM_LOGLIK_TV_ENTRY(TY, TYNAME, 3)    \
  BOOM_LOGLIK_TV_ENTRY(TY, TYNAME, 4)    \
  BOOM_LOGLIK_TV_ENTRY(TY, TYNAME, 5)    \
  BOOM_LOGLIK_TV_ENTRY(TY, TYNAME, 6)

BOOM_LOGLIK_TV_ALL_D(float, f32)
BOOM_LOGLIK_TV_ALL_D(double, f64)
BOOM_SMOOTHER_TV_ENTRY(1)
BOOM_SMOOTHER_TV_ENTRY(2)
BOOM_SMOOTHER_TV_ENTRY(3)
BOOM_SMOOTHER_TV_ENTRY(4)
BOOM_SMOOTHER_TV_ENTRY(5)
BOOM_SMOOTHER_TV_ENTRY(6)

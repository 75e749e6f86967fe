// Kernel (a): the SSVS indicator sweep of spike-and-slab regression on the
// SWEEP-operator state, hand-written for Hopper (sm_90a). One launch makes
// one sweep of every chain; one block (CTA) is one chain.
//
// Replaces the reference's XLA scans over rank-1 SWEEP updates (not Pallas
// kernels), boom_tpu/models/glm/regression_sweep.py:
//   `build_sweep_state` (:84): sweep the augmented matrix
//       S0 = [[Omega + X'X, Omega b + X'y], [., prior_ss + y'y]]
//       and Omega on the chain's inclusion mask g;
//   `_mode_jump_swept` (:178): the incremental independence mode-jump walk
//       (only with a proposal, qprobs);
//   `draw_indicators_swept` (:241): the random-order Gibbs flip scan,
//       every flip a gated rank-1 `gated_flip_sweep` (boom_tpu/linalg/
//       sweep.py:76).
// The plain PyTorch version is boom_tpu_torch/models/glm/regression_sweep.py
// (`draw_indicators_swept`); ssvs_kernel.py binds this file.
//
// What bounds it. The reference's work is 2p gated rank-1 passes over
// (p+1)^2 + p^2 entries a chain and sweep (the build and the flips), ~1 GFLOP
// at the bench's 1024 chains, p = 50: 0.016 ms at the card's float32 rate,
// more than the bytes (S0, Omega once, the noise and masks) take. But only
// the passes whose gate is on change anything, and those are few (the
// included coordinates in the build, the flips taken: ~10 a chain at the
// bench's posterior); every flip, taken or not, costs a chain of dependent
// scalar operations (two logs of pivots, the residual corner, the log of
// its sum of squares, the log sigmoid). Measured (PERF.md §6,
// kernels/ssvs_timing.py --split), the ~10 passes a chain take most of the
// time and the 50 decisions little once they run 32 at a time: with all
// 1024 chains resident, the passes are bound by the instructions the SM
// issues for them, so the design keeps a pass's instructions few and its
// decisions off the block:
//   - S [(p+1)^2] and Omega's swept copy [p^2] live in shared memory for the
//     whole sweep (20.4 KB at p = 50 in float32, 40.8 KB in float64), full
//     storage: the plain version updates both triangles with the same
//     formula, and they differ by rounding, so a triangle would lose
//     agreement with it; full storage fits p <= 168 (float64: 118) in
//     227 KB, 119 (83) with the mode-jump walk's copy;
//   - the chain's noise is staged on chip before the build, while S0 and
//     Omega arrive by cp.async: the flips' indices and the logs of their
//     uniforms, the jump's proposal and the log of its acceptance uniform,
//     all taken by the whole block at once, and the log inclusion odds; the
//     flips load nothing from device memory (but the q terms of a nonzero
//     prior mean, the rare forced-in case, read the prior's Omega and mean);
//   - warp 0 decides the flips alone, a lane a flip: 32 flips at a time on
//     the current state. Until a flip is taken the state does not change,
//     so every flip before the first one taken gets the decision it would
//     get in order (a ballot finds the first); flips not taken meet no
//     block barrier. Only a flip taken publishes its index, with its row
//     and column already staged by warp 0, to the other warps;
//   - a rank-1 pass updates S and Omega together, with one barrier before
//     and one after: the build's and the walk's passes stage row and
//     column k with the whole block, a flip's is staged by warp 0; the
//     update takes a warp's rows four at a time, two columns a lane, with
//     no select or predicate in its loop (rank1_update);
//   - the mode-jump walk runs on a second copy of S and Omega, and an
//     accepted jump swaps the two, so a rejected one restores the pre-walk
//     state exactly (never by unsweeping back);
//   - every arithmetic operation is one IEEE operation in the plain
//     version's order (__fmul_rn and friends: no contraction into FMAs), and
//     the logs and exps are the CUDA math library's, as PyTorch's own
//     elementwise kernels compute them, so the kernel reproduces the plain
//     version on the card up to the libraries' last bits.
//
// The prior's bounded model size (`max_size`) is enforced: a flip that would
// include a coordinate past it has log probability -inf, and so has a jump
// whose proposal exceeds it. The reference's SWEEP path ignores max_size
// (ROADMAP.md §3).

#include <cmath>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
// Blocks of kMaxThreads an SM the compiler must allow registers for (at
// most 65536 / (kMaxThreads * kMinBlocks) a thread): float32 without the
// jump must keep 8 chains of 128 threads an SM (64 registers), so that the
// bench's 1024 chains are one wave; the others are held to five or fewer
// chains an SM by shared memory, and may take 128 registers.
template <typename T, bool kJump>
constexpr int kMinBlocks = sizeof(T) == 4 && !kJump ? 4 : 2;
// the mode-jump walk's Hamming budget (regression_sweep.MODE_JUMP_BUDGET)
constexpr int kJumpBudget = 16;
// warp 0's broadcasts: a flip taken (its index, -1 for none left, and
// whether it was included), the walk's length and the jump's decision
constexpr int kFlags = 4;
constexpr int kFlipJ = 0, kFlipIncl = 1, kWalkLen = 2, kJumpTake = 3;
constexpr unsigned kFullWarp = 0xffffffffu;

// One correctly rounded IEEE operation each, never fused.
template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
  static __device__ __forceinline__ float log(float a) { return logf(a); }
  static __device__ __forceinline__ float log1p(float a) {
    return log1pf(a);
  }
  static __device__ __forceinline__ float exp(float a) { return expf(a); }
  static __device__ __forceinline__ float tiny() {
    return 1.17549435e-38f;  // FLT_MIN, torch.finfo(float32).tiny
  }
};

template <>
struct Ops<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
  static __device__ __forceinline__ double log(double a) { return ::log(a); }
  static __device__ __forceinline__ double log1p(double a) {
    return ::log1p(a);
  }
  static __device__ __forceinline__ double exp(double a) { return ::exp(a); }
  static __device__ __forceinline__ double tiny() {
    return 2.2250738585072014e-308;  // DBL_MIN
  }
};

// max(x, tiny) as torch.clamp_min computes it (a NaN stays NaN)
template <typename T>
__device__ __forceinline__ T clamp_tiny(T x) {
  return x < Ops<T>::tiny() ? Ops<T>::tiny() : x;
}

// log sigmoid(x) = min(x, 0) - log1p(exp(-|x|)), as the plain version
template <typename T>
__device__ __forceinline__ T log_sigmoid(T x) {
  using O = Ops<T>;
  const T lo = x < T(0) ? x : (x == x ? T(0) : x);
  const T ax = x < T(0) ? -x : x;
  return O::sub(lo, O::log1p(O::exp(-ax)));
}

// The block's dynamic shared memory, 16-byte aligned.
#ifndef BOOM_SHARED_BYTES
#define BOOM_SHARED_BYTES(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

// The chain's scalar state (every lane of warp 0 keeps the same copy in
// registers).
template <typename T>
struct Scalars {
  T logdet_a, logdet_o, q, spike;
  int size;
};

// What one flip at j would give (regression_sweep._flip_deltas and the
// flip's log model probability), computed by a lane of warp 0 from shared
// memory.
template <typename T>
struct Flip {
  bool incl;
  T d_ld_a, d_ld_o, dq, d_spike, logp;
};

template <typename T>
__device__ __forceinline__ Flip<T> flip_deltas(
    const T* s, const T* o, const unsigned char* mask, int p, int j,
    const Scalars<T>& st, const T* __restrict__ omega0,
    const T* __restrict__ mean, const T* log_odds, T half_df_m1,
    bool use_max_size, int max_size) {
  using O = Ops<T>;
  const int d = p + 1;
  Flip<T> f;
  f.incl = mask[j] != 0;
  const T sjj = s[j * d + j];
  const T ojj = o[j * p + j];
  // -log max(-1/pivot, tiny) if j is in, else log max(pivot, tiny)
  const T la = O::log(clamp_tiny(f.incl ? O::div(T(-1), sjj) : sjj));
  const T lo = O::log(clamp_tiny(f.incl ? O::div(T(-1), ojj) : ojj));
  f.d_ld_a = f.incl ? -la : la;
  f.d_ld_o = f.incl ? -lo : lo;
  // the residual corner after the rank-1 sweep at j
  const T corner =
      O::sub(s[d * d - 1], O::div(O::mul(s[p * d + j], s[j * d + p]), sjj));
  f.dq = T(0);
  if (mean != nullptr) {
    // b_g' Omega_g b_g gains or loses the j terms (one thread: a nonzero
    // prior mean is the rare forced-in case)
    const T bj = mean[j];
    T acc = T(0);
    for (int i = 0; i < p; ++i)
      if (mask[i]) acc = O::add(acc, O::mul(omega0[j * p + i], mean[i]));
    const T cross = O::mul(bj, acc);
    const T own = O::mul(O::mul(bj, bj), omega0[j * p + j]);
    f.dq = f.incl ? -O::sub(O::mul(T(2), cross), own)
                  : O::add(O::mul(T(2), cross), own);
  }
  f.d_spike = f.incl ? -log_odds[j] : log_odds[j];
  const T ss = O::add(O::add(corner, st.q), f.dq);
  if (ss > T(0)) {
    const T ld = O::sub(O::add(st.logdet_o, f.d_ld_o),
                        O::add(st.logdet_a, f.d_ld_a));
    f.logp = O::sub(O::add(O::add(st.spike, f.d_spike), O::mul(T(0.5), ld)),
                    O::mul(half_df_m1, O::log(clamp_tiny(ss))));
  } else {
    f.logp = -INFINITY;
  }
  if (use_max_size && !f.incl && st.size >= max_size) f.logp = -INFINITY;
  return f;
}

template <typename T>
__device__ __forceinline__ void apply_scalars(Scalars<T>& st,
                                              const Flip<T>& f) {
  using O = Ops<T>;
  st.logdet_a = O::add(st.logdet_a, f.d_ld_a);
  st.logdet_o = O::add(st.logdet_o, f.d_ld_o);
  st.q = O::add(st.q, f.dq);
  st.spike = O::add(st.spike, f.d_spike);
  st.size += f.incl ? -1 : 1;
}

// Rows of a rank-1 update that a warp loads before it stores any of them.
constexpr int kRowBatch = 4;

// The rank-1 update of index k of the n x n matrix a in shared memory
// from its staged column `col` and row `row` (linalg/sweep.gated_flip_sweep's
// arithmetic in its order): a[i][j] -= (a[i][k] / pivot) a[k][j], row and
// column k scaled by sign / pivot, the corner -1 / pivot. A lane keeps two
// columns of `row`, j and j + 32, in registers and updates them in
// kRowBatch rows at a time (a warp's rows, a warp apart), all their loads
// issued before any store, so that the loads of a batch overlap; a row's
// a[i][k] / pivot is loaded and taken once for both columns. Every entry
// first gets the general formula; the threads that wrote row and column k
// then overwrite them (in program order, so no barrier), which keeps
// selects and predicates out of the loop.
template <typename T>
__device__ __forceinline__ void rank1_update(T* a, int n, int k, T sign,
                                             const T* col, const T* row) {
  using O = Ops<T>;
  const T inv = O::div(T(1), col[k]);
  const T edge = O::mul(sign, inv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int step = warps * n;  // entries from one of a warp's rows to the next
  for (int j = lane; j < n; j += 64) {
    const bool two = j + 32 < n;
    const T r0 = row[j];
    const T r1 = two ? row[j + 32] : T(0);
    int i = warp;
    T* at = a + i * n + j;
    for (; i + (kRowBatch - 1) * warps < n;
         i += kRowBatch * warps, at += kRowBatch * step) {
      T ci[kRowBatch], v0[kRowBatch], v1[kRowBatch];
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        ci[u] = col[i + u * warps];
        v0[u] = at[u * step];
        if (two) v1[u] = at[u * step + 32];
      }
#pragma unroll
      for (int u = 0; u < kRowBatch; ++u) {
        ci[u] = O::mul(ci[u], inv);
        at[u * step] = O::sub(v0[u], O::mul(ci[u], r0));
        if (two) at[u * step + 32] = O::sub(v1[u], O::mul(ci[u], r1));
      }
    }
    for (; i < n; i += warps, at += step) {
      const T ci = O::mul(col[i], inv);
      at[0] = O::sub(at[0], O::mul(ci, r0));
      if (two) at[32] = O::sub(at[32], O::mul(ci, r1));
    }
  }
  if (lane == (k & 31))  // column k, then (the corner last) row k
    for (int i = warp; i < n; i += warps) a[i * n + k] = O::mul(col[i], edge);
  if (warp == k % warps)
    for (int j = lane; j < n; j += 32)
      a[k * n + j] = j == k ? -inv : O::mul(row[j], edge);
}

// Stage row and column k of both S [d x d] and Omega [p x p], entries
// first, first + step, ... of the d + p of each.
template <typename T>
__device__ __forceinline__ void stage_k(const T* s, const T* o, int p, int k,
                                        T* col_s, T* row_s, T* col_o,
                                        T* row_o, int first, int step) {
  const int d = p + 1;
  for (int i = first; i < d + p; i += step) {
    if (i < d) {
      col_s[i] = s[i * d + k];
      row_s[i] = s[k * d + i];
    } else {
      const int m = i - d;
      col_o[m] = o[m * p + k];
      row_o[m] = o[k * p + m];
    }
  }
}

// The update of both from their staged rows and columns, then a barrier.
// Every thread must call it.
template <typename T>
__device__ __forceinline__ void rank1_updates(T* s, T* o, int p, int k,
                                              T sign, const T* col_s,
                                              const T* row_s,
                                              const T* col_o,
                                              const T* row_o) {
  rank1_update(s, p + 1, k, sign, col_s, row_s);
  rank1_update(o, p, k, sign, col_o, row_o);
  __syncthreads();
}

// Sweep (sign +1) or unsweep (sign -1) index k of both S and Omega with
// the whole block, in one pass: stage, one barrier, update, one barrier.
// Every thread must call it.
template <typename T>
__device__ void rank1_pass(T* s, T* o, int p, int k, T sign, T* col_s,
                           T* row_s, T* col_o, T* row_o) {
  stage_k(s, o, p, k, col_s, row_s, col_o, row_o,
          static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x));
  __syncthreads();
  rank1_updates(s, o, p, k, sign, col_s, row_s, col_o, row_o);
}

template <typename T>
__device__ __forceinline__ void copy_block(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// One element global -> shared without a register stage (cp.async, cached
// in L1); the caller commits, waits and meets a barrier before reading it.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(at),
               "l"(src), "n"(sizeof(T))
               : "memory");
#else
  std::memcpy(dst, src, sizeof(T));
#endif
}

// n elements global -> shared by the block (every chain reads the same S0
// and Omega, which L2 holds).
template <typename T>
__device__ __forceinline__ void copy_block_async(T* dst, const T* src,
                                                 int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) copy_async(dst + i,
                                                               src + i);
}

// S0 [d, d] of one chain whose border (row and column p = d - 1) is its
// own, edge [d] = (Omega b + X'y_c, prior_ss + y_c'y_c), and whose [p, p]
// block (Omega + X'X) every chain shares: the same asynchronous pass as
// copy_block_async, so the border is in place by the first barrier.
template <typename T>
__device__ __forceinline__ void copy_bordered_async(T* dst, const T* s0,
                                                    const T* edge, int d) {
  const int p = d - 1;
  for (int i = threadIdx.x; i < d * d; i += blockDim.x) {
    const int r = i / d, col = i - r * d;
    const T* src = r == p ? edge + col : (col == p ? edge + r : s0 + i);
    copy_async(dst + i, src);
  }
}

__device__ __forceinline__ void async_commit_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
#endif
}

// Shared-memory bytes of one chain: S and Omega (twice with the jump),
// their staging rows and columns, the flips' log uniforms, the jump's log
// acceptance uniform and the log inclusion odds (T); the walk's order and
// the flags (int); three masks and the flips' indices (bytes).
inline long long ssvs_smem_bytes(int p, bool jump, int item) {
  const long long d = p + 1;
  const long long mats = (d * d + (long long)p * p) * (jump ? 2 : 1);
  const long long stage = 2 * d + 2 * (long long)p;
  return (mats + stage + 2LL * p + 1) * item +
         4LL * (kJumpBudget + kFlags) + 4LL * p;
}

template <typename T, bool kJump>
__global__ void __launch_bounds__(kMaxThreads, (kMinBlocks<T, kJump>))
ssvs_sweep_kernel(
    const T* __restrict__ s0, const T* __restrict__ omega0,
    const T* __restrict__ mean, const T* __restrict__ log_odds,
    const T* __restrict__ consts, const T* __restrict__ logq,
    const T* __restrict__ log1mq, const T* __restrict__ qprobs,
    const unsigned char* __restrict__ mask_in,
    const long long* __restrict__ perm, const T* __restrict__ flip_u,
    const T* __restrict__ jump_u, const T* __restrict__ jump_acc,
    unsigned char* __restrict__ mask_out, const T* __restrict__ border,
    int p, int n_flips, int max_size) {
  using O = Ops<T>;
  BOOM_SHARED_BYTES(smem_raw);
  const int c = blockIdx.x;
  const int d = p + 1;
  const bool use_max = max_size >= 0;
  T* s = reinterpret_cast<T*>(smem_raw);
  T* o = s + d * d;
  T* s2 = o + p * p;  // the walk's copies (kJump)
  T* o2 = kJump ? s2 + d * d : s2;
  T* col_s = kJump ? o2 + p * p : s2;
  T* row_s = col_s + d;
  T* col_o = row_s + d;
  T* row_o = col_o + p;
  T* log_u = row_o + p;    // [n_flips] log flip_u
  T* log_acc = log_u + p;  // [1] log jump_acc (kJump)
  T* odds = log_acc + 1;   // [p] the prior's log inclusion odds
  int* order = reinterpret_cast<int*>(odds + p);
  int* flag = order + kJumpBudget;  // kFlags of them
  unsigned char* mask = reinterpret_cast<unsigned char*>(flag + kFlags);
  unsigned char* mask2 = mask + p;
  unsigned char* prop = mask2 + p;
  // [n_flips] perm (p < 256: shared memory holds no wider chain)
  unsigned char* flip_j = prop + p;

  // 0. the chain's state and all of its noise on chip: S0 and Omega
  // (shared by every chain; with `border`, S0's row and column p are the
  // chain's own) copied asynchronously while the block takes the logs of
  // the uniforms (logf / log, as torch.log)
  if (border == nullptr) {
    copy_block_async(s, s0, d * d);
  } else {
    copy_bordered_async(s, s0, border + static_cast<long long>(c) * d, d);
  }
  copy_block_async(o, omega0, p * p);
  const long long row0 = static_cast<long long>(c) * p;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    mask[i] = mask_in[row0 + i];
    odds[i] = log_odds[i];
    if (i < n_flips) {
      flip_j[i] = static_cast<unsigned char>(perm[row0 + i]);
      log_u[i] = O::log(flip_u[row0 + i]);
    }
    if (kJump) {
      prop[i] = jump_u[row0 + i] < qprobs[i];
      mask2[i] = mask[i];
    }
  }
  if (kJump && threadIdx.x == 0) log_acc[0] = O::log(jump_acc[c]);
  async_commit_wait_all();
  __syncthreads();

  const T half_df_m1 = O::sub(O::mul(T(0.5), consts[1]), T(1));
  const int lane = threadIdx.x & 31;
  const bool decider = threadIdx.x < 32;  // warp 0
  // warp 0's scalars, the same in every lane
  Scalars<T> st{T(0), T(0), T(0), T(0), 0};

  // 1. build: sweep every included coordinate, in index order
  for (int j = 0; j < p; ++j) {
    if (!mask[j]) continue;  // uniform across the block
    if (decider) {
      st.logdet_a = O::add(st.logdet_a, O::log(s[j * d + j]));
      st.logdet_o = O::add(st.logdet_o, O::log(o[j * p + j]));
      st.spike = O::add(st.spike, odds[j]);
      st.size += 1;
    }
    rank1_pass(s, o, p, j, T(1), col_s, row_s, col_o, row_o);
  }
  // every thread has read the mask before warp 0 may change it
  __syncthreads();
  T logp_cur = T(0);
  if (decider) {
    st.spike = O::add(st.spike, consts[0]);
    if (use_max && st.size > max_size) st.spike = -INFINITY;
    if (mean != nullptr) {
      // q = b_g' Omega b_g, row by row in index order
      T q = T(0);
      for (int i = 0; i < p; ++i) {
        if (!mask[i]) continue;
        T r = T(0);
        for (int k = 0; k < p; ++k)
          if (mask[k]) r = O::add(r, O::mul(omega0[i * p + k], mean[k]));
        q = O::add(q, O::mul(mean[i], r));
      }
      st.q = q;
    }
    const T ss = O::add(s[d * d - 1], st.q);
    logp_cur = O::sub(
        O::add(st.spike, O::mul(T(0.5), O::sub(st.logdet_o, st.logdet_a))),
        O::mul(half_df_m1, O::log(ss)));
  }

  // 2. the mode-jump walk on copies; accepted, the copies become the state
  if (kJump) {
    const int budget = p < kJumpBudget ? p : kJumpBudget;
    if (decider) {
      // the coordinates where the proposal differs, ascending, a ballot of
      // 32 at a time
      int n_diff = 0;
      for (int base = 0; base < p; base += 32) {
        const int i = base + lane;
        const bool differ = i < p && prop[i] != mask[i];
        const unsigned bits = __ballot_sync(kFullWarp, differ);
        const int at = n_diff + __popc(bits & ((1u << lane) - 1u));
        if (differ && at < kJumpBudget) order[at] = i;
        n_diff += __popc(bits);
      }
      if (lane == 0)
        flag[kWalkLen] = n_diff > 0 && n_diff <= budget ? n_diff : 0;
    }
    __syncthreads();
    const int n_walk = flag[kWalkLen];
    if (n_walk > 0) {
      copy_block(s2, s, d * d);
      copy_block(o2, o, p * p);
      __syncthreads();
      Scalars<T> st2 = st;
      T logp_prop = logp_cur;
      for (int step = 0; step < n_walk; ++step) {
        const int j = order[step];
        // the walk sets coordinate j to the proposal's value
        const T sign = prop[j] ? T(1) : T(-1);
        if (decider) {
          const Flip<T> f = flip_deltas(s2, o2, mask2, p, j, st2, omega0,
                                        mean, odds, half_df_m1, false, 0);
          logp_prop = f.logp;
          apply_scalars(st2, f);
        }
        rank1_pass(s2, o2, p, j, sign, col_s, row_s, col_o, row_o);
        if (decider) {
          if (lane == 0) mask2[j] = prop[j];
          __syncwarp();
        }
      }
      if (decider) {
        if (use_max && st2.size > max_size) logp_prop = -INFINITY;
        // log q(g) (lane 0) and log q(g') (lane 1), each summed in index
        // order
        const unsigned char* g = lane == 0 ? mask : prop;
        T lq = T(0);
        if (lane < 2) {
          for (int i = 0; i < p; ++i) {
            const T m = g[i] ? T(1) : T(0);
            lq = O::add(lq, O::add(O::mul(m, logq[i]),
                                   O::mul(O::sub(T(1), m), log1mq[i])));
          }
        }
        const T lq_cur = __shfl_sync(kFullWarp, lq, 0);
        const T lq_prop = __shfl_sync(kFullWarp, lq, 1);
        const T log_ratio =
            O::sub(O::add(O::sub(logp_prop, logp_cur), lq_cur), lq_prop);
        const bool take = log_acc[0] < log_ratio;
        if (take) {
          st = st2;
          logp_cur = logp_prop;
        }
        if (lane == 0) flag[kJumpTake] = take;
      }
      __syncthreads();
      if (flag[kJumpTake]) {
        T* t = s;
        s = s2;
        s2 = t;
        t = o;
        o = o2;
        o2 = t;
        for (int i = threadIdx.x; i < p; i += blockDim.x) mask[i] = mask2[i];
        __syncthreads();
      }
    }
  }

  // 3. the random-order Gibbs flips: warp 0 decides the next 32 flips at
  // once, a lane a flip, on the current state. Every flip before the first
  // one taken sees the state it would have seen in order, so its decision
  // stands; the first one taken is applied: warp 0 stages its row and
  // column and meets the block only then, the block updates and meets once
  // more, and warp 0 decides again from the flip after it.
  int f = 0;  // warp 0's next flip
  for (;;) {
    if (decider) {
      int take_j = -1, take_incl = 0;
      while (f < n_flips) {
        const int mine = f + lane;
        int j = 0;
        Flip<T> fl{};
        bool take = false;
        if (mine < n_flips) {
          j = flip_j[mine];
          fl = flip_deltas(s, o, mask, p, j, st, omega0, mean, odds,
                           half_df_m1, use_max, max_size);
          take = log_u[mine] < log_sigmoid(O::sub(fl.logp, logp_cur));
        }
        const unsigned bits = __ballot_sync(kFullWarp, take);
        if (bits == 0) {
          f += 32;
          continue;
        }
        const int first = __ffs(static_cast<int>(bits)) - 1;
        j = __shfl_sync(kFullWarp, j, first);
        fl.incl = mask[j] != 0;
        fl.d_ld_a = __shfl_sync(kFullWarp, fl.d_ld_a, first);
        fl.d_ld_o = __shfl_sync(kFullWarp, fl.d_ld_o, first);
        if (mean != nullptr) fl.dq = __shfl_sync(kFullWarp, fl.dq, first);
        fl.d_spike = fl.incl ? -odds[j] : odds[j];
        fl.logp = __shfl_sync(kFullWarp, fl.logp, first);
        f += first + 1;
        apply_scalars(st, fl);
        logp_cur = fl.logp;
        __syncwarp();  // every lane has read the mask
        if (lane == 0) mask[j] = !fl.incl;
        stage_k(s, o, p, j, col_s, row_s, col_o, row_o, lane, 32);
        take_j = j;
        take_incl = fl.incl;
        break;
      }
      if (lane == 0) {
        flag[kFlipJ] = take_j;
        flag[kFlipIncl] = take_incl;
      }
    }
    __syncthreads();
    const int j = flag[kFlipJ];
    if (j < 0) break;  // uniform across the block
    const T sign = flag[kFlipIncl] ? T(-1) : T(1);
    rank1_updates(s, o, p, j, sign, col_s, row_s, col_o, row_o);
  }

  // 4. the new mask (the last barrier orders warp 0's writes before these
  // reads)
  for (int i = threadIdx.x; i < p; i += blockDim.x)
    mask_out[row0 + i] = mask[i];
}

template <typename T>
int launch_sweep(const void* s0, const void* omega, const void* mean,
                 const void* log_odds, const void* consts, const void* logq,
                 const void* log1mq, const void* qprobs, const void* mask_in,
                 const void* perm, const void* flip_u, const void* jump_u,
                 const void* jump_acc, void* mask_out, const void* border,
                 int chains, int p, int n_flips, int max_size, int threads,
                 void* stream) {
  const bool jump = qprobs != nullptr;
  if (chains < 0 || p < 1 || n_flips < 0 || n_flips > p || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chains == 0) return 0;
  const long long bytes = ssvs_smem_bytes(p, jump, sizeof(T));
  if (bytes > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = jump ? ssvs_sweep_kernel<T, true> : ssvs_sweep_kernel<T, false>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int smem = static_cast<int>(bytes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<chains, threads, smem, st>>>(
      static_cast<const T*>(s0), static_cast<const T*>(omega),
      static_cast<const T*>(mean), static_cast<const T*>(log_odds),
      static_cast<const T*>(consts), static_cast<const T*>(logq),
      static_cast<const T*>(log1mq), static_cast<const T*>(qprobs),
      static_cast<const unsigned char*>(mask_in),
      static_cast<const long long*>(perm), static_cast<const T*>(flip_u),
      static_cast<const T*>(jump_u), static_cast<const T*>(jump_acc),
      static_cast<unsigned char*>(mask_out), static_cast<const T*>(border),
      p, n_flips, max_size);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries. Arrays are contiguous device arrays of the entry's type:
// s0 [(p+1)^2] (the augmented matrix), omega [p^2], log_odds [p], consts [2]
// (log_inclusion_norm, df); mean [p] or nullptr (a zero prior mean);
// logq, log1mq, qprobs [p] or all nullptr (no mode jump); per chain:
// mask_in, mask_out [C, p] bytes, perm [C, p] int64, flip_u [C, p], jump_u
// [C, p], jump_acc [C] (the last two read only with a mode jump). n_flips
// flips of each chain's perm; max_size < 0 for no bound on the model size.
// border [C, p+1] or nullptr: row and column p of each chain's S0 (bsts,
// where every chain regresses its own residual: X'y and y'y per chain, X'X
// shared), in place of s0's own row and column p, which are then not read;
// nullptr for one S0 of every chain. Returns a cudaError_t (0 on success).
#define BOOM_SSVS_ENTRY(TY, TYNAME)                                          \
  extern "C" int boom_ssvs_sweep_##TYNAME(                                   \
      const void* s0, const void* omega, const void* mean,                   \
      const void* log_odds, const void* consts, const void* logq,            \
      const void* log1mq, const void* qprobs, const void* mask_in,           \
      const void* perm, const void* flip_u, const void* jump_u,              \
      const void* jump_acc, void* mask_out, const void* border, int chains,  \
      int p, int n_flips, int max_size, int threads, void* stream) {         \
    return launch_sweep<TY>(s0, omega, mean, log_odds, consts, logq, log1mq, \
                            qprobs, mask_in, perm, flip_u, jump_u, jump_acc, \
                            mask_out, border, chains, p, n_flips, max_size,  \
                            threads, stream);                                \
  }

BOOM_SSVS_ENTRY(float, f32)
BOOM_SSVS_ENTRY(double, f64)

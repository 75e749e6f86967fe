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
// included coordinates in the build, the flips taken); what each flip
// always costs is a chain of dependent scalar operations (two logs of
// pivots, the residual corner, the log of its sum of squares, the log
// sigmoid) and one barrier. So the kernel is latency-bound on that chain,
// and its design keeps everything else off it:
//   - S [(p+1)^2] and Omega's swept copy [p^2] live in shared memory for the
//     whole sweep (20.4 KB at p = 50 in float32, 40.8 KB in float64), full
//     storage: the plain version updates both triangles with the same
//     formula, and they differ by rounding, so a triangle would lose
//     agreement with it; full storage fits p <= 119 (float64) and 170
//     (float32) in 227 KB, or half that with the mode-jump walk's copy;
//   - thread 0 computes each flip's scalars (the `_flip_deltas` of the
//     reference) from shared memory and broadcasts the decision; a branch
//     that is uniform across the block replaces the reference's gated
//     full-matrix pass: only a flip that is taken stages row and column k
//     and makes the rank-1 update with all threads (a warp a row);
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

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
// the mode-jump walk's Hamming budget (regression_sweep.MODE_JUMP_BUDGET)
constexpr int kJumpBudget = 16;
// thread 0's broadcasts: each flip's (take, index, sign) in two slots by the
// flip's parity (a slot is rewritten only after every thread has passed
// the next flip's barrier), then the walk's length, the jump's decision
// and a walk step's sign
constexpr int kFlags = 9;
constexpr int kWalkLen = 6, kJumpTake = 7, kWalkSign = 8;

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

// The chain's scalar state (thread 0 keeps it in registers).
template <typename T>
struct Scalars {
  T logdet_a, logdet_o, q, spike;
  int size;
};

// What one flip at j would give (regression_sweep._flip_deltas and the
// flip's log model probability), computed by thread 0 from shared memory.
template <typename T>
struct Flip {
  bool incl;
  T d_ld_a, d_ld_o, dq, d_spike, logp;
};

template <typename T>
__device__ __forceinline__ Flip<T> flip_deltas(
    const T* s, const T* o, const unsigned char* mask, int p, int j,
    const Scalars<T>& st, const T* __restrict__ omega0,
    const T* __restrict__ mean, const T* __restrict__ log_odds, T half_df_m1,
    bool use_max_size, int max_size) {
  using O = Ops<T>;
  const int d = p + 1;
  Flip<T> f;
  f.incl = mask[j] != 0;
  const T sjj = s[j * d + j];
  const T ojj = o[j * p + j];
  f.d_ld_a = f.incl ? -O::log(clamp_tiny(O::div(T(-1), sjj)))
                    : O::log(clamp_tiny(sjj));
  f.d_ld_o = f.incl ? -O::log(clamp_tiny(O::div(T(-1), ojj)))
                    : O::log(clamp_tiny(ojj));
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

// Sweep (sign +1) or unsweep (sign -1) index k of the n x n matrix a in
// shared memory with the whole block: stage row and column k, then
// a[i][j] -= (a[i][k] / pivot) a[k][j], row and column k scaled by
// sign / pivot, the corner -1 / pivot (linalg/sweep.gated_flip_sweep's
// arithmetic in its order). `col`, `row` are n-entry staging buffers.
// Every thread must call it; it ends in a barrier.
template <typename T>
__device__ void rank1_flip(T* a, int n, int k, T sign, T* col, T* row) {
  using O = Ops<T>;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    col[i] = a[i * n + k];
    row[i] = a[k * n + i];
  }
  __syncthreads();
  const T inv = O::div(T(1), col[k]);
  const T edge = O::mul(sign, inv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = (blockDim.x + 31) >> 5;
  for (int i = warp; i < n; i += warps) {
    const T ci = O::mul(col[i], inv);
    for (int j = lane; j < n; j += 32) {
      T v;
      if (i == k)
        v = j == k ? -inv : O::mul(row[j], edge);
      else if (j == k)
        v = O::mul(col[i], edge);
      else
        v = O::sub(a[i * n + j], O::mul(ci, row[j]));
      a[i * n + j] = v;
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void copy_block(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Shared-memory layout of one chain (offsets in elements of T, then bytes).
inline long long ssvs_smem_bytes(int p, bool jump,
                                                     int item) {
  const long long d = p + 1;
  const long long mats = (d * d + (long long)p * p) * (jump ? 2 : 1);
  const long long stage = 2 * d + 2 * (long long)p;
  return (mats + stage) * item + 3LL * p + 4 + 4 * (kJumpBudget + kFlags);
}

template <typename T, bool kJump>
__global__ void __launch_bounds__(kMaxThreads) ssvs_sweep_kernel(
    const T* __restrict__ s0, const T* __restrict__ omega0,
    const T* __restrict__ mean, const T* __restrict__ log_odds,
    const T* __restrict__ consts, const T* __restrict__ logq,
    const T* __restrict__ log1mq, const T* __restrict__ qprobs,
    const unsigned char* __restrict__ mask_in,
    const long long* __restrict__ perm, const T* __restrict__ flip_u,
    const T* __restrict__ jump_u, const T* __restrict__ jump_acc,
    unsigned char* __restrict__ mask_out, int p, int n_flips,
    int max_size) {
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
  unsigned char* mask = reinterpret_cast<unsigned char*>(row_o + p);
  unsigned char* mask2 = mask + p;
  unsigned char* prop = mask2 + p;
  int* order = reinterpret_cast<int*>(
      (reinterpret_cast<unsigned long long>(prop + p) + 3) & ~3ULL);
  int* flag = order + kJumpBudget;  // kFlags of them

  copy_block(s, s0, d * d);
  copy_block(o, omega0, p * p);
  for (int i = threadIdx.x; i < p; i += blockDim.x)
    mask[i] = mask_in[static_cast<long long>(c) * p + i];
  __syncthreads();

  const T half_df_m1 = O::sub(O::mul(T(0.5), consts[1]), T(1));
  Scalars<T> st{T(0), T(0), T(0), T(0), 0};  // thread 0's

  // 1. build: sweep every included coordinate, in index order
  for (int j = 0; j < p; ++j) {
    if (!mask[j]) continue;  // uniform across the block
    if (threadIdx.x == 0) {
      st.logdet_a = O::add(st.logdet_a, O::log(s[j * d + j]));
      st.logdet_o = O::add(st.logdet_o, O::log(o[j * p + j]));
      st.spike = O::add(st.spike, log_odds[j]);
      st.size += 1;
    }
    rank1_flip(s, d, j, T(1), col_s, row_s);
    rank1_flip(o, p, j, T(1), col_o, row_o);
  }
  // every thread has read the mask before thread 0 may change it
  __syncthreads();
  T logp_cur = T(0);
  if (threadIdx.x == 0) {
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
    if (threadIdx.x == 0) {
      int n_diff = 0;
      for (int i = 0; i < p; ++i) {
        prop[i] = jump_u[static_cast<long long>(c) * p + i] < qprobs[i];
        mask2[i] = mask[i];
        if (prop[i] != mask[i]) {
          if (n_diff < kJumpBudget) order[n_diff] = i;
          ++n_diff;
        }
      }
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
        if (threadIdx.x == 0) {
          const Flip<T> f = flip_deltas(s2, o2, mask2, p, j, st2, omega0,
                                        mean, log_odds, half_df_m1, false, 0);
          logp_prop = f.logp;
          apply_scalars(st2, f);
          flag[kWalkSign] = f.incl;
          mask2[j] = !f.incl;
        }
        __syncthreads();
        const T sign = flag[kWalkSign] ? T(-1) : T(1);
        rank1_flip(s2, d, j, sign, col_s, row_s);
        rank1_flip(o2, p, j, sign, col_o, row_o);
      }
      if (threadIdx.x == 0) {
        if (use_max && st2.size > max_size) logp_prop = -INFINITY;
        // log q(g) - log q(g'), each summed in index order
        T lq_cur = T(0), lq_prop = T(0);
        for (int i = 0; i < p; ++i) {
          const T mc = mask[i] ? T(1) : T(0);
          const T mp = prop[i] ? T(1) : T(0);
          lq_cur = O::add(lq_cur, O::add(O::mul(mc, logq[i]),
                                         O::mul(O::sub(T(1), mc), log1mq[i])));
          lq_prop = O::add(lq_prop,
                           O::add(O::mul(mp, logq[i]),
                                  O::mul(O::sub(T(1), mp), log1mq[i])));
        }
        const T log_ratio =
            O::sub(O::add(O::sub(logp_prop, logp_cur), lq_cur), lq_prop);
        const bool take = O::log(jump_acc[c]) < log_ratio;
        if (take) {
          st = st2;
          logp_cur = logp_prop;
        }
        flag[kJumpTake] = take;
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

  // 3. the random-order Gibbs flips
  for (int f = 0; f < n_flips; ++f) {
    int* slot = flag + 3 * (f & 1);
    if (threadIdx.x == 0) {
      const long long at = static_cast<long long>(c) * p + f;
      const int j = static_cast<int>(perm[at]);
      const Flip<T> fl = flip_deltas(s, o, mask, p, j, st, omega0, mean,
                                     log_odds, half_df_m1, use_max,
                                     max_size);
      const bool take =
          O::log(flip_u[at]) < log_sigmoid(O::sub(fl.logp, logp_cur));
      if (take) {
        apply_scalars(st, fl);
        logp_cur = fl.logp;
        mask[j] = !fl.incl;
      }
      slot[0] = take;
      slot[1] = j;
      slot[2] = fl.incl;
    }
    __syncthreads();
    if (slot[0]) {  // uniform across the block
      const int j = slot[1];
      const T sign = slot[2] ? T(-1) : T(1);
      rank1_flip(s, d, j, sign, col_s, row_s);
      rank1_flip(o, p, j, sign, col_o, row_o);
    }
  }

  // 4. the new mask (rank1_flip's barrier, or the last flip's, orders
  // thread 0's writes before these reads)
  __syncthreads();
  for (int i = threadIdx.x; i < p; i += blockDim.x)
    mask_out[static_cast<long long>(c) * p + i] = mask[i];
}

template <typename T>
int launch_sweep(const void* s0, const void* omega, const void* mean,
                 const void* log_odds, const void* consts, const void* logq,
                 const void* log1mq, const void* qprobs, const void* mask_in,
                 const void* perm, const void* flip_u, const void* jump_u,
                 const void* jump_acc, void* mask_out, int chains, int p,
                 int n_flips, int max_size, int threads, void* stream) {
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
      static_cast<unsigned char*>(mask_out), p, n_flips, max_size);
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
// Returns a cudaError_t (0 on success).
#define BOOM_SSVS_ENTRY(TY, TYNAME)                                          \
  extern "C" int boom_ssvs_sweep_##TYNAME(                                   \
      const void* s0, const void* omega, const void* mean,                   \
      const void* log_odds, const void* consts, const void* logq,            \
      const void* log1mq, const void* qprobs, const void* mask_in,           \
      const void* perm, const void* flip_u, const void* jump_u,              \
      const void* jump_acc, void* mask_out, int chains, int p, int n_flips,  \
      int max_size, int threads, void* stream) {                             \
    return launch_sweep<TY>(s0, omega, mean, log_odds, consts, logq, log1mq, \
                            qprobs, mask_in, perm, flip_u, jump_u, jump_acc, \
                            mask_out, chains, p, n_flips, max_size, threads, \
                            stream);                                         \
  }

BOOM_SSVS_ENTRY(float, f32)
BOOM_SSVS_ENTRY(double, f64)

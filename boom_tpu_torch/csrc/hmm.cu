// The hidden Markov model's forward filter and backward sampler,
// hand-written for Hopper (sm_90a): a lane a chain walks the T steps.
//
// Replaces the reference's XLA time scans (not Pallas kernels):
//   H1 `forward_kernel`: boom_tpu/models/hmm.py `forward_filter` (:32-55,
//      its lax.scan at :52), the normalised log alphas and the loglike of
//      every chain.
//   H2 `backward_kernel`: `backward_sample` (:58-74, the reverse lax.scan at
//      :72) fused with the sweep's statistics of the path (:168-182, the
//      one-hot matmuls): z, and per state n, sum y and sum y^2, the
//      transition counts and the first state's one-hot.
// The plain PyTorch versions are boom_tpu_torch/models/hmm.py.
//
// Layout. One block is one warp of 32 chains (of C when C < 32), lane c its
// chain; S (1..16) is a template parameter, so a chain's S alphas live in
// registers. The
// other layout, S lanes a chain exchanging alphas by shuffle, fills more
// lanes at S = 2 but puts S shuffles on every step's dependent chain; a
// lane a chain has none, and no value crosses lanes, so repeated launches
// are bit-identical. A chain's step is a dependent chain of S log-sum-exps
// (an exp a term, a log a sum) and the normaliser, so at 4,096 chains (128
// warps, fewer than one an SM) the kernels are latency bound, far above
// the bytes they move (PERF.md, Findings).
//
// Staging. The per-step streams are [C, T, S] rows, so a chain's chunk of
// steps is one contiguous run and the lanes' runs are T S apart. The warp
// copies each chain's next chunk (kRow elements: 256 bytes, S whole steps)
// into shared memory with element-wise cp.async while it computes the
// current one, double-buffered; each lane then reads its own row (rows
// padded to kRow + 1 elements, so the lanes' reads fall in distinct
// banks). H1 writes its alphas through a buffer of the same shape, a row a
// chain, so that each store instruction writes one chain's run; H2 writes z
// the same way.
//
// Numerics follow the plain version step for step: the max-shifted
// log-sum-exp log(sum exp(x - m)) + m (an all -inf row gives -inf), la =
// pred + ll_t, then la - norm and total + norm; H2's logits are (la_t +
// log_trans[i, z_{t+1}]) - log(-log u_t) and the first largest wins, as
// argmax. In float64 the results match the plain version to rounding of
// the sums' order and the paths are identical; float32 keeps the dtype's
// exp and log (no intrinsics). H2 accumulates sum y and sum y^2 in double
// and counts in integers, then writes them in the dtype.

#include <cmath>
#include <cstring>

#include <cuda_runtime.h>

namespace {

#ifndef __CUDACC__
using std::exp;
using std::isinf;
using std::log;
#endif

constexpr int kWarp = 32;
// the bytes of a chain's row of a staged chunk
constexpr int kRowBytes = 256;
// a block's dynamic shared memory past which the launch must opt in
constexpr int kDefaultSmem = 48 * 1024;

#ifndef BOOM_SHARED_BYTES
#define BOOM_SHARED_BYTES(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(gmem)
                 : "memory");
  }
#else
  std::memcpy(smem, gmem, sizeof(T));
#endif
}

__device__ __forceinline__ void async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Steps a chunk and the padded row of a staged chunk.
template <typename T, int S>
struct Chunk {
  static constexpr int kSteps =
      kRowBytes / static_cast<int>(sizeof(T)) / S > 0
          ? kRowBytes / static_cast<int>(sizeof(T)) / S
          : 1;
  static constexpr int kRow = kSteps * S;
  static constexpr int kPitch = kRow + 1;
  // one buffer: the warp's 32 rows
  static constexpr int kBuf = kWarp * kPitch;
};

// The block's lanes copy steps [t0, t0 + n) of every chain of the block
// from the [C, T, S] stream src into buf (a row a chain), one element a
// lane a copy.
template <typename T, int S>
__device__ __forceinline__ void stage(T* buf, const T* src, int base,
                                      int chains, int t_len, int t0, int n,
                                      int lane, int lanes) {
  using C = Chunk<T, S>;
  const int len = n * S;
  for (int r = 0; r < lanes && base + r < chains; ++r) {
    const T* row = src + (static_cast<size_t>(base + r) * t_len + t0) * S;
    for (int e = lane; e < len; e += lanes)
      copy_async(buf + r * C::kPitch + e, row + e);
  }
  async_commit();
}

// log(sum exp(x_i)) as torch.logsumexp: shifted by the largest finite
// value (by 0 when it is infinite).
template <typename T, int S>
__device__ __forceinline__ T log_sum_exp(const T (&x)[S]) {
  T m = x[0];
#pragma unroll
  for (int i = 1; i < S; ++i) m = x[i] > m ? x[i] : m;
  const T shift = isinf(m) ? T(0) : m;
  T s = exp(x[0] - shift);
#pragma unroll
  for (int i = 1; i < S; ++i) s = s + exp(x[i] - shift);
  return log(s) + shift;
}

// log_trans of one chain: in registers up to S = 8, else read from global
// memory through the cache (an f64 [16, 16] would take 512 registers).
template <typename T, int S, bool kRegs = (S <= 8)>
struct Trans;

template <typename T, int S>
struct Trans<T, S, true> {
  T v[S][S];
  __device__ __forceinline__ explicit Trans(const T* lt) {
#pragma unroll
    for (int i = 0; i < S; ++i)
#pragma unroll
      for (int j = 0; j < S; ++j) v[i][j] = lt[i * S + j];
  }
  __device__ __forceinline__ T operator()(int i, int j) const {
    return v[i][j];
  }
  // column j, j known only at run time: a select a row
  __device__ __forceinline__ T col(int i, int j) const {
    T out = v[i][0];
#pragma unroll
    for (int k = 1; k < S; ++k) out = j == k ? v[i][k] : out;
    return out;
  }
};

template <typename T, int S>
struct Trans<T, S, false> {
  const T* __restrict__ p;
  __device__ __forceinline__ explicit Trans(const T* lt) : p(lt) {}
  __device__ __forceinline__ T operator()(int i, int j) const {
    return p[i * S + j];
  }
  __device__ __forceinline__ T col(int i, int j) const {
    return p[i * S + j];
  }
};

// ---- H1 ------------------------------------------------------------------

template <typename T, int S>
struct ForwardSmem {
  using C = Chunk<T, S>;
  // two input buffers, then the alphas' output buffer
  static constexpr int kBytes = 3 * C::kBuf * static_cast<int>(sizeof(T));
};

// log_lik [C, T, S], log_trans [C, S, S], log_init [C, S] -> alphas [C, T,
// S] (nullptr: not written) and loglike [C].
template <typename T, int S>
__global__ void __launch_bounds__(kWarp)
    forward_kernel(const T* __restrict__ log_lik,
                   const T* __restrict__ log_trans,
                   const T* __restrict__ log_init, T* __restrict__ alphas,
                   T* __restrict__ loglike, int chains, int t_len) {
  using C = Chunk<T, S>;
  BOOM_SHARED_BYTES(smem_raw);
  T* in = reinterpret_cast<T*>(smem_raw);  // [2][kWarp][kPitch]
  T* out = in + 2 * C::kBuf;               // [kWarp][kPitch]
  const int lane = threadIdx.x;
  const int lanes = blockDim.x;
  const unsigned mask = lanes == kWarp ? 0xffffffffu : (1u << lanes) - 1u;
  const int base = blockIdx.x * lanes;
  const int c = base + lane;
  const bool active = c < chains;
  const int n_chunks = (t_len + C::kSteps - 1) / C::kSteps;

  T la[S];
  T total(0);
  const Trans<T, S> lt(log_trans + static_cast<size_t>(active ? c : 0) * S *
                                       S);
  if (active) {
#pragma unroll
    for (int s = 0; s < S; ++s) la[s] = log_init[static_cast<size_t>(c) * S + s];
  }

  stage<T, S>(in, log_lik, base, chains, t_len, 0,
              t_len < C::kSteps ? t_len : C::kSteps, lane, lanes);
  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * C::kSteps;
    const int n = t_len - t0 < C::kSteps ? t_len - t0 : C::kSteps;
    if (k + 1 < n_chunks) {
      const int t1 = t0 + C::kSteps;
      stage<T, S>(in + ((k + 1) & 1) * C::kBuf, log_lik, base, chains,
                  t_len, t1, t_len - t1 < C::kSteps ? t_len - t1 : C::kSteps,
                  lane, lanes);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncwarp(mask);
    const T* row = in + (k & 1) * C::kBuf + lane * C::kPitch;
    if (active) {
      for (int tt = 0; tt < n; ++tt) {
        T cur[S];
        if (t0 + tt == 0) {
#pragma unroll
          for (int s = 0; s < S; ++s) cur[s] = la[s] + row[s];
        } else {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            T terms[S];
#pragma unroll
            for (int i = 0; i < S; ++i) terms[i] = la[i] + lt(i, j);
            cur[j] = log_sum_exp<T, S>(terms) + row[tt * S + j];
          }
        }
        const T norm = log_sum_exp<T, S>(cur);
#pragma unroll
        for (int s = 0; s < S; ++s) la[s] = cur[s] - norm;
        total = total + norm;
        if (alphas != nullptr) {
#pragma unroll
          for (int s = 0; s < S; ++s) out[lane * C::kPitch + tt * S + s] = la[s];
        }
      }
    }
    __syncwarp(mask);
    if (alphas != nullptr) {
      for (int r = 0; r < lanes && base + r < chains; ++r) {
        T* dst = alphas + (static_cast<size_t>(base + r) * t_len + t0) * S;
        for (int e = lane; e < n * S; e += lanes)
          dst[e] = out[r * C::kPitch + e];
      }
      __syncwarp(mask);
    }
  }
  if (active) loglike[c] = total;
}

// ---- H2 ------------------------------------------------------------------

template <typename T, int S>
struct BackwardSmem {
  using C = Chunk<T, S>;
  // two buffers each of the alphas and the uniforms
  static constexpr int kStreams = 4 * C::kBuf * static_cast<int>(sizeof(T));
  // two chunks of y
  static constexpr int kY = 2 * C::kSteps * static_cast<int>(sizeof(T));
  // the path's output buffer, a row a chain
  static constexpr int kZ = kWarp * (C::kSteps + 1) * 4;
  // the transition counts, [S * S][kWarp] (a lane's column)
  static constexpr int kCounts = S * S * kWarp * 4;
  static constexpr int kBytes = kStreams + kY + kZ + kCounts;
};

// log_alphas [C, T, S], log_trans [C, S, S], y [T], path_u [C, T, S] ->
// z [C, T] int32, n, sum y, sum y^2 [C, S], counts [C, S, S] (from, to),
// first [C, S] (z_0's one-hot).
template <typename T, int S>
__global__ void __launch_bounds__(kWarp)
    backward_kernel(const T* __restrict__ alphas,
                    const T* __restrict__ log_trans, const T* __restrict__ y,
                    const T* __restrict__ path_u, int* __restrict__ z_out,
                    T* __restrict__ n_out, T* __restrict__ sum_out,
                    T* __restrict__ sumsq_out, T* __restrict__ counts_out,
                    T* __restrict__ first_out, int chains, int t_len) {
  using C = Chunk<T, S>;
  using Sm = BackwardSmem<T, S>;
  BOOM_SHARED_BYTES(smem_raw);
  T* la_buf = reinterpret_cast<T*>(smem_raw);  // [2][kWarp][kPitch]
  T* u_buf = la_buf + 2 * C::kBuf;             // [2][kWarp][kPitch]
  T* y_buf = u_buf + 2 * C::kBuf;              // [2][kSteps]
  int* z_buf = reinterpret_cast<int*>(smem_raw + Sm::kStreams + Sm::kY);
  int* cnt = z_buf + kWarp * (C::kSteps + 1);  // [S * S][kWarp]
  const int lane = threadIdx.x;
  const int lanes = blockDim.x;
  const unsigned mask = lanes == kWarp ? 0xffffffffu : (1u << lanes) - 1u;
  const int base = blockIdx.x * lanes;
  const int c = base + lane;
  const bool active = c < chains;
  const int n_chunks = (t_len + C::kSteps - 1) / C::kSteps;

  for (int i = 0; i < S * S; ++i) cnt[i * kWarp + lane] = 0;
  const Trans<T, S> lt(log_trans + static_cast<size_t>(active ? c : 0) * S *
                                       S);
  int n[S];
  double sum[S], sumsq[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    n[s] = 0;
    sum[s] = 0.0;
    sumsq[s] = 0.0;
  }

  auto stage_chunk = [&](int k) {
    const int t0 = k * C::kSteps;
    const int m = t_len - t0 < C::kSteps ? t_len - t0 : C::kSteps;
    const int b = k & 1;
    for (int e = lane; e < m; e += lanes)
      copy_async(y_buf + b * C::kSteps + e, y + t0 + e);
    stage<T, S>(la_buf + b * C::kBuf, alphas, base, chains, t_len, t0, m,
                lane, lanes);
    stage<T, S>(u_buf + b * C::kBuf, path_u, base, chains, t_len, t0, m,
                lane, lanes);
  };

  int z_next = 0;
  stage_chunk(n_chunks - 1);
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * C::kSteps;
    const int m = t_len - t0 < C::kSteps ? t_len - t0 : C::kSteps;
    if (k > 0) {
      stage_chunk(k - 1);
      async_wait<2>();  // each chunk commits two groups
    } else {
      async_wait<0>();
    }
    __syncwarp(mask);
    const int b = k & 1;
    const T* la_row = la_buf + b * C::kBuf + lane * C::kPitch;
    const T* u_row = u_buf + b * C::kBuf + lane * C::kPitch;
    if (active) {
      for (int tt = m - 1; tt >= 0; --tt) {
        const int t = t0 + tt;
        const bool last = t == t_len - 1;
        int best = 0;
        T best_v(0);
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const T g = log(-log(u_row[tt * S + i]));
          const T logit = last ? la_row[tt * S + i]
                               : la_row[tt * S + i] + lt.col(i, z_next);
          const T v = logit - g;
          if (i == 0 || v > best_v) {
            best = i;
            best_v = v;
          }
        }
        const double yt = static_cast<double>(y_buf[b * C::kSteps + tt]);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s == best) {
            n[s] += 1;
            sum[s] += yt;
            sumsq[s] += yt * yt;
          }
        }
        if (!last) cnt[(best * S + z_next) * kWarp + lane] += 1;
        z_buf[lane * (C::kSteps + 1) + tt] = best;
        z_next = best;
      }
    }
    __syncwarp(mask);
    for (int r = 0; r < lanes && base + r < chains; ++r) {
      int* dst = z_out + static_cast<size_t>(base + r) * t_len + t0;
      for (int e = lane; e < m; e += lanes)
        dst[e] = z_buf[r * (C::kSteps + 1) + e];
    }
    __syncwarp(mask);
  }
  if (!active) return;
  const size_t cs = static_cast<size_t>(c) * S;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    n_out[cs + s] = static_cast<T>(n[s]);
    sum_out[cs + s] = static_cast<T>(sum[s]);
    sumsq_out[cs + s] = static_cast<T>(sumsq[s]);
    first_out[cs + s] = static_cast<T>(s == z_next ? 1 : 0);
  }
  for (int i = 0; i < S * S; ++i)
    counts_out[cs * S + i] = static_cast<T>(cnt[i * kWarp + lane]);
}

template <typename T, int S>
int launch_forward_s(const void* log_lik, const void* log_trans,
                     const void* log_init, void* alphas, void* loglike,
                     int chains, int t_len, void* stream) {
  auto kernel = forward_kernel<T, S>;
  // a warp of chains a block, or the C < 32 chains
  const int lanes = chains < kWarp ? chains : kWarp;
  const int blocks = (chains + lanes - 1) / lanes;
  const int smem = ForwardSmem<T, S>::kBytes;
  if (smem > kDefaultSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, lanes, smem, st>>>(
      static_cast<const T*>(log_lik), static_cast<const T*>(log_trans),
      static_cast<const T*>(log_init), static_cast<T*>(alphas),
      static_cast<T*>(loglike), chains, t_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S>
int launch_backward_s(const void* alphas, const void* log_trans,
                      const void* y, const void* path_u, void* z, void* n,
                      void* sum, void* sumsq, void* counts, void* first,
                      int chains, int t_len, void* stream) {
  auto kernel = backward_kernel<T, S>;
  // a warp of chains a block, or the C < 32 chains
  const int lanes = chains < kWarp ? chains : kWarp;
  const int blocks = (chains + lanes - 1) / lanes;
  const int smem = BackwardSmem<T, S>::kBytes;
  if (smem > kDefaultSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, lanes, smem, st>>>(
      static_cast<const T*>(alphas), static_cast<const T*>(log_trans),
      static_cast<const T*>(y), static_cast<const T*>(path_u),
      static_cast<int*>(z), static_cast<T*>(n), static_cast<T*>(sum),
      static_cast<T*>(sumsq), static_cast<T*>(counts), static_cast<T*>(first),
      chains, t_len);
  return static_cast<int>(cudaGetLastError());
}

// S at run time onto its instantiation.
#define BOOM_HMM_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

template <typename T>
int launch_forward(const void* log_lik, const void* log_trans,
                   const void* log_init, void* alphas, void* loglike,
                   int chains, int t_len, int s, void* stream) {
  if (chains <= 0 || t_len <= 0) return 0;
  switch (s) {
#define BOOM_FORWARD_CASE(N) \
  case N:                    \
    return launch_forward_s<T, N>(log_lik, log_trans, log_init, alphas, \
                                  loglike, chains, t_len, stream);
    BOOM_HMM_CASES(BOOM_FORWARD_CASE)
#undef BOOM_FORWARD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_backward(const void* alphas, const void* log_trans, const void* y,
                    const void* path_u, void* z, void* n, void* sum,
                    void* sumsq, void* counts, void* first, int chains,
                    int t_len, int s, void* stream) {
  if (chains <= 0 || t_len <= 0) return 0;
  switch (s) {
#define BOOM_BACKWARD_CASE(N)                                               \
  case N:                                                                   \
    return launch_backward_s<T, N>(alphas, log_trans, y, path_u, z, n, sum, \
                                   sumsq, counts, first, chains, t_len,     \
                                   stream);
    BOOM_HMM_CASES(BOOM_BACKWARD_CASE)
#undef BOOM_BACKWARD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entries. Every array is a contiguous device array of the entry's
// type (z int32): log_lik, alphas and path_u [C, T, S], log_trans [C, S, S],
// log_init, n, sum, sumsq and first [C, S], counts [C, S, S], loglike [C],
// y [T]; s in 1..16. H1's alphas may be nullptr (loglike alone). stream: a
// cudaStream_t. Returns the cudaError_t of the launch (0 = success).
extern "C" int boom_hmm_forward_f32(const void* log_lik, const void* log_trans,
                                    const void* log_init, void* alphas,
                                    void* loglike, int chains, int t_len,
                                    int s, void* stream) {
  return launch_forward<float>(log_lik, log_trans, log_init, alphas, loglike,
                               chains, t_len, s, stream);
}

extern "C" int boom_hmm_forward_f64(const void* log_lik, const void* log_trans,
                                    const void* log_init, void* alphas,
                                    void* loglike, int chains, int t_len,
                                    int s, void* stream) {
  return launch_forward<double>(log_lik, log_trans, log_init, alphas,
                                loglike, chains, t_len, s, stream);
}

extern "C" int boom_hmm_backward_f32(const void* alphas, const void* log_trans,
                                     const void* y, const void* path_u,
                                     void* z, void* n, void* sum, void* sumsq,
                                     void* counts, void* first, int chains,
                                     int t_len, int s, void* stream) {
  return launch_backward<float>(alphas, log_trans, y, path_u, z, n, sum,
                                sumsq, counts, first, chains, t_len, s,
                                stream);
}

extern "C" int boom_hmm_backward_f64(const void* alphas, const void* log_trans,
                                     const void* y, const void* path_u,
                                     void* z, void* n, void* sum, void* sumsq,
                                     void* counts, void* first, int chains,
                                     int t_len, int s, void* stream) {
  return launch_backward<double>(alphas, log_trans, y, path_u, z, n, sum,
                                 sumsq, counts, first, chains, t_len, s,
                                 stream);
}

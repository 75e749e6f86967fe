// The hidden Markov model's forward filter and backward sampler,
// hand-written for Hopper (sm_90a): L lanes a chain, each walking one
// segment of the T steps.
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
// What bounds them. A chain's step depends on the step before, so one lane
// walking a chain's T steps is a latency chain of T steps, and at 4,096
// chains a lane a chain fills 128 warps, about one an SM: the card idles
// behind that chain (a lane a chain took 23x H1's byte bound). So a chain
// gets L lanes (L in {8, 32}, a template parameter, chosen at launch from
// C: 32 while C L lanes fit in kWarpsPerSm warps an SM, so a warp of
// chains or fewer, else 8, so 4,096 chains, in waves past 4,224), and lane
// k of a chain owns the steps [k seg, (k + 1) seg), seg = ceil(T / L). A
// block is one warp of 32 / L chains. Other powers of two measured within
// 8 % of these (PERF.md, Findings) and would double the build. A
// lane's dependent chain is about 2 seg steps plus log2 L shuffle levels
// instead of T steps.
//
// H1 in three passes:
//   1. the transfer: each lane forms its segment's S x S product of the
//      step matrices M_t[i, j] = log_trans[i, j] + log_lik[t, j] in the
//      log semiring (its S rows are S independent walks of the filter's
//      step), shifted by the previous step's largest entry so f32 does not
//      drift; lane 0 starts from log_init + log_lik[0] in every row;
//   2. a shuffle scan of the transfers across the chain's lanes (log2 L
//      levels, each an S x S x S product): lane k's inclusive prefix holds
//      the unnormalised alphas at its segment's last step, every row alike,
//      and the previous lane's is lane k's entry;
//   3. the walk: each lane runs the filter's step over its segment from
//      its entry and writes the alphas; loglike is the sum of the lanes'
//      normalisers, reduced by shuffles in a fixed order.
// The step keeps the normaliser off the dependent chain: pred'_j =
// LSE_i(u_i + log_trans[i, j]) + (log_lik[t, j] - norm(u)), norm(u) =
// LSE(u) computed beside it; a two-term log-sum-exp takes one exp (the
// largest term's is 1). f32 takes exp and log through the MUFU
// (ex2.approx.ftz / lg2.approx.ftz with the log2 e scaling); f64 keeps the
// accurate functions. Everything stays in log space, so a log alpha far
// below -87 stays finite in f32.
//
// H2 in three passes:
//   1. the maps: the step is a map z_t = f_t(z_{t+1}), f_t[j] =
//      argmax_i((la_t,i + log_trans[i, j]) - log(-log u_t,i)), each entry
//      with the plain version's operations in its order (the first largest
//      wins), so the path is the same function of the alphas and uniforms
//      as the plain version's. A map of S <= 8 entries packs into 32 bits, 4 an
//      entry. Each lane composes its segment's maps walking backward (F <-
//      f_t o F: S lookups a step, the only dependent work; the Gumbel logs
//      and the S^2 logits are parallel work) and keeps each f_t in shared
//      memory (a byte a step at S <= 2) where a lane's segment fits, else
//      in its own slot of z (the kernel's own output, so no scratch);
//   2. a reverse shuffle scan of the composed maps gives each lane its
//      incoming state z at its segment's end (the last step's map is
//      constant: argmax(la_{T-1} - g_{T-1}));
//   3. the walk: each lane reads its maps back, z_t = f_t[z_{t+1}],
//      writes z and accumulates n, sum y and sum y^2 (double, y times an
//      exact 0 or 1 a state) and the counts, its last step's transition
//      into the next segment included; then the chain's lanes reduce in a
//      fixed order.
//
// L = 1 is the lane-a-chain layout: no transfer, no scan; H2 recomputes
// the step's argmax on its walk. It is the layout where the S x S transfer
// costs more than the split saves or does not fit in registers: H1 past S
// = 7 (f32) / S = 4 (f64), H2 past S = 8 (a map no longer fits 32 bits).
// Repeated launches are bit-identical: no atomics, every reduction in a
// fixed order.
//
// Staging. The per-step streams are [C, T, S] rows, so a lane's chunk of
// steps is one contiguous run. The warp copies each lane's next chunk (256
// bytes a row; 128 for H2's two streams with L > 1) into shared memory
// with element-wise cp.async while it computes the current one,
// double-buffered; each lane then reads its own row (rows padded by one
// element, so that the lanes' reads fall in distinct banks). Outputs go
// back the same way (H1's alphas over the log_lik they came from): a row a
// lane in shared memory, then each store instruction writes one run. The
// copy loops cost as much as the steps until they were unrolled by rows
// (PERF.md, Findings): per chunk they are a few integer operations
// and one or two copies a row.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

#ifndef __CUDACC__
using std::exp;
using std::fma;
using std::isinf;
using std::log;
#endif

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// a block's dynamic shared memory past which the launch must opt in
constexpr int kDefaultSmem = 48 * 1024;
// the resident warps an SM that the choice of L aims to fill
constexpr int kWarpsPerSm = 8;
// lanes a chain, when a caller forces them (boom_hmm_set_lanes); 0: chosen
int forced_lanes = 0;

#ifndef BOOM_SHARED_BYTES
#define BOOM_SHARED_BYTES(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

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

// exp and log of the filter's log-sum-exps: in f32 the MUFU's ex2 and lg2
// (flushing subnormals: a term below 2^-126 of the sum's largest is 0),
// accurate in f64
__device__ __forceinline__ float exp_(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.44269504088896341f));
  return y;
#else
  return std::exp(x);
#endif
}
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float log_(float x) {
#ifdef __CUDA_ARCH__
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * 0.693147180559945309f;
#else
  return std::log(x);
#endif
}
__device__ __forceinline__ double log_(double x) { return log(x); }

// the shift of a log-sum-exp: the largest value, 0 when it is infinite
template <typename T>
__device__ __forceinline__ T shift_of(T m) {
  return isinf(m) ? T(0) : m;
}

// log(sum exp(x_i)) as torch.logsumexp: shifted by the largest finite
// value (by 0 when it is infinite).
template <typename T, int N>
__device__ __forceinline__ T log_sum_exp(const T (&x)[N]) {
  T m = x[0];
#pragma unroll
  for (int i = 1; i < N; ++i) m = x[i] > m ? x[i] : m;
  if constexpr (N == 2) {
    // the largest term's exp is 1: one exp, the same sum
    const T lo = x[0] > x[1] ? x[1] : x[0];
    return isinf(m) ? m : log_(T(1) + exp_(lo - m)) + m;
  }
  const T shift = shift_of(m);
  T s = exp_(x[0] - shift);
#pragma unroll
  for (int i = 1; i < N; ++i) s = s + exp_(x[i] - shift);
  return log_(s) + shift;
}

template <typename T, int S>
__device__ __forceinline__ T max_all(const T (&b)[S][S]) {
  T m = b[0][0];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) m = b[i][j] > m ? b[i][j] : m;
  return m;
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

// The split layout: a block is one warp of kChains = 32 / L chains, L
// lanes a chain; lane k of a chain owns the steps [k seg, k seg + len).
// Lanes of a chain past C, and lanes whose segment starts past T, own no
// step (len = 0) but take part in every shuffle and barrier.
template <int L>
struct Split {
  static constexpr int kChains = kWarp / L;
  int lane, k, first, chain, seg, a, len;
  bool active;
  __device__ __forceinline__ Split(int chains, int t_len) {
    lane = threadIdx.x;
    k = lane % L;
    first = blockIdx.x * kChains;
    chain = first + lane / L;
    active = chain < chains;
    seg = (t_len + L - 1) / L;
    a = k * seg;
    len = active ? imax(0, imin(seg, t_len - a)) : 0;
  }
  // the lane whose value a shuffle by d lanes up (down) the chain reads;
  // its own at the chain's end
  __device__ __forceinline__ int up(int d) const {
    return k >= d ? lane - d : lane;
  }
  __device__ __forceinline__ int down(int d) const {
    return k + d < L ? lane + d : lane;
  }
};

// Row r of a warp's chunk q: lane r's steps [t0, t0 + n) of chain c (n <=
// 0: none, also past the last chain).
template <int L, int kSteps>
__device__ __forceinline__ int row_span(const Split<L>& sp, int r, int q,
                                        int chains, int t_len, int& c,
                                        int& t0) {
  c = sp.first + r / L;
  t0 = (r % L) * sp.seg + q * kSteps;
  return c < chains ? imin(kSteps, imin(t_len, (r % L + 1) * sp.seg) - t0)
                    : 0;
}

// The warp copies chunk q of every lane's segment of a stream into buf, a
// row a lane (pitch P): row r holds chain (first + r / L)'s steps [t0, t0 +
// n), t0 = (r % L) seg + q kSteps, W elements a step, chain c's steps at
// src + c chain_stride; one element a lane a copy, a row's run in one or
// two instructions. Unrolled by 8 rows, so a row's place is a few
// multiply-adds (unrolled over all 32, the compiler keeps every row's
// pointer live: 128-255 registers and spills). kRows = L: the first
// chain's rows alone (y: every chain's lane k reads the same steps).
template <typename T, int L, int kSteps, int W, int P, int kRows = kWarp>
__device__ __forceinline__ void stage_rows(T* buf, const T* src,
                                           long long chain_stride,
                                           const Split<L>& sp, int chains,
                                           int t_len, int q) {
#pragma unroll 8
  for (int r = 0; r < kRows; ++r) {
    int c, t0;
    const int n = row_span<L, kSteps>(sp, r, q, chains, t_len, c, t0);
    const T* row = src + c * chain_stride + static_cast<long long>(t0) * W;
#pragma unroll
    for (int e0 = 0; e0 < kSteps * W; e0 += kWarp) {
      const int e = e0 + sp.lane;
      if (e < n * W) copy_async(buf + r * P + e, row + e);
    }
  }
}

// The warp writes buf's rows (as stage_rows lays them out) to chunk q of
// every lane's segment of dst.
template <typename T, int L, int kSteps, int W, int P>
__device__ __forceinline__ void write_rows(T* dst, long long chain_stride,
                                           const T* buf, const Split<L>& sp,
                                           int chains, int t_len, int q) {
#pragma unroll 8
  for (int r = 0; r < kWarp; ++r) {
    int c, t0;
    const int n = row_span<L, kSteps>(sp, r, q, chains, t_len, c, t0);
    T* row = dst + c * chain_stride + static_cast<long long>(t0) * W;
#pragma unroll
    for (int e0 = 0; e0 < kSteps * W; e0 += kWarp) {
      const int e = e0 + sp.lane;
      if (e < n * W) row[e] = buf[r * P + e];
    }
  }
}

// Steps a chunk and the padded row of a staged chunk of W-wide steps,
// kRowBytes a lane's row.
template <typename T, int W, int kRowBytes>
struct Chunk {
  static constexpr int kSteps =
      kRowBytes / static_cast<int>(sizeof(T)) / W > 0
          ? kRowBytes / static_cast<int>(sizeof(T)) / W
          : 1;
  static constexpr int kRow = kSteps * W;
  static constexpr int kPitch = kRow + 1;
  // one buffer: the warp's 32 rows
  static constexpr int kBuf = kWarp * kPitch;
  // a row of one value a step (y, the maps, z)
  static constexpr int kStepPitch = kSteps + 1;
};

// Most lanes a chain of each kernel: 32 where the split layout pays (and
// L is 8 or 32), else 1 (and L is 1). H1's transfer costs S times a walk's
// step: at C = 4,096 in f32 the split wins to S = 7 and loses at S = 8
// (PERF.md, Findings); in f64 its S x S state fits in registers to
// S = 4.
template <typename T, int S>
constexpr int kForwardMaxLanes = (sizeof(T) == 4 ? S <= 7 : S <= 4) ? 32 : 1;
template <int S>
constexpr int kBackwardMaxLanes = S <= 8 ? 32 : 1;

// ---- H1 ------------------------------------------------------------------

template <typename T, int S>
struct ForwardSmem {
  // 256 bytes a lane's row
  using C = Chunk<T, S, 256>;
  // two buffers; the walk writes a step's alphas over its log_lik
  static constexpr int kBytes = 2 * C::kBuf * static_cast<int>(sizeof(T));
};

// log_lik [C, T, S], log_trans [C, S, S], log_init [C, S] -> alphas [C, T,
// S] (nullptr: not written) and loglike [C].
template <typename T, int S, int L>
__global__ void __launch_bounds__(kWarp)
    forward_kernel(const T* __restrict__ log_lik,
                   const T* __restrict__ log_trans,
                   const T* __restrict__ log_init, T* __restrict__ alphas,
                   T* __restrict__ loglike, int chains, int t_len) {
  using C = typename ForwardSmem<T, S>::C;
  BOOM_SHARED_BYTES(smem_raw);
  T* in = reinterpret_cast<T*>(smem_raw);  // [2][kWarp][kPitch]
  const Split<L> sp(chains, t_len);
  const int lane = sp.lane;
  const int cc = sp.active ? sp.chain : chains - 1;
  const int n_chunks = (sp.seg + C::kSteps - 1) / C::kSteps;
  const T* init = log_init + static_cast<size_t>(cc) * S;
  const T* lt_at = log_trans + static_cast<size_t>(cc) * S * S;
  const long long stride = static_cast<long long>(t_len) * S;

  // One pass over the lane's segment: step(i, ll, tt) at its i-th step,
  // ll that step's log_lik row (in shared memory), tt its place in the
  // chunk; then after(q) once a chunk, behind a barrier.
  auto pass = [&](auto&& step, auto&& after) {
    stage_rows<T, L, C::kSteps, S, C::kPitch>(in, log_lik, stride, sp, chains,
                                              t_len, 0);
    async_commit();
    for (int q = 0; q < n_chunks; ++q) {
      if (q + 1 < n_chunks) {
        stage_rows<T, L, C::kSteps, S, C::kPitch>(
            in + ((q + 1) & 1) * C::kBuf, log_lik, stride, sp, chains, t_len,
            q + 1);
        async_commit();
        async_wait<1>();
      } else {
        async_wait<0>();
      }
      __syncwarp();
      T* row = in + (q & 1) * C::kBuf + lane * C::kPitch;
      const int n = imin(sp.len - q * C::kSteps, C::kSteps);
      for (int tt = 0; tt < n; ++tt)
        step(q * C::kSteps + tt, row + tt * S, tt);
      __syncwarp();
      after(q);
    }
  };

  // 1. the transfer of the lane's segment, its S rows shifted a step by
  // the previous step's largest entry (lane 0's rows: log_init +
  // log_lik[0], then its steps)
  T b[S][S];
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < S; ++j) b[i][j] = T(0);
  T e[S] = {};
  if constexpr (L > 1) {
    {
      const Trans<T, S> lt(lt_at);
      T nrm(0);
      pass(
          [&](int i_seg, T* ll, int) {
            if (i_seg == 0) {
#pragma unroll
              for (int i = 0; i < S; ++i)
#pragma unroll
                for (int j = 0; j < S; ++j)
                  b[i][j] = (sp.k == 0 ? init[j] : lt(i, j)) + ll[j];
            } else {
              T lln[S];
#pragma unroll
              for (int j = 0; j < S; ++j) lln[j] = ll[j] - nrm;
#pragma unroll
              for (int i = 0; i < S; ++i) {
                T row[S];
#pragma unroll
                for (int j = 0; j < S; ++j) {
                  T terms[S];
#pragma unroll
                  for (int m = 0; m < S; ++m) terms[m] = b[i][m] + lt(m, j);
                  row[j] = log_sum_exp<T, S>(terms) + lln[j];
                }
#pragma unroll
                for (int j = 0; j < S; ++j) b[i][j] = row[j];
              }
            }
            nrm = shift_of(max_all<T, S>(b));
          },
          [](int) {});
    }
    // 2. the inclusive scan of the transfers across the chain's lanes
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      T p[S][S];
#pragma unroll
      for (int i = 0; i < S; ++i)
#pragma unroll
        for (int j = 0; j < S; ++j)
          p[i][j] = __shfl_sync(kFull, b[i][j], sp.up(d));
      if (sp.k >= d) {
        // p <- p (x) b, a row at a time
#pragma unroll
        for (int i = 0; i < S; ++i) {
          T row[S];
#pragma unroll
          for (int j = 0; j < S; ++j) {
            T terms[S];
#pragma unroll
            for (int m = 0; m < S; ++m) terms[m] = p[i][m] + b[m][j];
            row[j] = log_sum_exp<T, S>(terms);
          }
#pragma unroll
          for (int j = 0; j < S; ++j) p[i][j] = row[j];
        }
        const T sh = shift_of(max_all<T, S>(p));
#pragma unroll
        for (int i = 0; i < S; ++i)
#pragma unroll
          for (int j = 0; j < S; ++j) b[i][j] = p[i][j] - sh;
      }
    }
    // the entry: the previous lane's inclusive prefix, its rows alike
#pragma unroll
    for (int j = 0; j < S; ++j) e[j] = __shfl_sync(kFull, b[0][j], sp.up(1));
  }

  // 3. the walk from the entry: u the unnormalised alphas, norm = LSE(u)
  T u[S];
  T norm(0), total(0);
#pragma unroll
  for (int s = 0; s < S; ++s) u[s] = L > 1 ? e[s] : T(0);
  if (L > 1 && sp.k > 0) norm = log_sum_exp<T, S>(u);
  const Trans<T, S> lt(lt_at);
  pass(
      [&](int i_seg, T* ll, int) {
        if (sp.a + i_seg == 0) {
#pragma unroll
          for (int s = 0; s < S; ++s) u[s] = init[s] + ll[s];
        } else {
          T lln[S], nxt[S];
#pragma unroll
          for (int j = 0; j < S; ++j) lln[j] = ll[j] - norm;
#pragma unroll
          for (int j = 0; j < S; ++j) {
            T terms[S];
#pragma unroll
            for (int i = 0; i < S; ++i) terms[i] = u[i] + lt(i, j);
            nxt[j] = log_sum_exp<T, S>(terms) + lln[j];
          }
#pragma unroll
          for (int s = 0; s < S; ++s) u[s] = nxt[s];
        }
        norm = log_sum_exp<T, S>(u);
        total = total + norm;
        if (alphas != nullptr) {
#pragma unroll
          for (int s = 0; s < S; ++s) ll[s] = u[s] - norm;
        }
      },
      [&](int q) {
        if (alphas != nullptr) {
          write_rows<T, L, C::kSteps, S, C::kPitch>(
              alphas, stride, in + (q & 1) * C::kBuf, sp, chains, t_len, q);
          __syncwarp();
        }
      });

  // the lanes' normalisers, summed down the chain in a fixed order
#pragma unroll
  for (int d = L / 2; d >= 1; d >>= 1)
    total = total + __shfl_sync(kFull, total, sp.down(d));
  if (sp.active && sp.k == 0) loglike[sp.chain] = total;
}

// ---- H2 ------------------------------------------------------------------

// The type that holds a map of S states in shared memory: 4 bits an entry.
template <int S>
struct MapOf {
  using type = typename std::conditional<
      S <= 2, uint8_t, typename std::conditional<S <= 4, uint16_t,
                                                 uint32_t>::type>::type;
};

// A map of S <= 8 states onto states, 4 bits an entry.
template <int S>
__device__ __forceinline__ unsigned map_at(unsigned f, int j) {
  return (f >> (4 * j)) & 15u;
}

template <int S>
__device__ __forceinline__ unsigned identity_map() {
  unsigned f = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) f |= static_cast<unsigned>(j) << (4 * j);
  return f;
}

// (f o g)[j] = f[g[j]]
template <int S>
__device__ __forceinline__ unsigned compose(unsigned f, unsigned g) {
  unsigned out = 0;
#pragma unroll
  for (int j = 0; j < S; ++j)
    out |= map_at<S>(f, static_cast<int>(map_at<S>(g, j))) << (4 * j);
  return out;
}

template <typename T, int S, int L>
struct BackwardSmem {
  // a lane's row: 128 bytes with L > 1, so that two streams fit beside
  // several warps an SM; 256 with L = 1
  using C = Chunk<T, S, L == 1 ? 256 : 128>;
  // la and u, two buffers each (pass 1; L = 1: the walk); the walk's two
  // buffers of maps staged from z (L > 1, maps not in shared memory) share
  // the space
  static constexpr int kStreams = 4 * C::kBuf * static_cast<int>(sizeof(T));
  // y: two buffers of L rows (segment k's steps)
  static constexpr int kY = 2 * L * C::kStepPitch * static_cast<int>(sizeof(T));
  // the output rows (the maps, then the path), a row a lane
  static constexpr int kZ = kWarp * C::kStepPitch * 4;
  // the transition counts, [S * S][kWarp] (a lane's column)
  static constexpr int kCounts = S * S * kWarp * 4;
  // then, where they fit, the maps: a row of map_pitch a lane
  static constexpr int kBytes = kStreams + kY + kZ + kCounts;
};

// log_alphas [C, T, S], log_trans [C, S, S], y [T], path_u [C, T, S] ->
// z [C, T] int32, n, sum y, sum y^2 [C, S], counts [C, S, S] (from, to),
// first [C, S] (z_0's one-hot).
template <typename T, int S, int L>
__global__ void __launch_bounds__(kWarp)
    backward_kernel(const T* __restrict__ alphas,
                    const T* __restrict__ log_trans, const T* __restrict__ y,
                    const T* __restrict__ path_u, int* __restrict__ z_out,
                    T* __restrict__ n_out, T* __restrict__ sum_out,
                    T* __restrict__ sumsq_out, T* __restrict__ counts_out,
                    T* __restrict__ first_out, int chains, int t_len,
                    int map_pitch) {
  using Sm = BackwardSmem<T, S, L>;
  using C = typename Sm::C;
  BOOM_SHARED_BYTES(smem_raw);
  T* la_buf = reinterpret_cast<T*>(smem_raw);  // [2][kWarp][kPitch]
  T* u_buf = la_buf + 2 * C::kBuf;             // [2][kWarp][kPitch]
  int* map_buf = reinterpret_cast<int*>(smem_raw);  // [2][kWarp][kStepPitch]
  T* y_buf = reinterpret_cast<T*>(smem_raw + Sm::kStreams);  // [2][L][..]
  int* z_buf = reinterpret_cast<int*>(smem_raw + Sm::kStreams + Sm::kY);
  int* cnt = z_buf + kWarp * C::kStepPitch;  // [S * S][kWarp]
  const Split<L> sp(chains, t_len);
  const int lane = sp.lane;
  const int cc = sp.active ? sp.chain : chains - 1;
  const int n_chunks = (sp.seg + C::kSteps - 1) / C::kSteps;
  const long long stride = static_cast<long long>(t_len) * S;
  const Trans<T, S> lt(log_trans + static_cast<size_t>(cc) * S * S);

  // One backward pass over the lane's segment: stage(q, buffer) copies
  // chunk q (and commits), step(i, tt, buffer) runs its i-th step, tt its
  // place in the chunk; then the warp writes the chunk's z_buf rows to z.
  auto pass = [&](auto&& stage, auto&& step, bool write_z = true) {
    stage(n_chunks - 1, (n_chunks - 1) & 1);
    for (int q = n_chunks - 1; q >= 0; --q) {
      if (q > 0) {
        stage(q - 1, (q - 1) & 1);
        async_wait<1>();
      } else {
        async_wait<0>();
      }
      __syncwarp();
      const int n = imin(sp.len - q * C::kSteps, C::kSteps);
      for (int tt = n - 1; tt >= 0; --tt)
        step(q * C::kSteps + tt, tt, q & 1);
      __syncwarp();
      if (write_z) {
        write_rows<int, L, C::kSteps, 1, C::kStepPitch>(z_out, t_len, z_buf,
                                                        sp, chains, t_len, q);
        __syncwarp();
      }
    }
  };
  auto stage_streams = [&](int q, int b) {
    stage_rows<T, L, C::kSteps, S, C::kPitch>(la_buf + b * C::kBuf, alphas,
                                              stride, sp, chains, t_len, q);
    stage_rows<T, L, C::kSteps, S, C::kPitch>(u_buf + b * C::kBuf, path_u,
                                              stride, sp, chains, t_len, q);
  };
  auto stage_y = [&](int q, int b) {
    stage_rows<T, L, C::kSteps, 1, C::kStepPitch, L>(
        y_buf + b * L * C::kStepPitch, y, 0, sp, chains, t_len, q);
  };
  // the largest of the logits (la_t,i + log_trans[i, j]) - log(-log
  // u_t,i), the first largest winning (as argmax); la + 0 at the last step
  auto argmax = [&](const T* la_row, const T (&g)[S], bool last, int j) {
    int best = 0;
    T best_v(0);
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const T logit = last ? la_row[i] : la_row[i] + lt.col(i, j);
      const T v = logit - g[i];
      if (i == 0 || v > best_v) {
        best = i;
        best_v = v;
      }
    }
    return best;
  };

  for (int i = 0; i < S * S; ++i) cnt[i * kWarp + lane] = 0;
  int n[S];
  double sum[S], sumsq[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    n[s] = 0;
    sum[s] = 0.0;
    sumsq[s] = 0.0;
  }
  // z_{t+1} at each step of the walk, then z_0 on lane 0
  int z_next = 0;
  // z_t's statistics, the transition z_t -> z_{t+1} but at T - 1; each
  // state takes y_t times an exact 0 or 1, so no select of doubles
  auto count = [&](int t, int z, int tt, int b) {
    const double yt = static_cast<double>(
        y_buf[(b * L + sp.k) * C::kStepPitch + tt]);
    const double yt2 = yt * yt;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const double hit = s == z ? 1.0 : 0.0;
      n[s] += s == z;
      sum[s] = fma(hit, yt, sum[s]);
      sumsq[s] = fma(hit, yt2, sumsq[s]);
    }
    if (t != t_len - 1) cnt[(z * S + z_next) * kWarp + lane] += 1;
    z_buf[lane * C::kStepPitch + tt] = z;
    z_next = z;
  };

  if constexpr (L == 1) {
    // the walk, recomputing the step's argmax at z_{t+1}
    pass(
        [&](int q, int b) {
          stage_streams(q, b);
          stage_y(q, b);
          async_commit();
        },
        [&](int i_seg, int tt, int b) {
          const int t = sp.a + i_seg;
          const T* la_row = la_buf + b * C::kBuf + lane * C::kPitch + tt * S;
          const T* u_row = u_buf + b * C::kBuf + lane * C::kPitch + tt * S;
          T g[S];
#pragma unroll
          for (int i = 0; i < S; ++i) g[i] = log(-log(u_row[i]));
          count(t, argmax(la_row, g, t == t_len - 1, z_next), tt, b);
        });
  } else {
    // 1. the maps f_t into shared memory (a lane's row of map_pitch) or,
    // where they do not fit (map_pitch 0), into z; composed backward over
    // the segment
    using Map = typename MapOf<S>::type;
    Map* maps = reinterpret_cast<Map*>(smem_raw + Sm::kBytes) +
                lane * map_pitch;
    unsigned f_seg = identity_map<S>();
    pass(
        [&](int q, int b) {
          stage_streams(q, b);
          async_commit();
        },
        [&](int i_seg, int tt, int b) {
          const int t = sp.a + i_seg;
          const T* la_row = la_buf + b * C::kBuf + lane * C::kPitch + tt * S;
          const T* u_row = u_buf + b * C::kBuf + lane * C::kPitch + tt * S;
          T g[S];
#pragma unroll
          for (int i = 0; i < S; ++i) g[i] = log(-log(u_row[i]));
          unsigned f = 0;
          if (t == t_len - 1) {
            const unsigned best =
                static_cast<unsigned>(argmax(la_row, g, true, 0));
#pragma unroll
            for (int j = 0; j < S; ++j) f |= best << (4 * j);
          } else {
#pragma unroll
            for (int j = 0; j < S; ++j)
              f |= static_cast<unsigned>(argmax(la_row, g, false, j))
                   << (4 * j);
          }
          f_seg = compose<S>(f, f_seg);
          if (map_pitch > 0)
            maps[i_seg] = static_cast<Map>(f);
          else
            z_buf[lane * C::kStepPitch + tt] = static_cast<int>(f);
        },
        map_pitch == 0);
    // the maps written by other lanes of the warp, read back below
    __threadfence_block();
    __syncwarp();
    // 2. the reverse scan: h <- the composition of the segments from this
    // lane's to the chain's last; z at this segment's end is the next
    // lane's h at any state (the last step's map is constant)
    unsigned h = f_seg;
#pragma unroll
    for (int d = 1; d < L; d <<= 1) {
      const unsigned o = __shfl_sync(kFull, h, sp.down(d));
      if (sp.k + d < L) h = compose<S>(h, o);
    }
    const unsigned after = __shfl_sync(kFull, h, sp.down(1));
    z_next = sp.k + 1 < L ? static_cast<int>(map_at<S>(after, 0)) : 0;
    // 3. the walk through the maps
    pass(
        [&](int q, int b) {
          if (map_pitch == 0)
            stage_rows<int, L, C::kSteps, 1, C::kStepPitch>(
                map_buf + b * kWarp * C::kStepPitch, z_out, t_len, sp,
                chains, t_len, q);
          stage_y(q, b);
          async_commit();
        },
        [&](int i_seg, int tt, int b) {
          const unsigned f =
              map_pitch > 0
                  ? static_cast<unsigned>(maps[i_seg])
                  : static_cast<unsigned>(
                        map_buf[(b * kWarp + lane) * C::kStepPitch + tt]);
          count(sp.a + i_seg, static_cast<int>(map_at<S>(f, z_next)), tt, b);
        });
  }

  // the chain's lanes reduce in a fixed order; lane 0 writes
#pragma unroll
  for (int d = L / 2; d >= 1; d >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      n[s] += __shfl_sync(kFull, n[s], sp.down(d));
      sum[s] += __shfl_sync(kFull, sum[s], sp.down(d));
      sumsq[s] += __shfl_sync(kFull, sumsq[s], sp.down(d));
    }
  }
  __syncwarp();
  if (!sp.active) return;
  const size_t cs = static_cast<size_t>(sp.chain) * S;
  for (int i = sp.k; i < S * S; i += L) {
    int total = 0;
    for (int m = 0; m < L; ++m) total += cnt[i * kWarp + lane - sp.k + m];
    counts_out[cs * S + i] = static_cast<T>(total);
  }
  if (sp.k != 0) return;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    n_out[cs + s] = static_cast<T>(n[s]);
    sum_out[cs + s] = static_cast<T>(sum[s]);
    sumsq_out[cs + s] = static_cast<T>(sumsq[s]);
    first_out[cs + s] = static_cast<T>(s == z_next ? 1 : 0);
  }
}

// L of a launch (1 where kMax is): 32 while C L lanes fit in kWarpsPerSm
// warps an SM, else 8; or 32 where a caller forced 32 or more, else 8.
int choose_lanes(int chains, int max_lanes) {
  if (max_lanes == 1) return 1;
  if (forced_lanes > 0) return forced_lanes >= 32 ? 32 : 8;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long room = static_cast<long long>(sms) * kWarpsPerSm * kWarp;
  return static_cast<long long>(chains) * 32 <= room ? 32 : 8;
}

// H2's maps in shared memory: a lane's row of seg maps, padded to an odd
// number of 4-byte words (so the lanes' stores fall in distinct banks),
// where the block's shared memory then keeps kWarpsPerSm blocks an SM (or,
// for a grid of a few blocks an SM, stays within 48 KB); else 0: the maps
// go through z.
template <int S>
int backward_map_pitch(int smem, int blocks, int t_len, int lanes) {
  using Map = typename MapOf<S>::type;
  const int seg = (t_len + lanes - 1) / lanes;
  int bytes = (seg * static_cast<int>(sizeof(Map)) + 3) / 4 * 4;
  if (bytes % 8 == 0) bytes += 4;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int budget = blocks > 4 * sms
                         ? (227 * 1024) / kWarpsPerSm - 1024
                         : kDefaultSmem;
  return smem + kWarp * bytes <= budget
             ? bytes / static_cast<int>(sizeof(Map))
             : 0;
}

template <typename T, int S, int L>
int launch_forward_l(const void* log_lik, const void* log_trans,
                     const void* log_init, void* alphas, void* loglike,
                     int chains, int t_len, void* stream) {
  auto kernel = forward_kernel<T, S, L>;
  const int per_block = kWarp / L;
  const int blocks = (chains + per_block - 1) / per_block;
  const int smem = ForwardSmem<T, S>::kBytes;
  if (smem > kDefaultSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, kWarp, smem, st>>>(
      static_cast<const T*>(log_lik), static_cast<const T*>(log_trans),
      static_cast<const T*>(log_init), static_cast<T*>(alphas),
      static_cast<T*>(loglike), chains, t_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int S, int L>
int launch_backward_l(const void* alphas, const void* log_trans,
                      const void* y, const void* path_u, void* z, void* n,
                      void* sum, void* sumsq, void* counts, void* first,
                      int chains, int t_len, void* stream) {
  auto kernel = backward_kernel<T, S, L>;
  const int per_block = kWarp / L;
  const int blocks = (chains + per_block - 1) / per_block;
  int smem = BackwardSmem<T, S, L>::kBytes;
  const int map_pitch = L > 1 ? backward_map_pitch<S>(smem, blocks, t_len, L)
                              : 0;
  smem += kWarp * map_pitch * static_cast<int>(
                                  sizeof(typename MapOf<S>::type));
  if (smem > kDefaultSmem)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, kWarp, smem, st>>>(
      static_cast<const T*>(alphas), static_cast<const T*>(log_trans),
      static_cast<const T*>(y), static_cast<const T*>(path_u),
      static_cast<int*>(z), static_cast<T*>(n), static_cast<T*>(sum),
      static_cast<T*>(sumsq), static_cast<T*>(counts), static_cast<T*>(first),
      chains, t_len, map_pitch);
  return static_cast<int>(cudaGetLastError());
}

// L at run time onto its instantiation: 8 or 32 where kMax is 32, else 1.
template <typename T, int S>
int launch_forward_s(const void* log_lik, const void* log_trans,
                     const void* log_init, void* alphas, void* loglike,
                     int chains, int t_len, void* stream) {
  constexpr int kMax = kForwardMaxLanes<T, S>;
  if constexpr (kMax > 1) {
    if (choose_lanes(chains, kMax) == 32)
      return launch_forward_l<T, S, 32>(log_lik, log_trans, log_init,
                                        alphas, loglike, chains, t_len,
                                        stream);
    return launch_forward_l<T, S, 8>(log_lik, log_trans, log_init, alphas,
                                     loglike, chains, t_len, stream);
  } else {
    return launch_forward_l<T, S, 1>(log_lik, log_trans, log_init, alphas,
                                     loglike, chains, t_len, stream);
  }
}

template <typename T, int S>
int launch_backward_s(const void* alphas, const void* log_trans,
                      const void* y, const void* path_u, void* z, void* n,
                      void* sum, void* sumsq, void* counts, void* first,
                      int chains, int t_len, void* stream) {
  constexpr int kMax = kBackwardMaxLanes<S>;
  if constexpr (kMax > 1) {
    if (choose_lanes(chains, kMax) == 32)
      return launch_backward_l<T, S, 32>(alphas, log_trans, y, path_u, z, n,
                                         sum, sumsq, counts, first, chains,
                                         t_len, stream);
    return launch_backward_l<T, S, 8>(alphas, log_trans, y, path_u, z, n,
                                      sum, sumsq, counts, first, chains,
                                      t_len, stream);
  } else {
    return launch_backward_l<T, S, 1>(alphas, log_trans, y, path_u, z, n,
                                      sum, sumsq, counts, first, chains,
                                      t_len, stream);
  }
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

template <typename T>
int max_lanes(int backward, int s) {
  switch (s) {
#define BOOM_MAX_LANES_CASE(N) \
  case N:                      \
    return backward ? kBackwardMaxLanes<N> : kForwardMaxLanes<T, N>;
    BOOM_HMM_CASES(BOOM_MAX_LANES_CASE)
#undef BOOM_MAX_LANES_CASE
    default:
      return 1;
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

// The lanes a chain the next launch of H1 (backward = 0) or H2 (1) takes
// at this dtype (f64 = 1: double), S and C.
extern "C" int boom_hmm_lanes(int backward, int f64, int s, int chains) {
  return choose_lanes(chains,
                      f64 ? max_lanes<double>(backward, s)
                          : max_lanes<float>(backward, s));
}

// Forces the lanes a chain of every later launch (32 for lanes >= 32,
// else 8, where the split runs; 0: chosen from C again). Returns the
// previous setting. For tests and timing.
extern "C" int boom_hmm_set_lanes(int lanes) {
  const int before = forced_lanes;
  forced_lanes = lanes > 0 ? lanes : 0;
  return before;
}

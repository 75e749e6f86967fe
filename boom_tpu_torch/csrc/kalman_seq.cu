// Sequential Kalman recurrences for many short series, hand-written for
// Hopper (sm_90a): one thread per series walks the T steps.
//
// Replaces the reference's XLA time scans (not Pallas kernels):
//   K1 `loglik_kernel`: boom_tpu/statespace/kalman.py `kalman_loglik`
//      (:229, its lax.scan at :282), the marginal likelihood of every
//      (chain, TIM candidate) series. Its jet instantiation (NP > 0) also
//      carries first and second derivatives with respect to h and the
//      entries of R Q R' (forward mode), for the TIM proposal's mode search
//      (`jax.value_and_grad` in numopt.bfgs, `jax.hessian` in
//      newton_raphson and bsts.py:661).
//   K2 `smoother_kernel`: the fused static `simulation_smoother`
//      (kalman.py:438-481, lax.scan at :476) plus `_smoother_passes`
//      (:289-350, scans at :322 and :349): the unconditional simulation
//      fused into the filter on y - y+, the backward r pass and the forward
//      state pass, in one launch; the draw is alpha+ + E_0[alpha | y - y+].
// The plain PyTorch versions are boom_tpu_torch/statespace/kalman.py.
//
// What bounds them on this card. Each series is a chain of T dependent
// steps of d x d algebra (4d^3 + 9d^2 + 4d flops a filter step), so with
// one thread a series the time is T times a step's latency unless enough
// series are in flight to hide it. K1 at the bsts_llt shape (4096 chains x
// 17 points = 69,632 series, T=500, d=2, float32) reads one shared y and
// ~72 bytes of system a series, and does ~83 flops a step: bound by
// operations (~43 us at 67 TFLOP/s), and it has 544 blocks of 128 threads,
// about four a SM. K2 (4096 chains, float64) moves ~82 MB (noise in,
// draws out) and is bound by bytes (~25 us), but has only 4096 threads:
// one warp on each of 128 SMs with 32-thread blocks, so it is latency
// bound; the block size is an argument so that 32, 64 and 128 can be timed.
//
// Design. The state (a, P, the loglik) lives in registers; d is a template
// parameter (1..6), unrolled at compile time; no shared memory. The
// operation order is the reference's step for step: v = y - z'a,
// pz = P z, f = z'pz + h, K = (T pz) / f, L = T - K z', a' = T a + K v,
// P' = (T P) L' + RQR, then 0.5 (P' + P'^T); the `observed` mask zeroes v
// and K as `where(obs, ..., 0)` does. So float64 results match the plain
// version to rounding (FMA contraction aside). No value is reduced across
// threads, so repeated launches are bit-identical.
// Layout: the systems are per series ([B, d], [B, d, d], [B]); y [T] and the
// observed mask [T] are shared by all series and read as broadcasts. K2's
// per-step streams are chain-major [C, T, ...]: a thread reads and writes
// its own row, a warp touches 32 rows, and consecutive steps of a thread
// fall in the same 128-byte line, which L1 keeps (32-128 threads a SM).
// Time-major streams staged by the wrapper (coalesced steps) were no faster
// at 4096 chains (1.02 against 1.03 ms) and their copies made the call
// 0.04 ms slower (PERF.md, Findings: coalescing), so the rows stay.
// K2 keeps (v, f, K) of every step in a global scratch [C, T, d+2] for the
// backward pass, overwrites step t's slot with r_{t-1} there, and writes
// alpha+ into the output first and adds the smoothed mean to it last.
// The jet scalar carries value, gradient [NP] and the Hessian's upper
// triangle over NP = 1 + d(d+1)/2 parameters: h, then the upper triangle
// of R Q R' (a symmetric perturbation: P depends on R Q R' only through
// the symmetrized P'). The same template code runs with a plain scalar
// (K1) and with the jet, so the derivatives are of exactly the function
// K1 computes.

#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr double kLog2Pi = 1.8378770664093453;  // log(2 pi)

__device__ __forceinline__ float log_(float x) { return logf(x); }
__device__ __forceinline__ double log_(double x) { return log(x); }

// Value, gradient and Hessian (upper triangle, row-major) of a scalar
// function of N parameters.
template <typename T, int N>
struct Jet {
  static constexpr int kH = N * (N + 1) / 2;
  T v;
  T g[N];
  T h[kH];
  __device__ Jet() {}
  __device__ Jet(T x) : v(x) {  // NOLINT: a constant promotes to a jet
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = T(0);
#pragma unroll
    for (int k = 0; k < kH; ++k) h[k] = T(0);
  }
};

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator+(const Jet<T, N>& a,
                                               const Jet<T, N>& b) {
  Jet<T, N> c;
  c.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) c.g[i] = a.g[i] + b.g[i];
#pragma unroll
  for (int k = 0; k < Jet<T, N>::kH; ++k) c.h[k] = a.h[k] + b.h[k];
  return c;
}

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(const Jet<T, N>& a,
                                               const Jet<T, N>& b) {
  Jet<T, N> c;
  c.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) c.g[i] = a.g[i] - b.g[i];
#pragma unroll
  for (int k = 0; k < Jet<T, N>::kH; ++k) c.h[k] = a.h[k] - b.h[k];
  return c;
}

// a constant minus a jet
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(T s, const Jet<T, N>& a) {
  Jet<T, N> c;
  c.v = s - a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) c.g[i] = -a.g[i];
#pragma unroll
  for (int k = 0; k < Jet<T, N>::kH; ++k) c.h[k] = -a.h[k];
  return c;
}

// a constant times a jet
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(T s, const Jet<T, N>& a) {
  Jet<T, N> c;
  c.v = s * a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) c.g[i] = s * a.g[i];
#pragma unroll
  for (int k = 0; k < Jet<T, N>::kH; ++k) c.h[k] = s * a.h[k];
  return c;
}

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(const Jet<T, N>& a, T s) {
  return s * a;
}

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(const Jet<T, N>& a,
                                               const Jet<T, N>& b) {
  Jet<T, N> c;
  c.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) c.g[i] = a.g[i] * b.v + a.v * b.g[i];
  int k = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j, ++k)
      c.h[k] = a.h[k] * b.v + a.g[i] * b.g[j] + a.g[j] * b.g[i]
               + a.v * b.h[k];
  }
  return c;
}

// q = a / b from a = q b: q' = (a' - q b') / b,
// q''_ij = (a''_ij - q'_i b'_j - q'_j b'_i - q b''_ij) / b
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator/(const Jet<T, N>& a,
                                               const Jet<T, N>& b) {
  Jet<T, N> q;
  q.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) q.g[i] = (a.g[i] - q.v * b.g[i]) / b.v;
  int k = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j, ++k)
      q.h[k] = (a.h[k] - q.g[i] * b.g[j] - q.g[j] * b.g[i] - q.v * b.h[k])
               / b.v;
  }
  return q;
}

// l = log x: l' = x' / x, l''_ij = x''_ij / x - l'_i l'_j
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> log_(const Jet<T, N>& x) {
  Jet<T, N> l;
  l.v = log_(x.v);
#pragma unroll
  for (int i = 0; i < N; ++i) l.g[i] = x.g[i] / x.v;
  int k = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = i; j < N; ++j, ++k) l.h[k] = x.h[k] / x.v - l.g[i] * l.g[j];
  }
  return l;
}

// The scalar of a series: the plain type, or its jet over NP parameters.
template <typename T, int NP>
using Scalar = typename std::conditional<NP == 0, T, Jet<T, NP>>::type;

// One filter step of the reference's `step_core` (kalman.py:171-187) on the
// predicted (a, P), in place: returns v and f, writes K into k.
template <typename T, typename S, int D>
__device__ __forceinline__ void filter_step(S (&a)[D], S (&p)[D][D],
                                            const S& yt, bool obs,
                                            const T (&z)[D], const S& h,
                                            const S (&rqr)[D][D],
                                            const T (&tm)[D][D], S& v,
                                            S& f, S (&k)[D]) {
  const S zero(T(0));
  S za = z[0] * a[0];
#pragma unroll
  for (int j = 1; j < D; ++j) za = za + z[j] * a[j];
  v = obs ? yt - za : zero;
  S pz[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    pz[i] = p[i][0] * z[0];
#pragma unroll
    for (int j = 1; j < D; ++j) pz[i] = pz[i] + p[i][j] * z[j];
  }
  S zpz = z[0] * pz[0];
#pragma unroll
  for (int j = 1; j < D; ++j) zpz = zpz + z[j] * pz[j];
  f = zpz + h;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S tpz = tm[i][0] * pz[0];
#pragma unroll
    for (int j = 1; j < D; ++j) tpz = tpz + tm[i][j] * pz[j];
    k[i] = obs ? tpz / f : zero;
  }
  S an[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    S ta = tm[i][0] * a[0];
#pragma unroll
    for (int j = 1; j < D; ++j) ta = ta + tm[i][j] * a[j];
    an[i] = ta + k[i] * v;
  }
  // P' = (T P) L' + RQR with L = T - K z', then symmetrized
  S tp[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      tp[i][j] = tm[i][0] * p[0][j];
#pragma unroll
      for (int m = 1; m < D; ++m) tp[i][j] = tp[i][j] + tm[i][m] * p[m][j];
    }
  }
  S l[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) l[i][j] = tm[i][j] - k[i] * z[j];
  }
  S pn[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      S acc = tp[i][0] * l[j][0];
#pragma unroll
      for (int m = 1; m < D; ++m) acc = acc + tp[i][m] * l[j][m];
      pn[i][j] = acc + rqr[i][j];
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) {
    a[i] = an[i];
#pragma unroll
    for (int j = 0; j < D; ++j) p[i][j] = T(0.5) * (pn[i][j] + pn[j][i]);
  }
}

// The jet of a parameter: value x, unit derivative along parameter `slot`.
template <typename T, int NP>
__device__ __forceinline__ Scalar<T, NP> seeded(T x, int slot) {
  Scalar<T, NP> s(x);
  if constexpr (NP > 0) s.g[slot] = T(1);
  return s;
}

// K1: one thread per series. NP = 0: the loglik alone; NP > 0: also its
// gradient [B, NP] and Hessian [B, NP, NP] over (h, upper triangle of
// R Q R'), parameter j of row i at 1 + i*D - i*(i-1)/2 + (j - i).
template <typename T, int D, int NP>
__global__ void loglik_kernel(const T* __restrict__ z,
                              const T* __restrict__ tm,
                              const T* __restrict__ rqr,
                              const T* __restrict__ h,
                              const T* __restrict__ a0,
                              const T* __restrict__ p0,
                              const T* __restrict__ y,
                              const unsigned char* __restrict__ obs,
                              T* __restrict__ ll, T* __restrict__ grad,
                              T* __restrict__ hess, int batch, int t_len) {
  using S = Scalar<T, NP>;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  T zz[D], tt[D][D];
  S a[D], p[D][D], q[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    zz[i] = z[b * D + i];
    a[i] = S(a0[b * D + i]);
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int ij = (b * D + i) * D + j;
      tt[i][j] = tm[ij];
      p[i][j] = S(p0[ij]);
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      q[i][j] = seeded<T, NP>(rqr[ij], 1 + lo * D - lo * (lo - 1) / 2
                                           + (hi - lo));
    }
  }
  const S hh = seeded<T, NP>(h[b], 0);
  S acc(T(0));
  S v, f, k[D];
  for (int t = 0; t < t_len; ++t) {
    const bool o = obs == nullptr || obs[t] != 0;
    filter_step<T, S, D>(a, p, S(y[t]), o, zz, hh, q, tt, v, f, k);
    // ll += where(obs, -0.5 (log 2 pi + log f + v v / f), 0)
    if (o) acc = acc + T(-0.5) * ((S(T(kLog2Pi)) + log_(f)) + v * v / f);
  }
  if constexpr (NP == 0) {
    ll[b] = acc;
  } else {
    ll[b] = acc.v;
    int m = 0;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      grad[b * NP + i] = acc.g[i];
#pragma unroll
      for (int j = i; j < NP; ++j, ++m) {
        hess[(b * NP + i) * NP + j] = acc.h[m];
        hess[(b * NP + j) * NP + i] = acc.h[m];
      }
    }
  }
}

// K2: one thread per chain; the three passes of the fused simulation
// smoother. w [C, T-1, D] = R chol(Q) eta and eps [C, T] = sqrt(h) eps_z
// are the draws' noise, alpha1 [C, D] the unconditional initial state.
template <typename T, int D>
__global__ void smoother_kernel(const T* __restrict__ z,
                                const T* __restrict__ tm,
                                const T* __restrict__ rqr,
                                const T* __restrict__ h,
                                const T* __restrict__ p0,
                                const T* __restrict__ alpha1,
                                const T* __restrict__ w,
                                const T* __restrict__ eps,
                                const T* __restrict__ y,
                                const unsigned char* __restrict__ obs,
                                T* __restrict__ scratch, T* __restrict__ out,
                                int batch, int t_len) {
  constexpr int kSlot = D + 2;  // v, f, K[D] of a step; later r_{t-1}
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= batch) return;
  T zz[D], tt[D][D], q[D][D], pp0[D][D], a[D], p[D][D], sim[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    zz[i] = z[c * D + i];
    sim[i] = alpha1[c * D + i];
    a[i] = T(0);  // the filter on y - y+ starts from a0 = 0
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const int ij = (c * D + i) * D + j;
      tt[i][j] = tm[ij];
      q[i][j] = rqr[ij];
      pp0[i][j] = p0[ij];
      p[i][j] = pp0[i][j];
    }
  }
  const T hh = h[c];
  const long long row = static_cast<long long>(c) * t_len;
  T* sc = scratch + row * kSlot;
  T* o = out + row * D;
  const T* wc = w + static_cast<long long>(c) * (t_len - 1) * D;
  const T* ec = eps + row;

  // 1. forward: simulate alpha+ and filter y - y+ (kalman.py:460-473)
  for (int t = 0; t < t_len; ++t) {
    const bool ob = obs == nullptr || obs[t] != 0;
    T zs = zz[0] * sim[0];
#pragma unroll
    for (int j = 1; j < D; ++j) zs = zs + zz[j] * sim[j];
    const T yd = y[t] - (zs + ec[t]);
    T v, f, k[D];
    filter_step<T, T, D>(a, p, yd, ob, zz, hh, q, tt, v, f, k);
    T* slot = sc + static_cast<long long>(t) * kSlot;
    slot[0] = v;
    slot[1] = f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      slot[2 + i] = k[i];
      o[static_cast<long long>(t) * D + i] = sim[i];
    }
    if (t < t_len - 1) {
      T sn[D];
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T ts = tt[i][0] * sim[0];
#pragma unroll
        for (int j = 1; j < D; ++j) ts = ts + tt[i][j] * sim[j];
        sn[i] = ts + wc[static_cast<long long>(t) * D + i];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) sim[i] = sn[i];
    }
  }

  // 2. backward: r_{t-1} = where(obs, z v/f, 0) + L' r_t (kalman.py:315-323)
  T r[D];
#pragma unroll
  for (int i = 0; i < D; ++i) r[i] = T(0);
  for (int t = t_len - 1; t >= 0; --t) {
    const bool ob = obs == nullptr || obs[t] != 0;
    T* slot = sc + static_cast<long long>(t) * kSlot;
    const T vf = slot[0] / slot[1];
    T k[D];
#pragma unroll
    for (int i = 0; i < D; ++i) k[i] = slot[2 + i];
    T rn[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T lr = (tt[0][i] - k[0] * zz[i]) * r[0];
#pragma unroll
      for (int j = 1; j < D; ++j) lr = lr + (tt[j][i] - k[j] * zz[i]) * r[j];
      rn[i] = (ob ? zz[i] * vf : T(0)) + lr;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      r[i] = rn[i];
      slot[i] = r[i];
    }
  }

  // 3. forward state: alpha_1 = P0 r_0, alpha_{t+1} = T alpha_t + RQR r_t,
  // added to alpha+ (kalman.py:325, :345-350, :481)
  T ah[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T acc = pp0[i][0] * sc[0];
#pragma unroll
    for (int j = 1; j < D; ++j) acc = acc + pp0[i][j] * sc[j];
    ah[i] = acc;
    o[i] = o[i] + ah[i];
  }
  for (int t = 1; t < t_len; ++t) {
    const T* rs = sc + static_cast<long long>(t) * kSlot;
    T an[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T ta = tt[i][0] * ah[0];
#pragma unroll
      for (int j = 1; j < D; ++j) ta = ta + tt[i][j] * ah[j];
      T qr = q[i][0] * rs[0];
#pragma unroll
      for (int j = 1; j < D; ++j) qr = qr + q[i][j] * rs[j];
      an[i] = ta + qr;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      ah[i] = an[i];
      T* oi = o + static_cast<long long>(t) * D + i;
      *oi = *oi + ah[i];
    }
  }
}

bool bad_launch(int batch, int threads) {
  return threads < 32 || threads > 1024 || threads % 32 != 0 || batch < 0;
}

template <typename T, int D, int NP>
int launch_loglik(const void* z, const void* tm, const void* rqr,
                  const void* h, const void* a0, const void* p0,
                  const void* y, const void* obs, void* ll, void* grad,
                  void* hess, int batch, int t_len, int threads,
                  void* stream) {
  if (bad_launch(batch, threads) || t_len < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int blocks = (batch + threads - 1) / threads;
  loglik_kernel<T, D, NP><<<blocks, threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const T*>(tm),
      static_cast<const T*>(rqr), static_cast<const T*>(h),
      static_cast<const T*>(a0), static_cast<const T*>(p0),
      static_cast<const T*>(y), static_cast<const unsigned char*>(obs),
      static_cast<T*>(ll), static_cast<T*>(grad), static_cast<T*>(hess),
      batch, t_len);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_smoother(const void* z, const void* tm, const void* rqr,
                    const void* h, const void* p0, const void* alpha1,
                    const void* w, const void* eps, const void* y,
                    const void* obs, void* scratch, void* out, int batch,
                    int t_len, int threads, void* stream) {
  if (bad_launch(batch, threads) || t_len < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int blocks = (batch + threads - 1) / threads;
  smoother_kernel<T, D><<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const T*>(tm),
      static_cast<const T*>(rqr), static_cast<const T*>(h),
      static_cast<const T*>(p0), static_cast<const T*>(alpha1),
      static_cast<const T*>(w), static_cast<const T*>(eps),
      static_cast<const T*>(y), static_cast<const unsigned char*>(obs),
      static_cast<T*>(scratch), static_cast<T*>(out), batch, t_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries. Every array is a contiguous device array of the entry's
// type: z [B, D], tm and rqr and p0 [B, D, D], h [B], a0 and alpha1 [B, D],
// y [T], obs [T] bytes (nullptr: all observed); outputs ll [B], grad
// [B, NP], hess [B, NP, NP], out [C, T, D]; w [C, T-1, D], eps [C, T];
// scratch [C, T, D+2]. threads: block size, a multiple of 32 up to 1024.
// stream: a cudaStream_t. Returns the cudaError_t of the launch (0 =
// success).
#define BOOM_LOGLIK_ENTRY(TY, TYNAME, D)                                     \
  extern "C" int boom_kalman_loglik_##TYNAME##_d##D(                         \
      const void* z, const void* tm, const void* rqr, const void* h,         \
      const void* a0, const void* p0, const void* y, const void* obs,        \
      void* ll, int batch, int t_len, int threads, void* stream) {           \
    return launch_loglik<TY, D, 0>(z, tm, rqr, h, a0, p0, y, obs, ll,        \
                                   nullptr, nullptr, batch, t_len, threads,  \
                                   stream);                                  \
  }

#define BOOM_TANGENT_ENTRY(TY, TYNAME, D)                                    \
  extern "C" int boom_kalman_loglik_tangent_##TYNAME##_d##D(                 \
      const void* z, const void* tm, const void* rqr, const void* h,         \
      const void* a0, const void* p0, const void* y, const void* obs,        \
      void* ll, void* grad, void* hess, int batch, int t_len, int threads,   \
      void* stream) {                                                        \
    return launch_loglik<TY, D, 1 + D * (D + 1) / 2>(                        \
        z, tm, rqr, h, a0, p0, y, obs, ll, grad, hess, batch, t_len,         \
        threads, stream);                                                    \
  }

#define BOOM_SMOOTHER_ENTRY(TY, TYNAME, D)                                   \
  extern "C" int boom_kalman_smoother_##TYNAME##_d##D(                       \
      const void* z, const void* tm, const void* rqr, const void* h,         \
      const void* p0, const void* alpha1, const void* w, const void* eps,    \
      const void* y, const void* obs, void* scratch, void* out, int batch,   \
      int t_len, int threads, void* stream) {                                \
    return launch_smoother<TY, D>(z, tm, rqr, h, p0, alpha1, w, eps, y, obs, \
                                  scratch, out, batch, t_len, threads,       \
                                  stream);                                   \
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
BOOM_TANGENT_ENTRY(double, f64, 1)
BOOM_TANGENT_ENTRY(double, f64, 2)
BOOM_SMOOTHER_ENTRY(double, f64, 1)
BOOM_SMOOTHER_ENTRY(double, f64, 2)
BOOM_SMOOTHER_ENTRY(double, f64, 3)
BOOM_SMOOTHER_ENTRY(double, f64, 4)
BOOM_SMOOTHER_ENTRY(double, f64, 5)
BOOM_SMOOTHER_ENTRY(double, f64, 6)

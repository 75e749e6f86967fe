// Sequential Kalman recurrences for wider states (7 <= d <= 16), one warp a
// chain and a lane a row of the state, hand-written for Hopper (sm_90a).
//
// Replaces the reference's XLA time scans (not Pallas kernels) where the
// state is wider than kalman_seq.cu's one-thread-a-chain kernels take:
//   K2w `smoother_wide_kernel`: the fused static `simulation_smoother`
//      (boom_tpu/statespace/kalman.py:438-481, lax.scan at :476) plus
//      `_smoother_passes` (:289-350, scans at :322 and :349) at d > 6 (a
//      local linear trend with a 7-season cycle is d = 8): the
//      unconditional simulation fused into the filter on y - y+, the
//      backward r pass and the forward state pass, in one launch; the draw
//      is alpha+ + E_0[alpha | y - y+]. float64 (bsts.SMOOTHER_DTYPE).
//   K3 `dpath_kernel`: the ASIS D-path recurrence of bsts.asis_redraw
//      (boom_tpu/statespace/bsts.py:1077-1084, a lax.scan): D_0 = 0,
//      D_t = T_c D_{t-1} + w_{c,g,t} for every chain c and variance group
//      g, float32 or float64, d in 1..16.
// The plain PyTorch versions are boom_tpu_torch/statespace/kalman.py
// (`simulation_smoother`, `dpath`); statespace/kalman_kernel.py binds this
// file.
//
// What bounds them on this card. Each chain is a chain of T dependent steps.
// K2w's filter step is d x d algebra, 4d^3 + 8d^2 + 3d flops (2,624 at
// d = 8), in float64 whose rate is half float32's: at the bsts_reg shape
// (4096 chains, T = 500, d = 8) the operations bound it (~5.4 GFLOP of the
// filter, 0.16 ms at 34 TFLOP/s), ahead of its bytes (the w, eps, y streams
// in, the draw and the 2 x 49 MB scratch of (v/f, K) and r out and back).
// K3 does d^2 multiply-adds a step and group; its bytes bound it (w in, the
// D-paths out: 0.39 GB in float32 at 4096 chains, 3 groups, d = 8).
//
// Design. A lane per row spreads one chain's step across d lanes, where K2
// puts a chain on one thread with its d x d matrices in registers (past
// d = 6 they spill: PERF.md). The row-parallel operations are lane-local;
// what crosses rows goes through the warp:
//   - K2w: lane i < d holds row i of T in registers and a_i, K_i, r_i; P,
//     T, R Q R' and the step's exchange vectors live in the warp's slice of
//     shared memory (pitch d + 1 doubles: conflict-free column reads). z'a,
//     z'P z and z' alpha+ are warp reductions (a fixed butterfly, so
//     repeated launches are bit-identical); T P z, T a, P' = (T P) L' + R Q R'
//     read the other rows from shared memory between __syncwarp()s; the
//     symmetrization 0.5 (P' + P'^T) reads P'^T back the same way. The
//     per-step slots ((v/f, K), then r) go to a scratch [C, T, d + 1] as
//     K2's do, each step's operands are loaded a step ahead. Lanes d..31 are
//     idle in the algebra (three quarters of the warp at d = 8): the lever
//     for a later version, with the sparsity of the seasonal's T.
//   - K3: lane l holds row l % d of the chain's T and D_t[l % d] of group
//     g0 + l / d, 32 / d groups a pass over T; T D_{t-1} takes d shuffles a
//     step; w is read in asis_redraw's [C, G, T-1, d] layout (formed on the
//     host from the innovations), D written [C, G, T, d].
// The operation order of each value is the plain version's (the reductions
// aside), so float64 results agree with it to rounding (PERF.md, 1e-9
// normwise).

#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxD = 16;  // K2w's and K3's widest state
constexpr int kWarp = 32;

// The block's dynamic shared memory, 16-byte aligned.
#ifndef BOOM_SHARED_BYTES
#define BOOM_SHARED_BYTES(name) \
  extern __shared__ __align__(16) unsigned char name[]
#endif

// Sum over the warp's 32 lanes by a fixed butterfly; every lane gets it.
template <typename T>
__device__ __forceinline__ T warp_sum(T v, int lane) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = v + __shfl_sync(0xffffffffu, v, lane ^ off);
  return v;
}

__device__ __forceinline__ double reciprocal(double x) { return __drcp_rn(x); }

// Doubles of one warp's slice of K2w's shared memory: T, R Q R', P and the
// step's P' (each d x (d + 1)), then four exchange vectors of kMaxD.
__host__ __device__ inline int wide_warp_doubles(int d) {
  return 4 * d * (d + 1) + 4 * kMaxD;
}

// K2w: one warp a chain, lane i < d a row. The three passes of the fused
// simulation smoother; operands as K2's (kalman_seq.cu): w [C, T-1, d] =
// R chol(Q) eta, eps [C, T] = sqrt(h) eps_z, alpha1 [C, d]; scratch
// [C, T, d+1]: pass 1 writes (v/f, K) of step t at slot t, pass 2
// overwrites its first d with r_{t-1}, pass 3 reads them. Warps past the
// batch leave at once (no block barrier is used).
__global__ void __launch_bounds__(128)
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
                         int d) {
  BOOM_SHARED_BYTES(smem_raw);
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int c = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (c >= batch) return;  // the whole warp
  const int ld = d + 1;
  double* base = reinterpret_cast<double*>(smem_raw) +
                 static_cast<long long>(warp) * wide_warp_doubles(d);
  double* sT = base;             // T [d][ld]
  double* sQ = sT + d * ld;      // R Q R'
  double* sP = sQ + d * ld;      // P
  double* sN = sP + d * ld;      // the step's P' before symmetrization
  double* v1 = sN + d * ld;      // exchange vectors [kMaxD] each
  double* v2 = v1 + kMaxD;
  double* v3 = v2 + kMaxD;
  double* v4 = v3 + kMaxD;
  const bool act = lane < d;
  const int i = act ? lane : 0;  // idle lanes shadow row 0, write nothing
  const double z_i = act ? z[static_cast<long long>(c) * d + i] : 0.0;

  double zz[kMaxD], trow[kMaxD];
  const long long cdd = static_cast<long long>(c) * d * d;
#pragma unroll
  for (int j = 0; j < kMaxD; ++j) {
    zz[j] = j < d ? z[static_cast<long long>(c) * d + j] : 0.0;
    trow[j] = j < d ? tm[cdd + i * d + j] : 0.0;
  }
  for (int e = lane; e < d * d; e += kWarp) {
    const int r = e / d, col = e - r * d;
    sT[r * ld + col] = tm[cdd + e];
    sQ[r * ld + col] = rqr[cdd + e];
    sP[r * ld + col] = p0[cdd + e];
  }
  const double hh = h[c];
  const int rec = d + 1;
  const long long s_row = static_cast<long long>(c) * t_len * rec;
  const long long w_row = static_cast<long long>(c) * (t_len - 1) * d;
  const long long e_row = static_cast<long long>(c) * t_len;
  __syncwarp();

  // 1. forward: simulate alpha+ and filter y - y+ (kalman.py:460-473)
  double a_i = 0.0;  // the filter on y - y+ starts from a0 = 0
  double sim_i = alpha1[static_cast<long long>(c) * d + i];
  // step t's operands, loaded a step ahead
  double y_n = y[0], e_n = eps[e_row];
  double w_n = t_len > 1 ? w[w_row + i] : 0.0;
  bool o_n = obs == nullptr || obs[0] != 0;
  for (int t = 0; t < t_len; ++t) {
    const double yt = y_n, et = e_n, wt = w_n;
    const bool ob = o_n;
    if (t + 1 < t_len) {
      y_n = y[t + 1];
      e_n = eps[e_row + t + 1];
      o_n = obs == nullptr || obs[t + 1] != 0;
      if (t + 1 < t_len - 1) w_n = w[w_row + (t + 1) * d + i];
    }
    const double zs = warp_sum(z_i * sim_i, lane);
    const double yd = yt - (zs + et);
    const double za = warp_sum(z_i * a_i, lane);
    const double v = ob ? yd - za : 0.0;
    // P z, row i
    double pz = sP[i * ld] * zz[0];
#pragma unroll
    for (int j = 1; j < kMaxD; ++j)
      if (j < d) pz = pz + sP[i * ld + j] * zz[j];
    const double f = warp_sum(z_i * pz, lane) + hh;
    const double rf = reciprocal(f);
    if (act) {
      v1[i] = pz;
      v2[i] = a_i;
      v3[i] = sim_i;
    }
    __syncwarp();
    double tpz = trow[0] * v1[0], ta = trow[0] * v2[0];
    double ts = trow[0] * v3[0];
#pragma unroll
    for (int j = 1; j < kMaxD; ++j) {
      if (j < d) {
        tpz = tpz + trow[j] * v1[j];
        ta = ta + trow[j] * v2[j];
        ts = ts + trow[j] * v3[j];
      }
    }
    const double k_i = ob ? tpz * rf : 0.0;
    if (act) v4[i] = k_i;
    // (T P) row i: sum_m T[i][m] P[m][j]
    double tp[kMaxD];
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) {
      if (j < d) {
        double acc = trow[0] * sP[j];
#pragma unroll
        for (int m = 1; m < kMaxD; ++m)
          if (m < d) acc = acc + trow[m] * sP[m * ld + j];
        tp[j] = acc;
      }
    }
    __syncwarp();  // K is in v4; every lane has read P
    // P' row i = (T P) row i L' + R Q R' row i, L = T - K z'
    double pn[kMaxD];
#pragma unroll
    for (int j = 0; j < kMaxD; ++j) {
      if (j < d) {
        const double kj = v4[j];
        double acc = tp[0] * (sT[j * ld] - kj * zz[0]);
#pragma unroll
        for (int m = 1; m < kMaxD; ++m)
          if (m < d) acc = acc + tp[m] * (sT[j * ld + m] - kj * zz[m]);
        pn[j] = acc + sQ[i * ld + j];
      }
    }
    if (act) {
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < d) sN[i * ld + j] = pn[j];
    }
    __syncwarp();
    // 0.5 (P' + P'^T), the diagonal P'_ii exactly
    if (act) {
#pragma unroll
      for (int j = 0; j < kMaxD; ++j)
        if (j < d)
          sP[i * ld + j] = j == i ? pn[j] : 0.5 * (pn[j] + sN[j * ld + i]);
      scratch[s_row + static_cast<long long>(t) * rec + 1 + i] = k_i;
      if (lane == 0) scratch[s_row + static_cast<long long>(t) * rec] =
          v * rf;
    }
    a_i = ta + k_i * v;
    if (t < t_len - 1) sim_i = ts + wt;
    __syncwarp();  // P is whole again before the next step reads it
  }

  // 2. backward: r_{t-1} = where(obs, z v/f, 0) + L' r_t (kalman.py:315-323);
  // r_{t-1} replaces the first d of slot t
  double r_i = 0.0;
  __syncwarp();
  double vf_n = scratch[s_row + static_cast<long long>(t_len - 1) * rec];
  double k_n = scratch[s_row + static_cast<long long>(t_len - 1) * rec +
                       1 + i];
  o_n = obs == nullptr || obs[t_len - 1] != 0;
  for (int t = t_len - 1; t >= 0; --t) {
    const double vf = vf_n, k_i = k_n;
    const bool ob = o_n;
    if (t > 0) {
      vf_n = scratch[s_row + static_cast<long long>(t - 1) * rec];
      k_n = scratch[s_row + static_cast<long long>(t - 1) * rec + 1 + i];
      o_n = obs == nullptr || obs[t - 1] != 0;
    }
    if (act) {
      v1[i] = k_i;
      v2[i] = r_i;
    }
    __syncwarp();
    // sum_m L[m][i] r_m, L[m][i] = T[m][i] - K_m z_i
    double lr = (sT[i] - v1[0] * z_i) * v2[0];
#pragma unroll
    for (int m = 1; m < kMaxD; ++m)
      if (m < d) lr = lr + (sT[m * ld + i] - v1[m] * z_i) * v2[m];
    r_i = (ob ? z_i * vf : 0.0) + lr;
    if (act) scratch[s_row + static_cast<long long>(t) * rec + i] = r_i;
    __syncwarp();  // every lane has read v1, v2
  }

  // 3. forward state: alpha_1 = P0 r_0, alpha_{t+1} = T alpha_t + RQR r_t
  // (kalman.py:325, :345-350), added to alpha+ regenerated from alpha_1 and
  // w as pass 1 made it (:481)
  __syncwarp();
  sim_i = alpha1[static_cast<long long>(c) * d + i];
  if (act) v1[i] = scratch[s_row + i];  // r_0
  __syncwarp();
  double ah = p0[cdd + i * d] * v1[0];
#pragma unroll
  for (int m = 1; m < kMaxD; ++m)
    if (m < d) ah = ah + p0[cdd + i * d + m] * v1[m];
  __syncwarp();
  const long long o_row = static_cast<long long>(c) * t_len * d;
  w_n = t_len > 1 ? w[w_row + i] : 0.0;
  double r_n = scratch[s_row + i];  // slot t's r, loaded a step ahead
  for (int t = 0; t < t_len; ++t) {
    const double wt = w_n, rt = r_n;
    if (t + 1 < t_len) {
      if (t + 1 < t_len - 1) w_n = w[w_row + (t + 1) * d + i];
      r_n = scratch[s_row + static_cast<long long>(t + 1) * rec + i];
    }
    if (t > 0) {
      if (act) {
        v1[i] = ah;
        v2[i] = rt;
      }
      __syncwarp();
      double ta = trow[0] * v1[0];
      double qr = sQ[i * ld] * v2[0];
#pragma unroll
      for (int m = 1; m < kMaxD; ++m) {
        if (m < d) {
          ta = ta + trow[m] * v1[m];
          qr = qr + sQ[i * ld + m] * v2[m];
        }
      }
      ah = ta + qr;
      __syncwarp();
    }
    if (act) out[o_row + static_cast<long long>(t) * d + i] = sim_i + ah;
    if (t < t_len - 1) {
      if (act) v3[i] = sim_i;
      __syncwarp();
      double ts = trow[0] * v3[0];
#pragma unroll
      for (int m = 1; m < kMaxD; ++m)
        if (m < d) ts = ts + trow[m] * v3[m];
      sim_i = ts + wt;
      __syncwarp();
    }
  }
}

// K3: one warp a chain; lane l holds row l % d of T and D_t[l % d] of group
// g0 + l / d, 32 / d groups a pass. w [C, G, T-1, d] -> out [C, G, T, d],
// out[:, :, 0] = 0. Warps past the batch leave at once.
template <typename T>
__global__ void __launch_bounds__(128)
    dpath_kernel(const T* __restrict__ tm, const T* __restrict__ w,
                 T* __restrict__ out, int batch, int groups, int t_len,
                 int d) {
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int c = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (c >= batch) return;  // the whole warp
  const int per = kWarp / d;  // groups a pass
  const int slot = lane / d, i = lane - slot * d;
  const int src0 = slot < per ? slot * d : 0;  // the lane of D's element 0
  T trow[kMaxD];
  const long long cdd = static_cast<long long>(c) * d * d;
#pragma unroll
  for (int j = 0; j < kMaxD; ++j)
    trow[j] = j < d && slot < per ? tm[cdd + i * d + j] : T(0);
  for (int g0 = 0; g0 < groups; g0 += per) {
    const int g = g0 + slot;
    const bool act = slot < per && g < groups;
    const long long wg =
        (static_cast<long long>(c) * groups + (act ? g : 0)) * (t_len - 1);
    const long long og =
        (static_cast<long long>(c) * groups + (act ? g : 0)) * t_len;
    T dcur = T(0);
    if (act) out[og * d + i] = T(0);
#pragma unroll 4
    for (int t = 1; t < t_len; ++t) {
      const T wt = act ? w[(wg + t - 1) * d + i] : T(0);
      T acc = trow[0] * __shfl_sync(0xffffffffu, dcur, src0);
#pragma unroll
      for (int j = 1; j < kMaxD; ++j)
        if (j < d) acc = acc + trow[j] * __shfl_sync(0xffffffffu, dcur,
                                                     src0 + j);
      dcur = acc + wt;
      if (act) out[(og + t) * d + i] = dcur;
    }
  }
}

int launch_smoother_wide(const void* z, const void* tm, const void* rqr,
                         const void* h, const void* p0, const void* alpha1,
                         const void* w, const void* eps, const void* y,
                         const void* obs, void* scratch, void* out,
                         int batch, int t_len, int d, int threads,
                         void* stream) {
  if (batch < 0 || t_len < 1 || d < 1 || d > kMaxD || threads < kWarp ||
      threads > 128 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int warps = threads / kWarp;
  const int smem = warps * wide_warp_doubles(d) * 8;
  const int blocks = (batch + warps - 1) / warps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  smoother_wide_kernel<<<blocks, threads, smem, st>>>(
      static_cast<const double*>(z), static_cast<const double*>(tm),
      static_cast<const double*>(rqr), static_cast<const double*>(h),
      static_cast<const double*>(p0), static_cast<const double*>(alpha1),
      static_cast<const double*>(w), static_cast<const double*>(eps),
      static_cast<const double*>(y), static_cast<const unsigned char*>(obs),
      static_cast<double*>(scratch), static_cast<double*>(out), batch,
      t_len, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dpath(const void* tm, const void* w, void* out, int batch,
                 int groups, int t_len, int d, int threads, void* stream) {
  if (batch < 0 || groups < 1 || t_len < 1 || d < 1 || d > kMaxD ||
      threads < kWarp || threads > 128 || threads % kWarp != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int warps = threads / kWarp;
  const int blocks = (batch + warps - 1) / warps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = dpath_kernel<T>;
  kernel<<<blocks, threads, 0, st>>>(
      static_cast<const T*>(tm), static_cast<const T*>(w),
      static_cast<T*>(out), batch, groups, t_len, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries. Every array is a contiguous device array of the entry's
// type. K2w (float64): z [B, d], tm, rqr and p0 [B, d, d], h [B], alpha1
// [B, d], w [B, T-1, d], eps [B, T], y [T], obs [T] bytes (nullptr: all
// observed), scratch [B, T, d+1], out [B, T, d]; 7 <= d <= 16 is the
// wrapper's range, the kernel takes 1..16. K3: tm [B, d, d], w
// [B, G, T-1, d], out [B, G, T, d]. threads: a multiple of 32 up to 128 (a
// warp a chain). stream: a cudaStream_t. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int boom_kalman_smoother_wide_f64(
    const void* z, const void* tm, const void* rqr, const void* h,
    const void* p0, const void* alpha1, const void* w, const void* eps,
    const void* y, const void* obs, void* scratch, void* out, int batch,
    int t_len, int d, int threads, void* stream) {
  return launch_smoother_wide(z, tm, rqr, h, p0, alpha1, w, eps, y, obs,
                              scratch, out, batch, t_len, d, threads,
                              stream);
}

extern "C" int boom_dpath_f32(const void* tm, const void* w, void* out,
                              int batch, int groups, int t_len, int d,
                              int threads, void* stream) {
  return launch_dpath<float>(tm, w, out, batch, groups, t_len, d, threads,
                             stream);
}

extern "C" int boom_dpath_f64(const void* tm, const void* w, void* out,
                              int batch, int groups, int t_len, int d,
                              int threads, void* stream) {
  return launch_dpath<double>(tm, w, out, batch, groups, t_len, d, threads,
                              stream);
}

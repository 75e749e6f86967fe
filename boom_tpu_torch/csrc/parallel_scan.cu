// Parallel-in-time inclusive scans for the Kalman filter, the RTS smoother
// and the affine state recurrence, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel boom_tpu/statespace/pallas_scan.py: `_scan_kernel`
// (:186) launched by `_pallas_inclusive_scan` (:221, pallas_call at :241)
// with its three combine rules `_combine_filter_rows` (:122),
// `_combine_smooth_rows` (:168) and `_combine_affine_rows` (:156). The
// algebra is the Sarkka & Garcia-Fernandez parallel filter/smoother; the
// plain PyTorch version is boom_tpu_torch/statespace/parallel_kalman.py.
//
// Design. The TPU kernel kept the whole series resident in VMEM and ran a
// Hillis-Steele scan over lanes. That does not fit here: at T=4096, d=2 in
// float32 the 16 filter rows are 256 KiB, above the 227 KB of shared memory
// one block can have. So one CTA scans one batch row (a chain, or a
// chain x group pair) in chunks of blockDim time steps:
//   1. each thread loads one time element into registers (layout [B, F, T]:
//      for a fixed component the threads read consecutive addresses);
//      threads past T hold the combine's identity;
//   2. an inclusive warp scan with __shfl_up_sync per component;
//   3. warp 0 scans the warp totals through shared memory;
//   4. each thread combines its warp's prefix and the carry of the earlier
//      chunks, stores, and the last thread leaves the new carry.
// The earlier element is always the combine's first argument: the combines
// are associative but not commutative. `reverse` scans t = T-1 .. 0 by
// indexing, which is how the RTS smoother runs its suffix scan (the
// reference flips the array, pallas_scan.py:287).
// The d x d algebra is unrolled at compile time over the template D, as the
// Pallas kernel unrolls it at trace time; the small solves are the same
// no-pivot Gauss-Jordan as `_gj_solve` (:91), valid because the systems
// are I + (PSD)(PSD).
//
// What bounds it on this card: latency. A bsts fit has a handful of batch
// rows, so the grid fills 8-16 of the 132 SMs and each CTA walks T/blockDim
// chunks one after another. At D = 6 the filter element has F = 120
// components and the combine's temporaries exceed the register file, so it
// spills. A later change splits T across CTAs (a decoupled look-back over
// chunk aggregates) to fill the card, and keeps large-D elements in shared
// memory.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Solve M X = B in place (B becomes X) by no-pivot Gauss-Jordan.
template <typename T, int D, int M>
__device__ __forceinline__ void gj_solve(T (&a)[D][D], T (&b)[D][M]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const T inv = T(1) / a[i][i];
#pragma unroll
    for (int c = 0; c < D; ++c) a[i][c] *= inv;
#pragma unroll
    for (int c = 0; c < M; ++c) b[i][c] *= inv;
#pragma unroll
    for (int r = 0; r < D; ++r) {
      if (r == i) continue;
      const T fac = a[r][i];
#pragma unroll
      for (int c = 0; c < D; ++c) a[r][c] -= fac * a[i][c];
#pragma unroll
      for (int c = 0; c < M; ++c) b[r][c] -= fac * b[i][c];
    }
  }
}

// Filtering element [A (D*D), C (D*D), J (D*D), b (D), eta (D)], row-major
// matrices; Sarkka-Garcia-Fernandez lemma 8 with x1 the earlier element.
template <typename T, int D>
struct FilterOp {
  static constexpr int F = 3 * D * D + 2 * D;

  __device__ static void identity(T* x) {
#pragma unroll
    for (int k = 0; k < F; ++k) x[k] = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) x[i * D + i] = T(1);
  }

  __device__ static void combine(const T* x1, const T* x2, T* out) {
    const T* a1 = x1;
    const T* c1 = x1 + D * D;
    const T* j1 = x1 + 2 * D * D;
    const T* b1 = x1 + 3 * D * D;
    const T* e1 = b1 + D;
    const T* a2 = x2;
    const T* c2 = x2 + D * D;
    const T* j2 = x2 + 2 * D * D;
    const T* b2 = x2 + 3 * D * D;
    const T* e2 = b2 + D;

    // X = A2 (I + C1 J2)^{-1}: solve (I + C1 J2)' X' = A2'.
    T m[D][D];
    T xt[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = (i == j) ? T(1) : T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += c1[i * D + k] * j2[k * D + j];
        m[j][i] = s;
        xt[i][j] = a2[j * D + i];
      }
    }
    gj_solve<T, D, D>(m, xt);
    T x[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) x[i][j] = xt[j][i];

    // A = X A1
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += x[i][k] * a1[k * D + j];
        out[i * D + j] = s;
      }
    // b = X (b1 + C1 eta2) + b2
    T v[D];
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) s += c1[i * D + k] * e2[k];
      v[i] = b1[i] + s;
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) s += x[i][k] * v[k];
      out[3 * D * D + i] = s + b2[i];
    }
    // C = sym(X C1 A2' + C2)
    T xc[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += x[i][k] * c1[k * D + j];
        xc[i][j] = s;
      }
    T cm[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += xc[i][k] * a2[j * D + k];
        cm[i][j] = s + c2[i * D + j];
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j)
        out[D * D + i * D + j] = T(0.5) * (cm[i][j] + cm[j][i]);

    // (I + J2 C1) sol = [eta2 - J2 b1 | J2 A1]
    T ijc[D][D];
    T rhs[D][D + 1];
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = (i == j) ? T(1) : T(0);
        T r = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          s += j2[i * D + k] * c1[k * D + j];
          r += j2[i * D + k] * a1[k * D + j];
        }
        ijc[i][j] = s;
        rhs[i][1 + j] = r;
      }
      T s = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) s += j2[i * D + k] * b1[k];
      rhs[i][0] = e2[i] - s;
    }
    gj_solve<T, D, D + 1>(ijc, rhs);
    // eta = A1' sol[:, 0] + eta1 ; J = sym(A1' sol[:, 1:] + J1)
#pragma unroll
    for (int i = 0; i < D; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) s += a1[k * D + i] * rhs[k][0];
      out[3 * D * D + D + i] = s + e1[i];
    }
    T jm[D][D];
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += a1[k * D + i] * rhs[k][1 + j];
        jm[i][j] = s + j1[i * D + j];
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j)
        out[2 * D * D + i * D + j] = T(0.5) * (jm[i][j] + jm[j][i]);
  }
};

// [M (D*D), v (D)] elements with identity (I, 0).
template <typename T, int D>
struct MatVecIdentity {
  static constexpr int F = D * D + D;
  __device__ static void identity(T* x) {
#pragma unroll
    for (int k = 0; k < F; ++k) x[k] = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) x[i * D + i] = T(1);
  }
};

// Forward affine composition x -> A2 (A1 x + b1) + b2: (A2 A1, A2 b1 + b2).
template <typename T, int D>
struct AffineOp : MatVecIdentity<T, D> {
  __device__ static void combine(const T* x1, const T* x2, T* out) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += x2[i * D + k] * x1[k * D + j];
        out[i * D + j] = s;
      }
      T s = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) s += x2[i * D + k] * x1[D * D + k];
      out[D * D + i] = s + x2[D * D + i];
    }
  }
};

// RTS suffix composition in a reverse scan: x1 is the accumulated
// later-in-time suffix, x2 the earlier element: (E2 E1, g2 + E2 g1).
template <typename T, int D>
struct SmoothOp : MatVecIdentity<T, D> {
  __device__ static void combine(const T* x1, const T* x2, T* out) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += x2[i * D + k] * x1[k * D + j];
        out[i * D + j] = s;
      }
      T s = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) s += x2[i * D + k] * x1[D * D + k];
      out[D * D + i] = x2[D * D + i] + s;
    }
  }
};

template <typename T, int F>
__device__ __forceinline__ void copy_el(const T* src, T* dst) {
#pragma unroll
  for (int k = 0; k < F; ++k) dst[k] = src[k];
}

// One CTA per batch row; see the design note at the top of the file.
template <typename T, class Op, int NT>
__global__ void __launch_bounds__(NT)
    scan_kernel(const T* __restrict__ in, T* __restrict__ out, int t_len,
                int reverse) {
  constexpr int F = Op::F;
  constexpr int NW = NT / 32;
  __shared__ T warp_tot[NW][F];
  __shared__ T carry[F];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = static_cast<size_t>(blockIdx.x) * F * t_len;
  const T* src = in + base;
  T* dst = out + base;

  T x[F];
  T y[F];
  T tmp[F];
  for (int c0 = 0; c0 < t_len; c0 += NT) {
    const int g = c0 + tid;
    const int t = reverse ? t_len - 1 - g : g;
    if (g < t_len) {
#pragma unroll
      for (int k = 0; k < F; ++k) x[k] = src[static_cast<size_t>(k) * t_len + t];
    } else {
      Op::identity(x);
    }

    // 2. inclusive warp scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
      for (int k = 0; k < F; ++k) y[k] = __shfl_up_sync(kFullMask, x[k], off);
      if (lane >= off) {
        Op::combine(y, x, tmp);
        copy_el<T, F>(tmp, x);
      }
    }
    if (lane == 31) copy_el<T, F>(x, warp_tot[warp]);
    __syncthreads();

    // 3. warp 0 scans the warp totals
    if (warp == 0) {
      if (lane < NW) {
        copy_el<T, F>(warp_tot[lane], y);
      } else {
        Op::identity(y);
      }
#pragma unroll
      for (int off = 1; off < NW; off <<= 1) {
#pragma unroll
        for (int k = 0; k < F; ++k)
          tmp[k] = __shfl_up_sync(kFullMask, y[k], off);
        if (lane >= off) {
          T res[F];
          Op::combine(tmp, y, res);
          copy_el<T, F>(res, y);
        }
      }
      if (lane < NW) copy_el<T, F>(y, warp_tot[lane]);
    }
    __syncthreads();

    // 4. earlier warps of this chunk, then earlier chunks
    if (warp > 0) {
      Op::combine(warp_tot[warp - 1], x, tmp);
      copy_el<T, F>(tmp, x);
    }
    if (c0 > 0) {
      Op::combine(carry, x, tmp);
      copy_el<T, F>(tmp, x);
    }
    if (g < t_len) {
#pragma unroll
      for (int k = 0; k < F; ++k) dst[static_cast<size_t>(k) * t_len + t] = x[k];
    }
    __syncthreads();  // every read of carry and warp_tot is done
    if (tid == NT - 1) copy_el<T, F>(x, carry);
    // the next chunk's first __syncthreads publishes the new carry
  }
}

template <typename T, class Op>
int launch(const void* in, void* out, int batch, int t_len, int reverse,
           void* stream) {
  if (batch <= 0 || t_len <= 0) return 0;
  // Large elements (filter at D >= 3) need many registers a thread, so
  // they run 128 threads a CTA; small ones 256.
  constexpr int NT = Op::F <= 16 ? 256 : 128;
  scan_kernel<T, Op, NT><<<batch, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), t_len, reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, one per (combine, dtype, D): boom_scan_<op>_<f32|f64>_d<D>.
// in/out: contiguous [batch, F, t_len] device arrays; stream: a cudaStream_t.
// Returns the cudaError_t of the launch (0 = success).
#define BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, D)                             \
  extern "C" int boom_scan_##NAME##_##TYNAME##_d##D(                         \
      const void* in, void* out, int batch, int t_len, int reverse,          \
      void* stream) {                                                        \
    return launch<TY, OP<TY, D>>(in, out, batch, t_len, reverse, stream);    \
  }

#define BOOM_SCAN_ALL_D(NAME, OP, TY, TYNAME) \
  BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, 1)    \
  BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, 2)    \
  BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, 3)    \
  BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, 4)    \
  BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, 5)    \
  BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, 6)

BOOM_SCAN_ALL_D(filter, FilterOp, float, f32)
BOOM_SCAN_ALL_D(smooth, SmoothOp, float, f32)
BOOM_SCAN_ALL_D(affine, AffineOp, float, f32)
BOOM_SCAN_ALL_D(filter, FilterOp, double, f64)
BOOM_SCAN_ALL_D(smooth, SmoothOp, double, f64)
BOOM_SCAN_ALL_D(affine, AffineOp, double, f64)

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
// What bounds it on this card. Bytes: a scan reads and writes the [B, F, T]
// elements once, 8.4 MB for the float64 filter at the fit's shape (B=8,
// T=4096, d=2), 2.5 us at 3.35 TB/s; the arithmetic (about 250 flops a
// filter combine at d=2, T-1 combines a row) is under 1 us at the card's
// float64 rate. Both are below the latency of a launch and of the chain of
// dependent combines a tile has to walk, so the scan is latency bound: the
// goal is many CTAs in flight, few combines on each chain, and operands in
// shared memory rather than in registers that spill.
//
// Design: reduce-then-scan over tiles of L time steps (TileShape below).
// The TPU kernel kept the whole series in VMEM; a series does not fit in
// the 227 KB a block may have, so T is split across CTAs:
//   A. `tile_totals`, one CTA per (batch row, tile): the tile's total;
//   B. `scan_totals`, one CTA per batch row: the inclusive scan of the
//      row's tile totals, in place in the scratch array;
//   C. `tile_rescan`, one CTA per (batch row, tile): the tile's inclusive
//      scan, started from the scanned total of the tile before it.
// A series of one tile launches C alone. Inside a tile (`scan_tile`), each
// of the NT threads owns K = L/NT consecutive elements: a serial in-thread
// scan, a Kogge-Stone scan of the NT thread totals, then each thread's
// elements combined with its exclusive prefix: about 2-3 combines an
// element, where warp-shuffle scans over chunks of one CTA per batch row
// pay about 8 (and fill 8 of the 132 SMs at the fit's shape).
// Determinism: every combine's operands are fixed by (B, T, tile shape)
// alone, never by timing, so equal inputs give bit-identical outputs. A
// decoupled look-back would combine as many predecessors as happen to be
// ready, which changes the rounding from run to run; the fit's "same seed,
// same draws" rules it out, and the two extra launches are cheaper than
// the flags a chained scan needs.
// Elements live in shared memory, element-major with an odd stride S >= F
// (conflict-free column access), staged from the [B, F, T] layout with
// 4- or 8-byte cp.async copies, which need no alignment beyond the
// element type's, so any T works. The combines work through pointers into
// shared memory; no thread holds an element in registers (at D = 6 a
// float64 filter element is 120 values, more than the register file
// leaves a thread).
// The earlier element is always the combine's first argument: the combines
// are associative but not commutative. `reverse` scans t = T-1 .. 0 by
// indexing, which is how the RTS smoother runs its suffix scan (the
// reference flips the array, pallas_scan.py:287).
// The d x d algebra is unrolled at compile time over the template D, as the
// Pallas kernel unrolls it at trace time; the small solves are the same
// no-pivot Gauss-Jordan as `_gj_solve` (:91), valid because the systems
// are I + (PSD)(PSD).

#include <climits>

#include <cuda_runtime.h>

namespace {

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

// m <- (m + m') / 2 in place, for a row-major D x D matrix.
template <typename T, int D>
__device__ __forceinline__ void symmetrize(T* m) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = i; j < D; ++j) {
      const T s = T(0.5) * (m[i * D + j] + m[j * D + i]);
      m[i * D + j] = s;
      m[j * D + i] = s;
    }
}

// Filtering element [A (D*D), C (D*D), J (D*D), b (D), eta (D)], row-major
// matrices; Sarkka-Garcia-Fernandez lemma 8 with x1 the earlier element.
// In every combine `out` aliases neither operand.
template <typename T, int D>
struct FilterOp {
  static constexpr int F = 3 * D * D + 2 * D;

  __device__ static void combine(const T* __restrict__ x1,
                                 const T* __restrict__ x2,
                                 T* __restrict__ out) {
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
    // C = sym(X C1 A2' + C2). X C1 goes through the J slot of `out` (not
    // yet written) and the unsymmetrized C through its own slot, so that
    // at most two d x d matrices are live in registers at a time.
    T* xc = out + 2 * D * D;
    T* cm = out + D * D;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += x[i][k] * c1[k * D + j];
        xc[i * D + j] = s;
      }
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += xc[i * D + k] * a2[j * D + k];
        cm[i * D + j] = s + c2[i * D + j];
      }
    symmetrize<T, D>(cm);

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
    T* jm = out + 2 * D * D;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T s = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) s += a1[k * D + i] * rhs[k][1 + j];
        jm[i * D + j] = s + j1[i * D + j];
      }
    symmetrize<T, D>(jm);
  }
};

// [M (D*D), v (D)] elements.
template <int D>
struct MatVec {
  static constexpr int F = D * D + D;
};

// Forward affine composition x -> A2 (A1 x + b1) + b2: (A2 A1, A2 b1 + b2).
template <typename T, int D>
struct AffineOp : MatVec<D> {
  __device__ static void combine(const T* __restrict__ x1,
                                 const T* __restrict__ x2,
                                 T* __restrict__ out) {
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
struct SmoothOp : MatVec<D> {
  __device__ static void combine(const T* __restrict__ x1,
                                 const T* __restrict__ x2,
                                 T* __restrict__ out) {
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
__device__ __forceinline__ void copy_el(const T* __restrict__ src,
                                        T* __restrict__ dst) {
#pragma unroll
  for (int k = 0; k < F; ++k) dst[k] = src[k];
}

// Tile of L time steps scanned by NT threads, K = L / NT each. A tile's
// shared memory is L + 2 NT element slots of S values: the tile, then the
// thread totals, then one scratch slot a thread. Small elements take
// 256-step tiles (16 tiles of T=4096: 128 CTAs for 8 chains); large ones
// 128-step tiles with fewer threads, so that the largest, the float64
// filter at D = 6 (968 bytes a slot), still fits in 227 KB.
template <typename T, int F>
struct TileShape {
  static constexpr int S = F | 1;
  static constexpr int kSlotBytes = S * static_cast<int>(sizeof(T));
  static constexpr int L = kSlotBytes <= 192 ? 256 : 128;
  static constexpr int NT = kSlotBytes <= 192 ? 128
                            : (kSlotBytes <= 880 ? 64 : 32);
  static constexpr int K = L / NT;
  static constexpr int kSmemBytes = (L + 2 * NT) * kSlotBytes;
  static_assert(kSmemBytes <= 232448, "a tile must fit in 227 KB");
};

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4- or 8-byte copies");
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Steps g0 .. g0+n-1 (scan order) of one batch row src [F, t_len] into
// shared memory, element-major; consecutive threads read consecutive
// addresses of one component row.
template <typename T, class Op>
__device__ void load_rows(const T* __restrict__ src, T* buf, int t_len,
                          int g0, int n, int reverse) {
  using Sh = TileShape<T, Op::F>;
  for (int idx = threadIdx.x; idx < Op::F * Sh::L; idx += Sh::NT) {
    const int k = idx / Sh::L;
    const int e = idx - k * Sh::L;
    if (e < n) {
      const int g = g0 + e;
      const int t = reverse ? t_len - 1 - g : g;
      cp_async(buf + e * Sh::S + k, src + static_cast<size_t>(k) * t_len + t);
    }
  }
  cp_async_wait_all();
  __syncthreads();
}

template <typename T, class Op>
__device__ void store_rows(const T* buf, T* __restrict__ dst, int t_len,
                           int g0, int n, int reverse) {
  using Sh = TileShape<T, Op::F>;
  for (int idx = threadIdx.x; idx < Op::F * Sh::L; idx += Sh::NT) {
    const int k = idx / Sh::L;
    const int e = idx - k * Sh::L;
    if (e < n) {
      const int g = g0 + e;
      const int t = reverse ? t_len - 1 - g : g;
      dst[static_cast<size_t>(k) * t_len + t] = buf[e * Sh::S + k];
    }
  }
}

// Inclusive scan in place of the first n (1 <= n <= L) elements of `buf`,
// all of them preceded by `pre` when it is not null (the scanned total of
// everything before the tile, in device or shared memory). Leaves the
// tile's total in agg[(n_threads - 1) * S] before the prefix is applied;
// `totals_only` stops there. Every thread of the block must call it.
template <typename T, class Op>
__device__ void scan_tile(T* buf, T* agg, T* tmp, int n, const T* pre,
                          bool totals_only) {
  using Sh = TileShape<T, Op::F>;
  constexpr int F = Op::F;
  constexpr int S = Sh::S;
  constexpr int K = Sh::K;
  const int j = threadIdx.x;
  const int e0 = j * K;
  const int m = min(K, n - e0);         // this thread's elements
  const int n_threads = (n + K - 1) / K;  // threads that own any
  T* mine = tmp + j * S;

  // 1. serial scan of this thread's K elements
  for (int i = 1; i < m; ++i) {
    T* cur = buf + (e0 + i) * S;
    Op::combine(cur - S, cur, mine);
    copy_el<T, F>(mine, cur);
  }
  if (j < n_threads) copy_el<T, F>(buf + (e0 + m - 1) * S, agg + j * S);
  __syncthreads();

  // 2. Kogge-Stone scan of the thread totals
  for (int s = 1; s < n_threads; s <<= 1) {
    const bool active = j < n_threads && j >= s;
    if (active) Op::combine(agg + (j - s) * S, agg + j * S, mine);
    __syncthreads();
    if (active) copy_el<T, F>(mine, agg + j * S);
    __syncthreads();
  }
  if (totals_only) return;

  // 3. each thread's exclusive prefix, then its elements
  const bool has_prefix = j < n_threads && (pre != nullptr || j > 0);
  if (has_prefix) {
    if (pre != nullptr && j > 0) {
      Op::combine(pre, agg + (j - 1) * S, mine);
    } else {
      copy_el<T, F>(j > 0 ? agg + (j - 1) * S : pre, mine);
    }
  }
  __syncthreads();  // agg is read no more: slot j is thread j's scratch
  if (has_prefix) {
    T* out = agg + j * S;
    for (int i = 0; i < m; ++i) {
      T* cur = buf + (e0 + i) * S;
      Op::combine(mine, cur, out);
      copy_el<T, F>(out, cur);
    }
  }
  __syncthreads();
}

// Shared memory of one tile: buf (L slots), agg (NT), tmp (NT).
template <typename T>
__device__ __forceinline__ T* tile_smem() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
}

// A. totals[b, tile] = the combine of the tile's elements, in scan order.
template <typename T, class Op>
__global__ void __launch_bounds__(TileShape<T, Op::F>::NT)
    tile_totals(const T* __restrict__ in, T* __restrict__ totals, int t_len,
                int n_tiles, int reverse) {
  using Sh = TileShape<T, Op::F>;
  const int b = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - b * n_tiles;
  const int n = min(Sh::L, t_len - tile * Sh::L);
  T* buf = tile_smem<T>();
  T* agg = buf + Sh::L * Sh::S;
  load_rows<T, Op>(in + static_cast<size_t>(b) * Op::F * t_len, buf, t_len,
                   tile * Sh::L, n, reverse);
  scan_tile<T, Op>(buf, agg, agg + Sh::NT * Sh::S, n, nullptr, true);
  const T* total = agg + ((n + Sh::K - 1) / Sh::K - 1) * Sh::S;
  T* dst = totals + static_cast<size_t>(blockIdx.x) * Op::F;
  for (int k = threadIdx.x; k < Op::F; k += Sh::NT) dst[k] = total[k];
}

// B. Inclusive scan in place of each row's n_tiles totals ([n_tiles, F],
// element-major), L at a time; each chunk starts from the last total of
// the one before it, which this block wrote.
template <typename T, class Op>
__global__ void __launch_bounds__(TileShape<T, Op::F>::NT)
    scan_totals(T* totals, int n_tiles) {
  using Sh = TileShape<T, Op::F>;
  constexpr int F = Op::F;
  T* row = totals + static_cast<size_t>(blockIdx.x) * n_tiles * F;
  T* buf = tile_smem<T>();
  T* agg = buf + Sh::L * Sh::S;
  for (int c0 = 0; c0 < n_tiles; c0 += Sh::L) {
    const int n = min(Sh::L, n_tiles - c0);
    for (int idx = threadIdx.x; idx < n * F; idx += Sh::NT)
      buf[(idx / F) * Sh::S + idx % F] = row[c0 * F + idx];
    __syncthreads();
    scan_tile<T, Op>(buf, agg, agg + Sh::NT * Sh::S, n,
                     c0 > 0 ? row + (c0 - 1) * F : nullptr, false);
    for (int idx = threadIdx.x; idx < n * F; idx += Sh::NT)
      row[c0 * F + idx] = buf[(idx / F) * Sh::S + idx % F];
    __syncthreads();  // the next chunk reads this chunk's last total
  }
}

// C. The tile's inclusive scan after the scanned totals of earlier tiles.
template <typename T, class Op>
__global__ void __launch_bounds__(TileShape<T, Op::F>::NT)
    tile_rescan(const T* __restrict__ in, T* __restrict__ out,
                const T* __restrict__ totals, int t_len, int n_tiles,
                int reverse) {
  using Sh = TileShape<T, Op::F>;
  const int b = blockIdx.x / n_tiles;
  const int tile = blockIdx.x - b * n_tiles;
  const int n = min(Sh::L, t_len - tile * Sh::L);
  const size_t base = static_cast<size_t>(b) * Op::F * t_len;
  T* buf = tile_smem<T>();
  T* agg = buf + Sh::L * Sh::S;
  load_rows<T, Op>(in + base, buf, t_len, tile * Sh::L, n, reverse);
  scan_tile<T, Op>(
      buf, agg, agg + Sh::NT * Sh::S, n,
      tile > 0 ? totals + (static_cast<size_t>(blockIdx.x) - 1) * Op::F
               : nullptr,
      false);
  store_rows<T, Op>(buf, out + base, t_len, tile * Sh::L, n, reverse);
}

template <typename T, class Op>
int launch(const void* in, void* out, void* totals, long long totals_len,
           int batch, int t_len, int reverse, void* stream) {
  using Sh = TileShape<T, Op::F>;
  if (batch <= 0 || t_len <= 0) return 0;
  const int n_tiles = (t_len + Sh::L - 1) / Sh::L;
  const long long blocks = static_cast<long long>(batch) * n_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles > 1 && totals_len < blocks * Op::F)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* src = static_cast<const T*>(in);
  T* agg = static_cast<T*>(totals);
  cudaError_t rc;
  // above 48 KB a block needs the opt-in; set it for every kernel, every
  // call (it is per device, and cheap)
  if (n_tiles > 1) {
    rc = cudaFuncSetAttribute(tile_totals<T, Op>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Sh::kSmemBytes);
    if (rc == cudaSuccess)
      rc = cudaFuncSetAttribute(scan_totals<T, Op>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                Sh::kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    tile_totals<T, Op><<<static_cast<int>(blocks), Sh::NT, Sh::kSmemBytes,
                         st>>>(src, agg, t_len, n_tiles, reverse);
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
    scan_totals<T, Op><<<batch, Sh::NT, Sh::kSmemBytes, st>>>(agg, n_tiles);
    if ((rc = cudaGetLastError()) != cudaSuccess) return static_cast<int>(rc);
  }
  rc = cudaFuncSetAttribute(tile_rescan<T, Op>,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            Sh::kSmemBytes);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  tile_rescan<T, Op><<<static_cast<int>(blocks), Sh::NT, Sh::kSmemBytes,
                       st>>>(src, static_cast<T*>(out), agg, t_len, n_tiles,
                             reverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, one per (combine, dtype, D): boom_scan_<op>_<f32|f64>_d<D>.
// in/out: contiguous [batch, F, t_len] device arrays; totals: device scratch
// of totals_len elements, at least batch * ceil(t_len / L) * F when the
// series spans more than one tile (L >= 128, see TileShape); stream: a
// cudaStream_t. Returns the cudaError_t of the launches (0 = success).
#define BOOM_SCAN_ENTRY(NAME, OP, TY, TYNAME, D)                             \
  extern "C" int boom_scan_##NAME##_##TYNAME##_d##D(                         \
      const void* in, void* out, void* totals, long long totals_len,         \
      int batch, int t_len, int reverse, void* stream) {                     \
    return launch<TY, OP<TY, D>>(in, out, totals, totals_len, batch, t_len,  \
                                 reverse, stream);                           \
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

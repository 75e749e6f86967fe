"""Rehearse the sequential Kalman kernels (K1, K2; K1w, J1, J2, K2w and
K3), kernel (a) and the HMM's H1 and H2 on a machine without a card.

    python3 boom_tpu_torch/kernels/host_rehearsal.py          # kernels
    python3 boom_tpu_torch/kernels/host_rehearsal.py --llt    # + bsts_llt

``csrc/kalman_seq.cu``, ``csrc/kalman_wide.cu``, ``csrc/ssvs_sweep.cu`` and
``csrc/hmm.cu`` are compiled as host C++ with ``g++``: a shim header defines the CUDA keywords away and gives
``blockIdx``/``blockDim``/``threadIdx`` as thread-local globals, and every
``kernel<<<blocks, threads, ...>>>(args)`` becomes ``host_launch``, which
runs a block's threads as fibers on the calling thread, one block after
another: a thread runs until it reaches a barrier, one for the block
(``__syncthreads``), one for each warp of 32 (``__syncwarp``, and
``__shfl_sync`` and ``__ballot_sync``, which exchange values through the
warp's slots at one of its barriers), and the barrier opens when all its
threads have reached it. When no thread can run and some have not
ended, a barrier is never met: every waiting thread leaves at its
barrier and the launch returns ``cudaErrorLaunchTimeout`` (702), which
the wrappers raise, so that such a barrier fails a check instead of
hanging it. The
library is bound in place of the ``nvcc`` build, so ``kalman_kernel``'s
wrappers run the kernels' own arithmetic on CPU tensors, which are checked
against the plain versions (K1 and K1w with a series a group of systems
and their innovations in float64 and float32, :func:`check_loglik`; K2;
J1 and J2, the derivative kernels along K directions, against autograd of
the plain loop, :func:`check_jets`), and kernel (a),
the SSVS indicator sweep, against ``regression_sweep.draw_indicators_swept``
(33 chains, p in {1, 31, 32, 33, 37}, mode jump off and on, max_size
unset and set, float64 and float32: masks identical), K2w and K3 against
``kalman.simulation_smoother`` and ``kalman.dpath`` (:func:`check_wide`)
and kernel (a)'s per-chain entry against the plain sweep on per-chain
statistics (:func:`check_ssvs_border`), and the time-varying forms
(:func:`check_time_varying`: K2w's structured form where every chain
shares T, its dense form where each has its own), and H1 and H2 against
``hmm.forward_filter`` and ``hmm.backward_sample_stats`` (:func:`check_hmm`:
S 1-16, L lanes a chain of 1, 8 and 32, T across the split's and the staged
chunks' edges, log alphas below -87). ``--llt`` then
runs the bsts_llt path (the bench's series, T=500, TIM, float32, smoother
in float64) for 32 chains, 100 + 200 sweeps, through the host-compiled
kernels and prints R-hat, ESS and the
variances' medians. Every number it prints is of the host CPU, never a
device metric; it finds faults in the kernels' arithmetic before a chip
run, not their speed.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from boom_tpu_torch.kernels import _build  # noqa: E402

SHIM = r"""#pragma once
#include <algorithm>
#include <cmath>
#include <cstring>
#include <memory>
#include <vector>

#include <sys/mman.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __constant__
#define __grid_constant__
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchTimeout = 702  // a barrier was not met by its deadline
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributePreferredSharedMemoryCarveout = 9
};
struct cudaFuncAttributes { int maxThreadsPerBlock; };
enum cudaMemcpyKind { cudaMemcpyDeviceToDevice = 3 };
// launches run one after another on the host: the copy is made at once
template <class S>
cudaError_t cudaMemcpyToSymbolAsync(S& symbol, const void* src, size_t count,
                                    size_t offset, cudaMemcpyKind,
                                    cudaStream_t) {
  std::memcpy(reinterpret_cast<char*>(&symbol) + offset, src, count);
  return cudaSuccess;
}
static cudaError_t host_last_error = cudaSuccess;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = host_last_error;
  host_last_error = cudaSuccess;
  return e;
}
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;  // an H100's SMs, so that K1's grid is laid out as there
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  a->maxThreadsPerBlock = 1024;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// resident blocks an SM that cudaOccupancyMaxActiveBlocksPerMultiprocessor
// reports (boom_host_set_occupancy: a launcher's choices at other loads)
static int host_blocks_per_sm = 1;
extern "C" void boom_host_set_occupancy(int blocks) {
  host_blocks_per_sm = blocks;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int,
                                                          size_t) {
  *n = host_blocks_per_sm;
  return cudaSuccess;
}
struct HostDim3 { int x, y, z; };
static thread_local HostDim3 blockIdx, blockDim, threadIdx;

// A block's threads run as fibers on the launching thread: each runs until
// it reaches a barrier (or ends), then the next one that can run does. A
// barrier that every thread of its block (__syncthreads) or warp
// (__syncwarp, a shuffle, a ballot) has reached opens; when no thread can
// run and some have not ended, a barrier is never met: the launch ends at
// once with cudaErrorLaunchTimeout, every waiting thread leaving at its
// barrier, so that a barrier mismatch fails a check instead of hanging it.
// A barrier costs a switch of stacks, not a wake-up of host threads.
struct HostAbort {};
static bool host_aborted = false;
// bounds nothing since an unmet barrier is found at once; kept settable
extern "C" void boom_host_set_deadline(double) {}

// saves the callee-saved registers and the stack pointer into *save_sp,
// then loads load_sp's and returns into the fiber it belongs to
extern "C" void boom_host_switch(void** save_sp, void* load_sp);
#if defined(__x86_64__)
asm(R"(
  .text
  .p2align 4
  .globl boom_host_switch
  .hidden boom_host_switch
  .type boom_host_switch, @function
boom_host_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size boom_host_switch, .-boom_host_switch
)");
#else
#error "the host rehearsal's fibers switch stacks for x86-64 only"
#endif

class HostBarrier;
struct HostWarp;
struct HostFiber {
  void* sp = nullptr;
  int t = 0;
  HostWarp* warp = nullptr;
  int slot_set = 0;
  HostBarrier* waiting = nullptr;
  long wait_gen = 0;
  bool done = false;
};
static thread_local HostFiber* host_fiber;
static thread_local void* host_sched_sp;

class HostBarrier {
 public:
  explicit HostBarrier(int n) : n_(n) {}
  void wait() {
    if (host_aborted) throw HostAbort{};
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      return;
    }
    host_fiber->waiting = this;
    host_fiber->wait_gen = gen_;
    boom_host_switch(&host_fiber->sp, host_sched_sp);
    if (host_aborted) throw HostAbort{};
  }
  bool open(long gen) const { return gen_ != gen; }

 private:
  int n_, count_ = 0;
  long gen_ = 0;
};

// A warp's barrier and its exchange slots (__shfl_sync, __ballot_sync),
// two sets used in turn: a lane writes one set, meets the others at the
// barrier and reads it; the next exchange writes the other set, and the
// first is written again only after every lane has passed the barrier
// that follows its reads.
struct HostWarp {
  explicit HostWarp(int lanes) : bar(lanes) {}
  HostBarrier bar;
  unsigned long long slot[2][32];
};
static thread_local HostBarrier* host_block_bar;

inline void __syncthreads() { host_block_bar->wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  host_fiber->warp->bar.wait();
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "shfl");
  HostFiber* f = host_fiber;
  unsigned long long* slot = f->warp->slot[f->slot_set];
  f->slot_set ^= 1;
  std::memcpy(&slot[threadIdx.x & 31], &v, sizeof(T));
  f->warp->bar.wait();
  T out;
  std::memcpy(&out, &slot[src & 31], sizeof(T));
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  HostFiber* f = host_fiber;
  unsigned long long* slot = f->warp->slot[f->slot_set];
  f->slot_set ^= 1;
  slot[threadIdx.x & 31] = pred != 0;
  f->warp->bar.wait();
  unsigned bits = 0;
  for (int l = 0; l < 32 && (threadIdx.x & ~31) + l < blockDim.x; ++l)
    bits |= static_cast<unsigned>(slot[l]) << l;
  return bits;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __threadfence_block() {}
inline float __frcp_rn(float x) { return 1.0f / x; }
inline double __drcp_rn(double x) { return 1.0 / x; }
inline float __logf(float x) { return std::log(x); }
inline float __expf(float x) { return std::exp(x); }
// one IEEE operation each (x86-64 without -mfma does not contract them)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
using std::log;
alignas(16) static unsigned char host_shared[232448];
#define BOOM_SHARED_BYTES(name) unsigned char* name = host_shared
static thread_local void (*host_call)(void*);
static thread_local void* host_arg;
// a fiber's first frame: the block's body, then back to the scheduler
static void host_fiber_main() {
  try {
    host_call(host_arg);
  } catch (const HostAbort&) {
  }
  host_fiber->done = true;
  boom_host_switch(&host_fiber->sp, host_sched_sp);
  __builtin_trap();
}
// blocks run one after another and share host_shared; a block's threads
// are fibers with stacks of 4 MB each (reserved, touched as used)
template <class Body>
void host_launch(int blocks, int threads, Body body) {
  constexpr size_t kStack = size_t(1) << 22;
  host_aborted = false;
  host_call = [](void* p) { (*static_cast<Body*>(p))(); };
  host_arg = &body;
  char* stacks = static_cast<char*>(
      mmap(nullptr, kStack * threads, PROT_READ | PROT_WRITE,
           MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0));
  std::vector<HostFiber> fibers(threads);
  for (int b = 0; b < blocks && !host_aborted; ++b) {
    HostBarrier block(threads);
    std::vector<std::unique_ptr<HostWarp>> warps;
    for (int w = 0; w * 32 < threads; ++w)
      warps.emplace_back(new HostWarp(std::min(32, threads - w * 32)));
    host_block_bar = &block;
    blockIdx = {b, 0, 0};
    blockDim = {threads, 1, 1};
    for (int t = 0; t < threads; ++t) {
      fibers[t] = HostFiber{};
      fibers[t].t = t;
      fibers[t].warp = warps[t / 32].get();
      // the first switch pops six registers and returns into
      // host_fiber_main with the stack as a call leaves it
      void** sp = reinterpret_cast<void**>(stacks + kStack * (t + 1)) - 2;
      *sp = reinterpret_cast<void*>(&host_fiber_main);
      sp -= 6;
      for (int i = 0; i < 6; ++i) sp[i] = nullptr;
      fibers[t].sp = sp;
    }
    for (int left = threads; left > 0;) {
      bool ran = false;
      for (HostFiber& f : fibers) {
        if (f.done || (!host_aborted && f.waiting != nullptr &&
                       !f.waiting->open(f.wait_gen)))
          continue;
        f.waiting = nullptr;
        host_fiber = &f;
        threadIdx = {f.t, 0, 0};
        boom_host_switch(&host_sched_sp, f.sp);
        ran = true;
        if (f.done) --left;
      }
      // no thread can run: a barrier is never met; resume the waiting
      // threads, which leave at their barriers
      if (!ran) host_aborted = true;
    }
  }
  munmap(stacks, kStack * threads);
  if (host_aborted) host_last_error = cudaErrorLaunchTimeout;
}
"""
_LAUNCH = re.compile(r"(\w+)<<<\s*(\w+)\s*,\s*(\w+)\s*,[^>]*>>>\(")


def _host_launches(src: str) -> str:
    """Every ``kernel<<<blocks, threads, ...>>>(args);`` as
    ``host_launch(blocks, threads, [&] { kernel(args); });``."""
    out, pos = [], 0
    for m in _LAUNCH.finditer(src):
        depth, i = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(src[i], 0)
            i += 1
        kern, blocks, threads = m.groups()
        out += [src[pos:m.start()],
                f"host_launch({blocks}, {threads}, [&] {{ {kern}(",
                src[m.end():i], "; })"]
        pos = i
    return "".join(out + [src[pos:]])


def build_host_library(name="kalman_seq", text=None, variant="") -> Path:
    """Compile the source ``name`` (``_build.SOURCES``), or the source
    ``text`` under that name, for the host into
    build/boom_tpu_torch/host/<name>[_<variant>] (a ``variant`` for a
    caller that may build the same source while another does)."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise SystemExit("host_rehearsal: needs g++")
    # a directory a source, so that two builds at once never share a file
    out_dir = _build.BUILD_DIR / "host" / (f"{name}_{variant}" if variant
                                           else name)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "cuda_runtime.h").write_text(SHIM)
    if text is None:
        text = _build.SOURCES[name].read_text()
    src = _host_launches(text)
    (out_dir / f"{name}_host.cpp").write_text(src)
    lib = out_dir / f"libboom_{name}_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-shared", "-fPIC",
                    "-pthread", "-I", str(out_dir), "-o", str(lib),
                    str(out_dir / f"{name}_host.cpp")], check=True)
    return lib


def bind(libs: dict):
    """Make kalman_kernel, ssvs_kernel and hmm_kernel launch the host
    libraries ({source name: library}) on CPU tensors."""
    from boom_tpu_torch.models import hmm_kernel as hk
    from boom_tpu_torch.models.glm import ssvs_kernel as sk
    from boom_tpu_torch.statespace import kalman_kernel as kk

    _build.build = lambda names=None: {n: libs[n] for n in names}
    _build.library.cache_clear()
    for mod in (kk, sk, hk):
        mod._on_card = lambda x: True
        mod._stream = lambda device: 0


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def check_kernels(seed=0):
    """K1 and K2 against the plain versions, and the gradient and Hessian
    that autograd reaches through J1 and J2 (``loglik_along`` in the log
    variances) against autograd of the plain loop: returns the worst
    normwise relative error of each."""
    import torch

    from boom_tpu_torch.kernels.kalman_timing import system
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    rng = np.random.default_rng(seed)
    worst = {}
    # K2's chunk edges (kk.SMOOTHER_CHUNK = 32 steps) and a second, ragged
    # warp of chains
    cases = ((5, 2, False), (5, 31, True), (5, 32, False), (5, 33, True),
             (5, 67, False), (33, 67, True), (5, 200, False))
    for dtype in ("float64", "float32"):
        for d in (1, 2, 3, 6):
            for c, t_len, masked in cases:
                params = system(rng, c, d, dtype, device="cpu")
                tdt = getattr(torch, dtype)
                y = torch.tensor(rng.normal(size=t_len).cumsum(), dtype=tdt)
                obs = (torch.tensor(rng.uniform(size=t_len) > 0.3)
                       if masked else None)
                errs = {f"loglik {dtype}": _rel(
                    kk.kalman_loglik(params, y, obs),
                    kalman.kalman_loglik(params, y, obs))}
                if dtype == "float64":
                    nz = [torch.tensor(rng.normal(size=s), dtype=tdt)
                          for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
                    errs["smoother"] = _rel(
                        kk.simulation_smoother(params, y, *nz,
                                               observed=obs),
                        kalman.simulation_smoother(params, y, *nz,
                                                   observed=obs))
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
    for d in (1, 2):
        for masked in (False, True):
            # through autograd: the gradient (J1) and the Hessian (J2) in
            # the log variances, along the directions of h and Q's diagonal
            y = torch.tensor(rng.normal(size=60).cumsum())
            obs = torch.tensor(rng.uniform(size=60) > 0.3) if masked else None
            one = system(rng, 1, d, "float64", device="cpu")
            dh = torch.eye(d + 1, dtype=torch.float64)[d]
            dm = torch.zeros(d + 1, d, d, dtype=torch.float64)
            dm[:d] = torch.diag_embed(torch.eye(d, dtype=torch.float64))
            zero = torch.zeros(1, dtype=torch.float64)

            def f(u, fn, one=one, dh=dh, dm=dm, zero=zero, y=y, obs=obs):
                return fn(torch.exp(u)[None], zero, 0.0 * dm[:1], dh, dm,
                          one.z, one.t_mat, one.a0, one.p0, y, obs)[0]

            u0 = torch.linspace(-1.0, 0.3, d + 1, dtype=torch.float64)
            got = []
            for fn in (kk.loglik_along, kalman.loglik_along):
                u = u0.clone().requires_grad_(True)
                (g,) = torch.autograd.grad(f(u, fn), u)
                got.append((g, torch.autograd.functional.hessian(
                    lambda x, fn=fn: f(x, fn), u0)))
            worst["gradient"] = max(worst.get("gradient", 0.0),
                                    _rel(got[0][0], got[1][0]))
            worst["hessian"] = max(worst.get("hessian", 0.0),
                                   _rel(got[0][1], got[1][1]))
    return worst


def _series_of(rng, shape, dtype):
    import torch

    return torch.tensor(rng.normal(size=shape).cumsum(-1),
                        dtype=getattr(torch, dtype))


# K1 (d 1, 2, 3, 6) and K1w (7, 8, 9, 13, 16) with a series a group of
# systems: (d, systems, series, T, masked); 6 systems of 3 series (two a
# series), 5 of one shared series, 33 of 33 (a partial block of K1w's
# units), 34 of 17; T across K1w's warps and one step; then K1w over
# several blocks with a ragged last one (17 points a chain of 7 chains, on
# a series a chain and on one), T across the thread kernel's chunks of 8
# steps
LOGLIK_CASES = [(d, b, s, t_len, masked) for d in (1, 2, 3, 6, 7, 8, 9, 13, 16)
                for b, s, t_len, masked in ((6, 3, 33, False), (5, 1, 20, True),
                                            (33, 33, 9, True), (34, 17, 2, False),
                                            (3, 3, 1, False))]
LOGLIK_CASES += [(d, 17 * 7, s, 20, s > 1) for d in (7, 8, 13, 16)
                 for s in (7, 1)]


def check_loglik(seed=0, cases=LOGLIK_CASES, dtypes=("float64", "float32")):
    """K1 and K1w with their innovations against ``kalman.kalman_loglik(...,
    innovations=True)``: {case: worst normwise relative error of ll, v, f}.
    """
    import torch

    from boom_tpu_torch.kernels.kalman_timing import system
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    rng = np.random.default_rng(seed)
    out = {}
    for dtype in dtypes:
        for d, b, s, t_len, masked in cases:
            params = system(rng, b, d, dtype, device="cpu")
            y = _series_of(rng, (s, t_len), dtype)
            obs = (torch.tensor(rng.uniform(size=t_len) > 0.3) if masked
                   else None)
            got = kk.launch_loglik(params.h, params.rqr, params.z,
                                   params.t_mat, params.a0, params.p0, y,
                                   obs, innovations=True)
            want = kalman.kalman_loglik(params, y, obs, innovations=True)
            alone = kk.launch_loglik(params.h, params.rqr, params.z,
                                     params.t_mat, params.a0, params.p0, y,
                                     obs)
            assert torch.equal(alone, got[0]), "the innovations changed ll"
            out[f"loglik {dtype} d={d} B={b} S={s} T={t_len} "
                f"masked={masked}"] = max(_rel(a, w)
                                          for a, w in zip(got, want))
    return out


def skewed(params, rng):
    """The systems with T made non-symmetric (``system``'s are symmetric):
    T -> M T M^-1, M = I + a random strictly upper triangle, the spectrum
    and so the stability kept."""
    import torch

    d = params.z.shape[1]
    m = np.eye(d) + np.triu(rng.normal(scale=0.4, size=(d, d)), 1)
    m = torch.tensor(m, dtype=params.t_mat.dtype)
    return params._replace(t_mat=(m @ params.t_mat @ torch.linalg.inv(m))
                           .contiguous())


# K1w with T and z one of every system (expanded, as Bsts builds them) and
# the same materialised: (d, systems, series, T, masked)
LOGLIK_SHARED_CASES = [(7, 17 * 7, 7, 20, True), (8, 17 * 7, 7, 20, False),
                       (8, 70, 1, 33, True), (13, 17 * 7, 7, 20, True),
                       (16, 40, 4, 17, False)]


def check_loglik_shared(seed=0, cases=LOGLIK_SHARED_CASES,
                        dtypes=("float64", "float32")):
    """K1w on non-symmetric systems (:func:`skewed`) against the plain
    filter: a T a system, and T and z shared, expanded over the systems
    and materialised, which must give the same bits: {case: (worst normwise
    relative error of ll, v, f, whether expanded and materialised agree
    bit for bit)}."""
    import torch

    from boom_tpu_torch.kernels.kalman_timing import system
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    rng = np.random.default_rng(seed)
    out = {}
    for dtype in dtypes:
        for d, b, s, t_len, masked in cases:
            own = skewed(system(rng, b, d, dtype, device="cpu"), rng)
            one = own._replace(t_mat=own.t_mat[:1].expand(b, d, d),
                               z=own.z[:1].expand(b, d))
            flat = one._replace(t_mat=one.t_mat.contiguous(),
                                z=one.z.contiguous())
            y = _series_of(rng, (s, t_len), dtype)
            obs = (torch.tensor(rng.uniform(size=t_len) > 0.3) if masked
                   else None)
            got = {}
            for name, params in (("own", own), ("expanded", one),
                                 ("flat", flat)):
                got[name] = kk.launch_loglik(
                    params.h, params.rqr, params.z, params.t_mat, params.a0,
                    params.p0, y, obs, innovations=True)
            err = 0.0
            for name, params in (("own", own), ("flat", flat)):
                want = kalman.kalman_loglik(params, y, obs, innovations=True)
                err = max(err, *(_rel(a, w) for a, w in zip(got[name],
                                                              want)))
            same = all(torch.equal(a, w) for a, w in zip(got["expanded"],
                                                          got["flat"]))
            out[f"loglik shared {dtype} d={d} B={b} S={s} T={t_len} "
                f"masked={masked}"] = (err, same)
    return out


def directions(rng, k, d):
    """K random directions of (h, R Q R'): dh [K] >= 0, dm [K, d, d]
    symmetric positive semi-definite (float64 tensors)."""
    import torch

    a = rng.normal(size=(k, d, 2)) / np.sqrt(d)
    return (torch.tensor(rng.uniform(0.0, 1.0, size=k)),
            torch.tensor(a @ a.transpose(0, 2, 1)))


# J1 and J2: (d, K, systems, series, masked[, T]) at d 1-16, K 1 to the
# most, T 25 where not given. Then d = 2 and 3 (one and two rounds of
# phase 2's jobs) at K 3 and 16; the paths' shapes (d 2 and 8, K 3, one
# series, T 500); T about the kernel's chunks of 32 steps of y (31, 32,
# 33, 65); K 1 and 16 over several systems on one series and on a series
# a system, masked
JET_CASES = [(1, 1, 2, 1, False), (1, 16, 1, 1, True), (2, 4, 5, 5, True),
             (3, 7, 3, 1, False), (6, 3, 4, 2, True), (8, 3, 2, 2, False),
             (8, 16, 1, 1, False), (13, 2, 3, 3, True), (16, 4, 1, 1, True),
             (2, 3, 3, 1, True, 40), (3, 3, 3, 1, True, 40),
             (2, 16, 2, 2, True, 40), (3, 16, 2, 2, True, 40),
             (2, 3, 1, 1, False, 500), (8, 3, 1, 1, False, 500),
             (4, 1, 5, 1, True, 31), (5, 1, 3, 3, True, 32),
             (8, 16, 2, 1, True, 33), (16, 16, 2, 2, True, 65)]


def check_jets(seed=0, cases=JET_CASES, t_len=25):
    """J1 and J2 along K directions against ``kalman.loglik_jets`` (autograd
    of the plain loop): {case: (worst normwise relative error of ll, grad
    and hess; a second launch bit-identical)}."""
    import torch

    from boom_tpu_torch.kernels.kalman_timing import system
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    rng = np.random.default_rng(seed)
    out = {}
    for d, k, b, s, masked, *rest in cases:
        t = rest[0] if rest else t_len
        params = system(rng, b, d, "float64", device="cpu")
        dh, dm = directions(rng, k, d)
        y = _series_of(rng, (s, t), "float64")
        obs = torch.tensor(rng.uniform(size=t) > 0.3) if masked else None
        fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
                  params.a0, params.p0, y, obs, dh, dm)
        for order in (1, 2):
            got = kk.launch_jets(*fields, order=order)
            again = kk.launch_jets(*fields, order=order)
            want = kalman.loglik_jets(*fields, order)
            out[f"{kk.JET_KINDS[order]} d={d} K={k} B={b} S={s} "
                f"masked={masked} T={t}"] = (
                max(_rel(a, w) for a, w in zip(got, want)),
                all(torch.equal(a, c) for a, c in zip(got, again)))
    return out


# K2w: d 7 and 8 (four chains a warp), 9, 13 and 16 (two); 1, 3 and 5
# chains (a partial pack and a partial warp) and 33 (a partial block); T one
# below, at and above 32 (edges of the passes' chunks of 2-16 steps) and
# one step; masked, dense and a series a chain
WIDE_CASES = [(d, c, t_len, masked, per_chain) for d in (7, 8, 9, 13, 16)
              for c, t_len, masked, per_chain in (
                  (5, 31, False, False), (33, 32, True, False),
                  (5, 33, False, True), (3, 1, False, False),
                  (1, 33, True, True), (3, 32, False, True),
                  (33, 33, True, True))]
# K3: d 1 (32 series a warp), 2, 3 (8 and 4 lanes a series), 8, 13 and 16
# (two series a warp); G 1 to 3 of 5 chains and G = 2 of 7 (series counts
# that leave a warp's last pack ragged, and whole warps past the batch);
# T = 70 crosses the edges of either chunk length
DPATH_CASES = [(d, g, dtype, c) for d in (1, 2, 3, 8, 13, 16)
               for g, c in ((1, 5), (2, 5), (2, 7), (3, 5))
               for dtype in ("float64", "float32")]
DPATH_T = 70


def check_wide(seed=0, wide_cases=WIDE_CASES, dpath_cases=DPATH_CASES):
    """K2w and K3 against their plain versions: {case: normwise relative
    error}."""
    import torch

    from boom_tpu_torch.kernels.kalman_timing import system
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    rng = np.random.default_rng(seed)
    out = {}
    for d, c, t_len, masked, per_chain in wide_cases:
        params = system(rng, c, d, "float64", device="cpu")
        shape = (c, t_len) if per_chain else (t_len,)
        y = torch.tensor(rng.normal(size=shape).cumsum(-1))
        obs = (torch.tensor(rng.uniform(size=t_len) > 0.3) if masked
               else None)
        nz = [torch.tensor(rng.normal(size=s))
              for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
        out[f"smoother_wide d={d} C={c} T={t_len} masked={masked} "
            f"per_chain={per_chain}"] = _rel(
            kk.simulation_smoother(params, y, *nz, observed=obs),
            kalman.simulation_smoother(params, y, *nz, observed=obs))
    for d, g, dtype, c in dpath_cases:
        tdt = getattr(torch, dtype)
        t_mat = torch.tensor(rng.normal(size=(c, d, d)) / np.sqrt(d),
                             dtype=tdt)
        w = torch.tensor(rng.normal(size=(c, g, DPATH_T - 1, d)), dtype=tdt)
        out[f"dpath d={d} G={g} C={c} {dtype}"] = _rel(
            kk.dpath(t_mat, w), kalman.dpath(t_mat, w))
    return out


# the time-varying forms of K1 (d 1, 2, 3, 6), K1w (7, 8, 13, 16), K2 and
# K2w: (d, systems, series, T, masked, q_scale) with q_scale one a system,
# one for all or none; K1w over two blocks of 8 units at d 8 (17 systems)
TV_CASES = [(d, b, s, t_len, masked, q_mode)
            for d in (1, 2, 3, 6, 7, 8, 13, 16)
            for b, s, t_len, masked, q_mode in (
                (5, 1, 33, True, "chain"), (6, 3, 20, False, "shared"),
                (3, 3, 9, True, None), (2, 1, 1, False, "chain"))]
TV_CASES += [(8, 17, 17, 34, True, "chain"), (2, 33, 33, 40, True, "chain")]


def check_time_varying(seed=0, cases=TV_CASES,
                       dtypes=("float64", "float32"), t_kind="chain",
                       smoother=True):
    """K1, K1w (with their innovations), K2 and K2w of a time-varying
    system (``kalman_timing.time_varying_system``, its T of ``t_kind``:
    a T a system, the dense forms of K1w and K2w, or one for all, their
    structured forms) against the plain versions: {case: worst normwise
    relative error}; the smoothers (unless not ``smoother``) in float64
    only, on a series a chain where there are as many series as
    systems."""
    import torch

    from boom_tpu_torch.kernels.kalman_timing import time_varying_system
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    rng = np.random.default_rng(seed)
    out = {}
    for dtype in dtypes:
        for d, b, s, t_len, masked, q_mode in cases:
            params = time_varying_system(rng, b, d, t_len, dtype, q_mode,
                                         device="cpu", t_kind=t_kind)
            y = _series_of(rng, (s, t_len) if s > 1 else (t_len,), dtype)
            obs = (torch.tensor(rng.uniform(size=t_len) > 0.3) if masked
                   else None)
            name = (f"d={d} B={b} S={s} T={t_len} masked={masked} "
                    f"q={q_mode} T's kind {t_kind}")
            got = kk.launch_loglik_tv(params, y, obs, innovations=True)
            want = kalman.kalman_loglik(params, y, obs, innovations=True)
            out[f"loglik_tv {dtype} {name}"] = max(
                _rel(a, w) for a, w in zip(got, want))
            if not smoother or dtype != "float64" or (s != 1 and s != b):
                continue
            q = params.q_mat.shape[-1]
            nz = [torch.tensor(rng.normal(size=shape))
                  for shape in ((b, d), (b, t_len - 1, q), (b, t_len))]
            out[f"smoother_tv {name}"] = _rel(
                kk.simulation_smoother(params, y, *nz, observed=obs),
                kalman.simulation_smoother(params, y, *nz, observed=obs))
    return out


# the calendar's T_t in K1w's and K2w's time-varying forms: (d, systems,
# T, T_t's kind: kalman_timing.CALENDAR_KINDS, masked); T across K2w's
# chunks and K1w's 32 steps, a month boundary at step 0 and at T - 2
CALENDAR_CASES = [(d, b, t_len, kind, (i + j) % 2 == 0)
                  for i, d in enumerate((11, 13, 14, 16))
                  for j, (b, t_len) in enumerate(((3, 31), (5, 33),
                                                  (3, 67), (9, 32)))
                  for kind in ("calendar", "calendar_shared")]


def check_calendar(seed=0, cases=CALENDAR_CASES,
                   dtypes=("float64", "float32")):
    """K1w's (with and without the innovations) and K2w's time-varying
    forms with the calendar's T_t (``kalman_timing.calendar_system``)
    against the plain versions: {case: worst normwise relative error};
    K2w in float64 only; each launch taking its calendar key."""
    import torch

    from boom_tpu_torch.kernels.kalman_timing import calendar_system
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    rng = np.random.default_rng(seed)
    out = {}
    for dtype in dtypes:
        for d, b, t_len, kind, masked in cases:
            params = calendar_system(rng, b, d, t_len, dtype, kind,
                                     device="cpu")
            y = _series_of(rng, (t_len,), dtype)
            obs = (torch.tensor(rng.uniform(size=t_len) > 0.3) if masked
                   else None)
            name = f"d={d} B={b} T={t_len} {kind} masked={masked}"
            before = kk.LAUNCHES["loglik_wide_tv_calendar"]
            got = kk.launch_loglik_tv(params, y, obs, innovations=True)
            ll = kk.launch_loglik_tv(params, y, obs)
            want = kalman.kalman_loglik(params, y, obs, innovations=True)
            assert kk.LAUNCHES["loglik_wide_tv_calendar"] == before + 2
            out[f"loglik calendar {dtype} {name}"] = max(
                [_rel(a, w) for a, w in zip(got, want)]
                + [_rel(ll, want[0])])
            if dtype != "float64":
                continue
            q = params.q_mat.shape[-1]
            nz = [torch.tensor(rng.normal(size=shape))
                  for shape in ((b, d), (b, t_len - 1, q), (b, t_len))]
            before = kk.LAUNCHES["smoother_wide_tv_calendar"]
            draw = kk.simulation_smoother(params, y, *nz, observed=obs)
            assert kk.LAUNCHES["smoother_wide_tv_calendar"] == before + 1
            out[f"smoother calendar {name}"] = _rel(
                draw, kalman.simulation_smoother(params, y, *nz,
                                                 observed=obs))
    return out


def set_occupancy(lib, blocks):
    """The resident blocks an SM the host library's occupancy query
    reports: 0 makes K3's launcher take its short chunks, as on a card
    whose SMs its grid fills."""
    import ctypes

    ctypes.CDLL(str(lib)).boom_host_set_occupancy(blocks)


def check_ssvs_border(seed=0, cases=((20, "float64"), (33, "float64")),
                      chains=33, draws=2):
    """Kernel (a)'s per-chain entry against the plain sweep on per-chain
    statistics (``ssvs_timing.problem_per_chain``): {case: chains whose
    masks differ}."""
    from boom_tpu_torch.kernels.ssvs_timing import problem_per_chain
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    rng = np.random.default_rng(seed)
    out = {}
    for p, dtype in cases:
        bad = 0
        for _ in range(draws):
            suf, prior, mask, noise = problem_per_chain(rng, chains, p, dtype,
                                                        device="cpu")
            want = rs.draw_indicators_swept(noise, suf, prior, mask)
            got = sk.draw_indicators_swept(noise, suf, prior, mask)
            bad += int((got != want).any(-1).sum())
        out[f"border p={p} {dtype}"] = bad
    return out


SSVS_CASES = [(p, jump, max_size, dtype) for dtype in ("float64", "float32")
              for p in (1, 31, 32, 33, 37) for jump in (False, True)
              for max_size in (None, 3)]


def check_ssvs(seed=0, chains=33, draws=3):
    """Kernel (a) against the plain sweep on the same noise, over
    SSVS_CASES and ``draws`` noise draws: {case: chains whose masks
    differ}."""
    from boom_tpu_torch.kernels.ssvs_timing import problem
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    rng = np.random.default_rng(seed)
    out = {}
    for p, jump, max_size, dtype in SSVS_CASES:
        bad = 0
        for _ in range(draws):
            model, mask, noise, qprobs = problem(
                rng, chains, p, dtype, max_size=max_size, mode_jump=jump,
                device="cpu")
            want = rs.draw_indicators_swept(noise, model.suf, model.prior,
                                            mask, qprobs=qprobs)
            got = sk.draw_indicators_swept(noise, model.suf, model.prior,
                                           mask, qprobs=qprobs)
            bad += int((got != want).any(-1).sum())
        out[f"p={p} jump={jump} max_size={max_size} {dtype}"] = bad
    return out


# H1 and H2: (S, T, chains, lanes a chain: None for the kernels' choice,
# 32 at these chains where S allows the split, else 1; 8 forced); T across the
# split's edges (T < L, a multiple of L and one either side), across the
# staged chunks' edges (256 bytes a lane's row, 128 for H2 with L > 1: 16
# steps of S = 2 in float32, 8 in float64) and a second, ragged warp of
# chains
HMM_CASES = [(s, t_len, c, None) for s in (1, 2, 3, 8, 16)
             for t_len in (1, 2, 31, 32, 33, 150) for c in (1, 33)]
HMM_CASES += [(s, t_len, 5, 8) for s in (2, 3)
              for t_len in (7, 8, 9, 15, 16, 17, 33, 65)]
HMM_CASES += [(s, t_len, 9, 8) for s in (1, 7, 8) for t_len in (3, 17, 67)]
HMM_CASES += [(3, t_len, 5, None) for t_len in (10, 11, 21)]
HMM_CASES += [(16, t_len, 5, None) for t_len in (1, 2, 3)]
# H2 keeps a lane's maps in shared memory where they fit; at S = 8 and T =
# 6,000 (188 steps a lane) they do not, and go through z
HMM_CASES += [(8, 6000, 1, None)]


def check_hmm(seed=0, cases=HMM_CASES, dtypes=("float64", "float32"),
              deep=False):
    """H1 and H2 against ``hmm.forward_filter`` and
    ``hmm.backward_sample_stats``: {case: (H1's normwise relative error,
    the share of chains whose H2 path differs, H2's statistics' worst
    relative error against ``hmm.path_stats`` of its own path)}; H1 without
    its alphas must give the same loglike, and a second launch of each the
    same bits. ``deep``: problems whose odd states' log alphas fall below
    -87 (``hmm_timing.problem``)."""
    import contextlib

    import torch

    from boom_tpu_torch.kernels.hmm_timing import problem
    from boom_tpu_torch.models import hmm
    from boom_tpu_torch.models import hmm_kernel as hk

    rng = np.random.default_rng(seed)
    out = {}
    for dtype in dtypes:
        for s, t_len, c, lanes in cases:
            p = problem(rng, c, t_len, s, dtype, device="cpu", deep=deep)
            args = (p["log_lik"], p["log_trans"], p["log_init"])
            want_la, want_ll = hmm.forward_filter(*args)
            if deep:
                assert float(want_la.min()) < -87.0, "not deep"
            with (hk.forced_lanes(lanes) if lanes
                  else contextlib.nullcontext()):
                la, ll = hk.launch_forward(*args)
                _, alone = hk.launch_forward(*args, want_alphas=False)
                z, suf, counts, first = hk.launch_backward(
                    want_la, p["log_trans"], p["path_u"], p["y"])
                again = hk.launch_backward(want_la, p["log_trans"],
                                           p["path_u"], p["y"])
                used = {name: hk.lanes(name, la.dtype, s, c)
                        for name in ("hmm_forward", "hmm_backward")}
            assert torch.equal(alone, ll), "H1 without alphas differs"
            assert torch.equal(again[0], z) and all(
                torch.equal(a, b) for a, b in zip(
                    (*again[1], *again[2:]), (*suf, counts, first))), (
                "H2 differs between two launches")
            want_z = hmm.backward_sample(want_la, p["log_trans"],
                                         p["path_u"])
            own_suf, own_counts, own_first = hmm.path_stats(
                z, p["y"].double(), s)
            stats = max(_rel(g.double(), w) for g, w in zip(
                (*suf, counts, first), (*own_suf, own_counts, own_first)))
            name = (f"hmm {dtype} S={s} T={t_len} C={c} "
                    f"L={used['hmm_forward']}/{used['hmm_backward']}"
                    + (" deep" if deep else ""))
            out[name] = (
                max(_rel(la.double(), want_la.double()),
                    _rel(ll.double(), want_ll.double())),
                float((z != want_z).any(-1).double().mean()), stats)
    return out


def rehearse_llt(chains=32, burn=100, draws=200, t_len=500, seed=0):
    """The bsts_llt path (chip_smoke.py phase 4's model and monitor) on the
    CPU: {statistic: (R-hat, ESS)} and the variances' medians."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference import diagnostics
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.statespace.bsts import Bsts
    from boom_tpu_torch.statespace.state_models import LocalLinearTrend

    y = torch.tensor(data.bsts_llt_series()[:t_len])
    model = Bsts(y=y, blocks=[LocalLinearTrend.default(y)],
                 marginal_sigma_slice=True, marginal_move="tim")

    def extract(s):
        a, tr = s["alpha"], s["blocks"]["trend"]
        return {"so": s["sigsq_obs"], "lvl": tr["sigma_level_sq"],
                "slp": tr["sigma_slope_sq"], "mid": a[:, t_len // 2, 0],
                "fcast": a[:, -1, 0] + a[:, -1, 1]}

    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   draws, generator=prng.generator(seed, "cpu"),
                   num_chains=chains, burn=burn, extract=extract)
    d = res.draws
    mon = torch.stack([d["so"], torch.sqrt(d["lvl"]), torch.sqrt(d["slp"]),
                       d["mid"], d["fcast"]], dim=-1).double()
    rhat = diagnostics.potential_scale_reduction(mon).tolist()
    ess = diagnostics.effective_sample_size(mon).tolist()
    med = {k: float(d[k].double().median()) for k in ("so", "lvl", "slp")}
    return dict(zip(("so", "lvl", "slp", "mid", "fcast"),
                    zip(rhat, ess))), med


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--llt", action="store_true",
                    help="also run the bsts_llt path for 32 chains")
    args = ap.parse_args()
    torch.set_num_threads(4)
    libs = {name: build_host_library(name)
            for name in ("kalman_seq", "kalman_wide", "ssvs_sweep", "hmm")}
    bind(libs)
    for k, (rel, paths, stats) in check_hmm().items():
        print(f"host-compiled {k}: H1 relative error {rel:.3e}, H2 paths "
              f"differing {paths:.3f}, statistics {stats:.3e}")
    for k, v in check_kernels().items():
        print(f"host-compiled {k}: worst relative error {v:.3e}")
    for k, v in check_loglik().items():
        print(f"host-compiled {k}: relative error {v:.3e}")
    for k, (v, same) in check_jets().items():
        print(f"host-compiled {k}: relative error {v:.3e}, a second launch "
              f"bit-identical {same}")
    for k, v in check_wide().items():
        print(f"host-compiled {k}: relative error {v:.3e}")
    for k, v in check_time_varying().items():
        print(f"host-compiled {k}: relative error {v:.3e}")
    # K2w's structured form: one T for all chains, of each kind
    from boom_tpu_torch.kernels.kalman_timing import T_KINDS

    for t_kind in T_KINDS[1:]:
        for k, v in check_time_varying(
                cases=[c for c in TV_CASES if c[0] >= 7],
                dtypes=("float64",), t_kind=t_kind).items():
            print(f"host-compiled {k}: relative error {v:.3e}")
    set_occupancy(libs["kalman_wide"], 0)
    for k, v in check_wide(wide_cases=[]).items():
        print(f"host-compiled {k} (short chunks): relative error {v:.3e}")
    set_occupancy(libs["kalman_wide"], 1)
    for k, v in check_ssvs().items():
        print(f"host-compiled ssvs_sweep {k}: {v} chains differ")
    for k, v in check_ssvs_border().items():
        print(f"host-compiled ssvs_sweep {k}: {v} chains differ")
    if args.llt:
        stats, med = rehearse_llt()
        for k, (r, e) in stats.items():
            print(f"host bsts_llt {k}: rhat {r:.4f} ess {e:.1f}")
        print("host bsts_llt medians:", med)


if __name__ == "__main__":
    main()

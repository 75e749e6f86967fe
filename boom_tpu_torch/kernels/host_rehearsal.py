"""Rehearse the sequential Kalman kernels (K1, K2, J1, J2; K2w and K3) and
kernel (a) on a machine without a card.

    python3 boom_tpu_torch/kernels/host_rehearsal.py          # kernels
    python3 boom_tpu_torch/kernels/host_rehearsal.py --llt    # + bsts_llt

``csrc/kalman_seq.cu``, ``csrc/kalman_wide.cu`` and ``csrc/ssvs_sweep.cu``
are compiled as host C++ with ``g++``: a shim header defines the CUDA keywords away and gives
``blockIdx``/``blockDim``/``threadIdx`` as thread-local globals, and every
``kernel<<<blocks, threads, ...>>>(args)`` becomes ``host_launch``, which
runs a block's threads as host threads, one block after another. Its
barriers are real: one for the block (``__syncthreads``), one for each
warp of 32 (``__syncwarp``, and ``__shfl_sync`` and ``__ballot_sync``,
which exchange values through the warp's slots between two of its
barriers). A thread that waits at a barrier longer than a deadline (60 s,
``boom_host_set_deadline``) ends the launch: every thread of the block
leaves at its next barrier and the launch returns
``cudaErrorLaunchTimeout`` (702), which the wrappers raise, so that a
barrier that is never met fails a check instead of hanging it. The
library is bound in place of the ``nvcc`` build, so ``kalman_kernel``'s
wrappers run the kernels' own arithmetic on CPU tensors, which are checked
against the plain versions (K1 in float64 and float32, K2, J1 and J2, the
derivative kernels, against autograd of the plain loop), and kernel (a),
the SSVS indicator sweep, against ``regression_sweep.draw_indicators_swept``
(33 chains, p in {1, 31, 32, 33, 37}, mode jump off and on, max_size
unset and set, float64 and float32: masks identical), K2w and K3 against
``kalman.simulation_smoother`` and ``kalman.dpath`` (:func:`check_wide`)
and kernel (a)'s per-chain entry against the plain sweep on per-chain
statistics (:func:`check_ssvs_border`). ``--llt`` then
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
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
typedef void* cudaStream_t;
enum cudaError_t {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorLaunchTimeout = 702  // a barrier was not met by its deadline
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
struct cudaFuncAttributes { int maxThreadsPerBlock; };
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
struct HostDim3 { int x, y, z; };
static thread_local HostDim3 blockIdx, blockDim, threadIdx;

// Seconds a thread waits at a barrier before the launch gives up: then
// every thread of the block leaves at its next barrier and the launch
// returns cudaErrorLaunchTimeout, so that a barrier that is never met
// fails a check instead of hanging it.
static double host_deadline_s = 60.0;
extern "C" void boom_host_set_deadline(double seconds) {
  host_deadline_s = seconds;
}
struct HostAbort {};
static std::atomic<bool> host_aborted{false};

class HostBarrier {
 public:
  explicit HostBarrier(int n) : n_(n) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mu_);
    if (host_aborted) throw HostAbort{};
    const long gen = gen_;
    if (++count_ == n_) {
      count_ = 0;
      ++gen_;
      cv_.notify_all();
      return;
    }
    const auto until = std::chrono::steady_clock::now() +
                       std::chrono::duration<double>(host_deadline_s);
    while (gen_ == gen) {
      if (host_aborted) throw HostAbort{};
      if (cv_.wait_until(lock, until) == std::cv_status::timeout &&
          gen_ == gen) {
        host_aborted = true;
        throw HostAbort{};
      }
    }
  }
  void wake() {
    std::lock_guard<std::mutex> lock(mu_);
    cv_.notify_all();
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  int n_, count_ = 0;
  long gen_ = 0;
};

// A warp's barrier and its exchange slots (__shfl_sync, __ballot_sync).
struct HostWarp {
  explicit HostWarp(int lanes) : bar(lanes) {}
  HostBarrier bar;
  unsigned long long slot[32];
};
static HostBarrier* host_block_bar;
static thread_local HostWarp* host_warp;

inline void __syncthreads() { host_block_bar->wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { host_warp->bar.wait(); }
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  static_assert(sizeof(T) <= sizeof(unsigned long long), "shfl");
  std::memcpy(&host_warp->slot[threadIdx.x & 31], &v, sizeof(T));
  host_warp->bar.wait();
  T out;
  std::memcpy(&out, &host_warp->slot[src & 31], sizeof(T));
  host_warp->bar.wait();
  return out;
}
inline unsigned __ballot_sync(unsigned, int pred) {
  host_warp->slot[threadIdx.x & 31] = pred != 0;
  host_warp->bar.wait();
  unsigned bits = 0;
  for (int l = 0; l < 32 && (threadIdx.x & ~31) + l < blockDim.x; ++l)
    bits |= static_cast<unsigned>(host_warp->slot[l]) << l;
  host_warp->bar.wait();
  return bits;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __threadfence_block() {}
inline float __frcp_rn(float x) { return 1.0f / x; }
inline double __drcp_rn(double x) { return 1.0 / x; }
inline float __logf(float x) { return std::log(x); }
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
// a block's threads run as host threads, with a real barrier for the
// block and one for each warp of 32; blocks run one after another and
// share host_shared; a barrier past its deadline ends the launch
template <class Body>
void host_launch(int blocks, int threads, Body body) {
  host_aborted = false;
  HostBarrier block(threads);
  std::vector<std::unique_ptr<HostWarp>> warps;
  for (int w = 0; w * 32 < threads; ++w)
    warps.emplace_back(new HostWarp(std::min(32, threads - w * 32)));
  host_block_bar = &block;
  auto wake_all = [&] {
    block.wake();
    for (auto& w : warps) w->bar.wake();
  };
  for (int b = 0; b < blocks && !host_aborted; ++b) {
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, b, t] {
        blockIdx = {b, 0, 0};
        blockDim = {threads, 1, 1};
        threadIdx = {t, 0, 0};
        host_warp = warps[t / 32].get();
        try {
          body();
        } catch (const HostAbort&) {
          wake_all();
        }
      });
    for (auto& th : pool) th.join();
  }
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
    """Make kalman_kernel and ssvs_kernel launch the host libraries
    ({source name: library}) on CPU tensors."""
    from boom_tpu_torch.models.glm import ssvs_kernel as sk
    from boom_tpu_torch.statespace import kalman_kernel as kk

    _build.build = lambda names=None: {n: libs[n] for n in names}
    _build.library.cache_clear()
    for mod in (kk, sk):
        mod._on_card = lambda x: True
        mod._stream = lambda device: 0


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def check_kernels(seed=0):
    """K1, K2, J1 and J2 against the plain versions, and the gradient and
    Hessian that autograd reaches through J1 and J2 against autograd of the
    plain loop: returns the worst normwise relative error of each."""
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
            # J1 and J2 against their plain version, 5 series (a second
            # block of warps, partly empty)
            params = system(rng, 5, d, "float64", device="cpu")
            y = torch.tensor(rng.normal(size=60).cumsum())
            obs = torch.tensor(rng.uniform(size=60) > 0.3) if masked else None
            fields = (params.h, params.rqr.contiguous(), params.z,
                      params.t_mat, params.a0, params.p0, y, obs)
            for order, kind in ((1, "loglik_grad"), (2, "loglik_hess")):
                got = kk.launch_loglik(*fields, order=order)
                want = kk.loglik_jets_plain(*fields, order=order)
                worst[kind] = max([worst.get(kind, 0.0)] + [
                    _rel(a, b) for a, b in zip(got, want)])
            # and through autograd: the gradient (J1) and the Hessian (J2)
            # in the log variances, as the TIM mode search asks for them
            one = system(rng, 1, d, "float64", device="cpu")

            def f(u, fn, one=one, d=d, y=y, obs=obs):
                return fn(one._replace(
                    q_mat=torch.diag_embed(torch.exp(u[:d]))[None],
                    h=torch.exp(u[d:])), y, obs)[0]

            u0 = torch.linspace(-1.0, 0.3, d + 1, dtype=torch.float64)
            got = []
            for fn in (kk.kalman_loglik, kalman.kalman_loglik):
                u = u0.clone().requires_grad_(True)
                (g,) = torch.autograd.grad(f(u, fn), u)
                got.append((g, torch.autograd.functional.hessian(
                    lambda x, fn=fn: f(x, fn), u0)))
            worst["gradient"] = max(worst.get("gradient", 0.0),
                                    _rel(got[0][0], got[1][0]))
            worst["hessian"] = max(worst.get("hessian", 0.0),
                                   _rel(got[0][1], got[1][1]))
    return worst


# K2w: d at and past K2's widest, T one below, at and above a chunk of 32
# steps and one step, 33 chains (a last block of one warp), masked, dense
# and a series a chain; K3: d 1 (32 groups a pass) to 16 (two), G 1 and 3
WIDE_CASES = [(d, c, t_len, masked, per_chain) for d in (7, 8)
              for c, t_len, masked, per_chain in (
                  (5, 31, False, False), (33, 32, True, False),
                  (5, 33, False, True), (3, 1, False, False))]
DPATH_CASES = [(d, g, dtype) for d, g in ((1, 1), (2, 2), (8, 3), (13, 3),
                                          (16, 1))
               for dtype in ("float64", "float32")]


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
    for d, g, dtype in dpath_cases:
        tdt = getattr(torch, dtype)
        c, t_len = 5, 40
        t_mat = torch.tensor(rng.normal(size=(c, d, d)) / np.sqrt(d),
                             dtype=tdt)
        w = torch.tensor(rng.normal(size=(c, g, t_len - 1, d)), dtype=tdt)
        out[f"dpath d={d} G={g} {dtype}"] = _rel(kk.dpath(t_mat, w),
                                                 kalman.dpath(t_mat, w))
    return out


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
    bind({name: build_host_library(name)
          for name in ("kalman_seq", "kalman_wide", "ssvs_sweep")})
    for k, v in check_kernels().items():
        print(f"host-compiled {k}: worst relative error {v:.3e}")
    for k, v in check_wide().items():
        print(f"host-compiled {k}: relative error {v:.3e}")
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

"""The HMM's forward filter and backward sampler through H1 and H2,
``csrc/hmm.cu``: one launch filters every chain's T steps (H1), one draws
every chain's path and its statistics (H2), L lanes a chain, each walking
one segment of the T steps (L chosen at launch from C and S:
:func:`lanes`).

The reference runs them as XLA ``lax.scan``s (boom_tpu/models/hmm.py:52,
:72); in eager PyTorch each step would be several small launches, ~7,000 a
sweep at T = 1,200.

Dispatch is by the device of the log likelihoods (the alphas for H2), as in
``statespace/kalman_kernel.py``: a CUDA tensor launches the kernel (or
raises; there is no fallback), a CPU tensor runs the plain version in
``models/hmm.py``. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import contextlib

import torch

from boom_tpu_torch.kernels import _build
from boom_tpu_torch.models import hmm
from boom_tpu_torch.models.conjugate import GaussianSuf
from boom_tpu_torch.statespace.scan_kernel import _on_card

# kernel launches since the process started (or a caller's reset)
LAUNCHES = {"hmm_forward": 0, "hmm_backward": 0}
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
MAX_STATES = max(_build.HMM_STATES)
_TOO_MANY = ("H1 and H2 hold a chain's alphas in registers, S <= {max} "
             "(S = {s}); more states are not ported yet (ROADMAP.md, queue 1 "
             "item 8)")


def lanes(name, dtype, s, chains) -> int:
    """The lanes a chain that H1 (``name`` "hmm_forward") or H2
    ("hmm_backward") takes at this dtype, S and C."""
    return int(_build.library("hmm").boom_hmm_lanes(
        int(name == "hmm_backward"), int(dtype == torch.float64), s, chains))


@contextlib.contextmanager
def forced_lanes(n):
    """Launches inside take 32 lanes a chain for n >= 32, else 8, in place
    of the choice from C (1 where S is past the split layout's)."""
    lib = _build.library("hmm")
    before = lib.boom_hmm_set_lanes(n)
    try:
        yield
    finally:
        lib.boom_hmm_set_lanes(before)


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check(name, x, shape, dtype, device):
    if tuple(x.shape) != tuple(shape) or x.dtype != dtype or (
            x.device != device):
        raise ValueError(f"{name} must be {tuple(shape)} {dtype} on {device}; "
                         f"got {tuple(x.shape)} {x.dtype} on {x.device}")
    return x.contiguous()


def _states(s):
    if not 1 <= s <= MAX_STATES:
        raise NotImplementedError(_TOO_MANY.format(max=MAX_STATES, s=s))


def forward_filter(log_lik, log_trans, log_init, want_alphas=True):
    """(log_alphas [C, T, S] or None without ``want_alphas``, loglike [C]):
    H1 on a CUDA tensor, ``hmm.forward_filter`` on a CPU tensor."""
    if not _on_card(log_lik):
        return hmm.forward_filter(log_lik, log_trans, log_init, want_alphas)
    return launch_forward(log_lik, log_trans, log_init, want_alphas)


def launch_forward(log_lik, log_trans, log_init, want_alphas=True):
    """H1: log_lik [C, T, S], log_trans [C, S, S], log_init [C, S]."""
    c, t_len, s = log_lik.shape
    _states(s)
    dtype, device = log_lik.dtype, log_lik.device
    if dtype not in _DTYPE_TAG:
        raise TypeError(f"H1 runs float32 or float64, not {dtype}")
    log_lik = _check("log_lik", log_lik, (c, t_len, s), dtype, device)
    log_trans = _check("log_trans", log_trans, (c, s, s), dtype, device)
    log_init = _check("log_init", log_init, (c, s), dtype, device)
    alphas = (torch.empty((c, t_len, s), dtype=dtype, device=device)
              if want_alphas else None)
    loglike = torch.empty(c, dtype=dtype, device=device)
    fn = getattr(_build.library("hmm"),
                 f"boom_hmm_forward_{_DTYPE_TAG[dtype]}")
    rc = fn(log_lik.data_ptr(), log_trans.data_ptr(), log_init.data_ptr(),
            0 if alphas is None else alphas.data_ptr(), loglike.data_ptr(),
            c, t_len, s, _stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA hmm_forward launch failed: cudaError {rc}")
    LAUNCHES["hmm_forward"] += 1
    return alphas, loglike


def backward_sample_stats(log_alphas, log_trans, path_u, y):
    """(z [C, T] int32, GaussianSuf [C, S] of y [T] by state, transition
    counts [C, S, S], the first state's one-hot [C, S]): H2 on a CUDA
    tensor, ``hmm.backward_sample_stats`` on a CPU tensor."""
    if not _on_card(log_alphas):
        return hmm.backward_sample_stats(log_alphas, log_trans, path_u, y)
    return launch_backward(log_alphas, log_trans, path_u, y)


def launch_backward(log_alphas, log_trans, path_u, y):
    """H2: log_alphas and the Gumbel uniforms path_u [C, T, S], log_trans
    [C, S, S], y [T]."""
    c, t_len, s = log_alphas.shape
    _states(s)
    dtype, device = log_alphas.dtype, log_alphas.device
    if dtype not in _DTYPE_TAG:
        raise TypeError(f"H2 runs float32 or float64, not {dtype}")
    log_alphas = _check("log_alphas", log_alphas, (c, t_len, s), dtype,
                        device)
    log_trans = _check("log_trans", log_trans, (c, s, s), dtype, device)
    path_u = _check("path_u", path_u, (c, t_len, s), dtype, device)
    y = _check("y", y, (t_len,), dtype, device)
    z = torch.empty((c, t_len), dtype=torch.int32, device=device)
    n, total, sumsq, first = (torch.empty((c, s), dtype=dtype, device=device)
                              for _ in range(4))
    counts = torch.empty((c, s, s), dtype=dtype, device=device)
    fn = getattr(_build.library("hmm"),
                 f"boom_hmm_backward_{_DTYPE_TAG[dtype]}")
    rc = fn(log_alphas.data_ptr(), log_trans.data_ptr(), y.data_ptr(),
            path_u.data_ptr(), z.data_ptr(), n.data_ptr(), total.data_ptr(),
            sumsq.data_ptr(), counts.data_ptr(), first.data_ptr(), c, t_len,
            s, _stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA hmm_backward launch failed: cudaError {rc}")
    LAUNCHES["hmm_backward"] += 1
    return z, GaussianSuf(n=n, sum=total, sumsq=sumsq), counts, first

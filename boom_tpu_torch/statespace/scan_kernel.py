"""Parallel-in-time Kalman scans through the hand-written CUDA kernel —
the counterpart of boom_tpu/statespace/pallas_scan.py.

The reference runs the whole Hillis-Steele scan of the Särkkä &
García-Fernández filter/smoother inside one Pallas TPU kernel
(``_pallas_inclusive_scan``, pallas_scan.py:221) with three combine rules.
Here the same three scans are one CUDA template (``csrc/parallel_scan.cu``)
bound through ``ctypes`` (``kernels/_build.py``); its design note says how
it is laid out for Hopper and what bounds it.

Dispatch is by the device of the tensors: a CUDA tensor launches the
kernel (or raises — there is no fallback), a CPU tensor runs the plain
version in ``parallel_kalman.py``. ``LAUNCHES`` counts kernel scans per
combine (one per call, however many CUDA launches the kernel makes), so a
run can show its main path went through the kernel.

Public functions mirror the reference's: ``filter_moments``
(``pallas_filter_moments`` :265), ``smooth_means`` (:280),
``smooth_states`` (:292), ``simulate`` (:298) and ``simulation_smoother``
(:313), plus ``affine_prefix``, the bare affine scan of ``simulate``
(bsts' ASIS D-paths run the sequential kernel K3 at every d,
``kalman_kernel.dpath``).
"""

from __future__ import annotations

import torch

from boom_tpu_torch.kernels import _build
from boom_tpu_torch.statespace import parallel_kalman as pk
from boom_tpu_torch.statespace.kalman import SsmParams

# kernel scans per combine since the process started (or a caller's
# reset); incremented only where the kernel is launched
LAUNCHES = {"filter": 0, "smooth": 0, "affine": 0}

_F = {"filter": lambda d: 3 * d * d + 2 * d,
      "smooth": lambda d: d * d + d,
      "affine": lambda d: d * d + d}
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version)."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def inclusive_scan(name: str, d: int, stacked: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """Launch the CUDA scan ``name`` on ``stacked``: a contiguous CUDA
    tensor [B, F, T] holding each element's F components (row-major
    matrices, then vectors) along time. Returns the inclusive scan in the
    same layout; ``reverse`` scans from t = T-1 down to 0."""
    if name not in _F:
        raise ValueError(f"unknown scan {name!r}")
    if stacked.device.type != "cuda":
        raise ValueError("inclusive_scan needs a CUDA tensor")
    if stacked.dtype not in _DTYPE_TAG:
        raise TypeError(f"unsupported dtype {stacked.dtype}")
    if d not in _build.SCAN_DIMS:
        raise ValueError(f"state dim {d} outside the kernel's "
                         f"{_build.SCAN_DIMS}")
    if stacked.dim() != 3 or stacked.shape[1] != _F[name](d):
        raise ValueError(f"{name} scan at d={d} takes [B, {_F[name](d)}, T];"
                         f" got {tuple(stacked.shape)}")
    if not stacked.is_contiguous():
        raise ValueError("inclusive_scan needs a contiguous tensor")
    batch, _, t_len = stacked.shape
    if max(batch, t_len) >= 2 ** 31:
        raise ValueError("batch and T must fit in int32")
    out = torch.empty_like(stacked)
    # scratch of the kernel's tile totals (one per batch row and tile)
    totals = stacked.new_empty(
        batch * -(-t_len // _build.SCAN_MIN_TILE) * stacked.shape[1])
    fn = getattr(_build.library("parallel_scan"),
                 f"boom_scan_{name}_{_DTYPE_TAG[stacked.dtype]}_d{d}")
    with torch.cuda.device(stacked.device):
        rc = fn(stacked.data_ptr(), out.data_ptr(), totals.data_ptr(),
                totals.numel(), batch, t_len, int(reverse),
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA {name} scan launch failed: cudaError {rc}")
    # one count per scan, however many CUDA launches the kernel makes
    LAUNCHES[name] += 1
    return out


def _stack(mats, vecs):
    """[B, T, d, d] matrices and [B, T, d] vectors -> [B, F, T]."""
    b, t = vecs[0].shape[:2]
    parts = [m.reshape(b, t, -1) for m in mats] + list(vecs)
    return torch.cat(parts, dim=-1).transpose(1, 2).contiguous()


def filter_moments(params: SsmParams, y):
    """Filtered means [C, T, d] and covariances [C, T, d, d] for all t."""
    if not _on_card(params.z):
        return pk.parallel_filter_moments(params, y)
    el = pk._filter_elements(params, y)
    c, t_len, d = el.b.shape
    out = inclusive_scan("filter", d, _stack((el.a, el.c, el.j),
                                              (el.b, el.eta)))
    fm = out[:, 3 * d * d:3 * d * d + d].transpose(1, 2)
    fp = out[:, d * d:2 * d * d].transpose(1, 2).reshape(c, t_len, d, d)
    return fm, fp


def smooth_means(params: SsmParams, fm, fp):
    """Smoothed means [C, T, d] from filtered moments (reverse scan)."""
    if not _on_card(params.z):
        return pk.parallel_smooth_means(params, fm, fp)
    e_all, g_all = pk._smooth_elements(params, fm, fp)
    d = fm.shape[-1]
    out = inclusive_scan("smooth", d, _stack((e_all,), (g_all,)),
                         reverse=True)
    return out[:, d * d:].transpose(1, 2)


def smooth_states(params: SsmParams, y):
    fm, fp = filter_moments(params, y)
    return smooth_means(params, fm, fp)


def affine_prefix(a_elems, b_elems):
    """x_t = A_t x_{t-1} + b_t from x_{-1} = 0, for all t.
    a_elems [B, T, d, d], b_elems [B, T, d] -> [B, T, d]."""
    if not _on_card(b_elems):
        return pk.affine_scan(a_elems, b_elems)
    d = b_elems.shape[-1]
    out = inclusive_scan("affine", d, _stack((a_elems,), (b_elems,)))
    return out[:, d * d:].transpose(1, 2)


def simulate(params: SsmParams, t_len: int, alpha1_z, eta_z, eps_z):
    """Unconditional (alpha [C, T, d], y [C, T]) draw from the given
    standard normals alpha1_z [C, d], eta_z [C, T-1, q], eps_z [C, T]."""
    a_elems, b_elems = pk._simulate_elements(params, t_len, alpha1_z,
                                             eta_z)
    alphas = affine_prefix(a_elems, b_elems)
    return alphas, pk._observe(params, alphas, eps_z)


def simulation_smoother(params: SsmParams, y, alpha1_z, eta_z, eps_z):
    """Durbin-Koopman simulation smoother at O(log T) depth: three scan
    launches (affine, filter, smooth) for all chains at once."""
    alpha_plus, y_plus = simulate(params, y.shape[-1], alpha1_z, eta_z,
                                  eps_z)
    params0 = params._replace(a0=torch.zeros_like(params.a0))
    return alpha_plus + smooth_states(params0, y - y_plus)

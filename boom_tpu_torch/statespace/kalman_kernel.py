"""Sequential Kalman recurrences through the hand-written CUDA kernels of
``csrc/kalman_seq.cu`` (one thread, or for the derivatives one warp, per
series walking the T steps) and ``csrc/kalman_wide.cu`` (one warp a chain,
a lane a row of the state, for 7 <= d <= 16).

The reference runs these as XLA ``lax.scan``s (boom_tpu/statespace/
kalman.py); in eager PyTorch each step would be a dozen small launches.

- :func:`kalman_loglik` (K1): the [B] marginal log likelihoods of many
  static systems on one series, as ``kalman.kalman_loglik``. It is
  differentiable twice in ``h`` and ``R Q R'`` (hence in the variances)
  through a ``torch.autograd.Function``: a gradient launches J1 (value and
  gradient, a dual number a lane), a second derivative J2 (value,
  gradient and Hessian, a hyper-dual number a lane), so
  ``torch.autograd.grad`` and ``torch.autograd.functional.hessian`` work on
  the card without autograd of a 500-step loop. :func:`loglik_jets_plain`
  is J1's and J2's plain version.
- :func:`simulation_smoother` (K2 for d <= 6, K2w for 7 <= d <= 16): the
  fused Durbin-Koopman simulation smoother, float64, as
  ``kalman.simulation_smoother``; a series a chain ([C, T], bsts with a
  regression: y - X beta) is taken through the observation noise, which
  the smoother uses only in y+ (see :func:`smoother_operands`).
- :func:`dpath` (K3): the ASIS D-path recurrence D_t = T D_{t-1} + w_t of
  every chain's groups, float32 or float64, as ``kalman.dpath``.

Dispatch is by the device of the tensors, as in ``scan_kernel.py``: a CUDA
tensor launches the kernel (or raises — there is no fallback), a CPU tensor
runs the plain version in ``kalman.py``. ``LAUNCHES`` counts kernel
launches, so a run can show its main path went through the kernels.
"""

from __future__ import annotations

import torch

from boom_tpu_torch.kernels import _build
from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace.kalman import SsmParams
from boom_tpu_torch.statespace.scan_kernel import _on_card

# kernel launches since the process started (or a caller's reset);
# incremented only where a kernel is launched
LAUNCHES = {"loglik": 0, "loglik_grad": 0, "loglik_hess": 0, "smoother": 0,
            "smoother_wide": 0, "dpath": 0}
# the loglik's kernel by the order of derivatives it gives: K1, J1, J2
LOGLIK_KINDS = ("loglik", "loglik_grad", "loglik_hess")

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
# block sizes: 0 lets K1 lay its grid out from the card (one block of
# ceil(B / SMs) threads an SM: 128 blocks of 544 at the bsts_llt shape);
# K2's block is one warp, a lane a chain (kalman_seq.cu, kLanes)
LOGLIK_THREADS = 0
SMOOTHER_THREADS = 32
# steps K2 stages into shared memory at a time (kalman_seq.cu, kChunk)
SMOOTHER_CHUNK = 32
# K2w's and K3's blocks: warps of one chain each (kalman_wide.cu)
WIDE_THREADS = 128
DPATH_THREADS = 128
_NO_KERNEL = ("(ROADMAP.md, queue 7: kernel (b) for larger state "
              "dimensions and the other block classes)")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _observed_bytes(observed, t_len, device):
    """The [T] mask as aligned contiguous bytes on the card, or None (all
    observed)."""
    if observed is None:
        return None
    obs = torch.as_tensor(observed, device=device)
    if obs.shape != (t_len,):
        raise ValueError(f"observed must be [T] = [{t_len}]; got "
                         f"{tuple(obs.shape)}")
    # a fresh allocation: K2 copies the mask 4 bytes at a time
    return torch.empty(t_len, dtype=torch.uint8, device=device).copy_(obs)


def _checked(tensors: dict, dtype, device):
    """Contiguous copies (where needed) after the wrapper's checks."""
    out = {}
    for name, x in tensors.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}; every input must be "
                            f"{dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        out[name] = x.contiguous()
    return out


def _shape_check(p, b, d):
    want = {"z": (b, d), "t_mat": (b, d, d), "rqr": (b, d, d), "h": (b,),
            "a0": (b, d), "p0": (b, d, d)}
    for name, shape in want.items():
        if name in p and tuple(p[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}; got "
                             f"{tuple(p[name].shape)}")


def _series(y, dtype, device):
    y = torch.as_tensor(y, dtype=dtype, device=device)
    if y.dim() != 1:
        raise ValueError("the kernels take one series y [T] shared by all "
                         f"systems; got {tuple(y.shape)}")
    return y.contiguous()


def n_params(d):
    """J1's and J2's parameters: h, then the upper triangle of R Q R'."""
    return 1 + d * (d + 1) // 2


def launch_loglik(h, rqr, z, t_mat, a0, p0, y, observed, order=0):
    """The loglik on the card: ``order`` 0 launches K1 -> ll [B]; 1, J1 ->
    (ll, grad [B, NP]); 2, J2 -> (ll, grad, hess [B, NP, NP]), over the
    kernels' parameters (h, upper triangle of R Q R')."""
    dtype, device = h.dtype, h.device
    if dtype not in _DTYPE_TAG:
        raise TypeError(f"unsupported dtype {dtype}")
    b, d = z.shape
    kind = LOGLIK_KINDS[order]
    tags, dims = _build.KALMAN_ENTRIES[kind]
    if _DTYPE_TAG[dtype] not in tags:
        raise TypeError(f"the loglik's derivative kernels run float64 "
                        f"({tags}), not {dtype}")
    if d not in dims:
        raise NotImplementedError(
            f"the loglik {'derivative ' if order else ''}kernel takes "
            f"state dims {dims}, not {d} " + _NO_KERNEL)
    p = _checked({"z": z, "t_mat": t_mat, "rqr": rqr, "h": h, "a0": a0,
                  "p0": p0}, dtype, device)
    _shape_check(p, b, d)
    y = _series(y, dtype, device)
    obs = _observed_bytes(observed, y.shape[0], device)
    out = [torch.empty(b, dtype=dtype, device=device)]
    if order:
        out.append(torch.empty(b, n_params(d), dtype=dtype, device=device))
    if order == 2:
        out.append(torch.empty(b, n_params(d), n_params(d), dtype=dtype,
                               device=device))
    args = [p[k].data_ptr() for k in ("z", "t_mat", "rqr", "h", "a0", "p0")]
    args += [y.data_ptr(), _ptr(obs), *(o.data_ptr() for o in out)]
    fn = getattr(_build.library("kalman_seq"),
                 f"boom_kalman_{kind}_{_DTYPE_TAG[dtype]}_d{d}")
    rc = fn(*args, b, y.shape[0], LOGLIK_THREADS, _stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return tuple(out) if order else out[0]


def _sym_units(d, like):
    """[NP - 1, d, d]: R Q R' moved by a unit of each upper-triangle
    parameter (both entries of an off-diagonal one)."""
    units = torch.zeros(n_params(d) - 1, d, d, dtype=like.dtype,
                        device=like.device)
    k = 0
    for i in range(d):
        for j in range(i, d):
            units[k, i, j] = units[k, j, i] = 1.0
            k += 1
    return units


def loglik_jets_plain(h, rqr, z, t_mat, a0, p0, y, observed, order):
    """J1's (``order`` 1) and J2's (2) plain version: autograd of the plain
    loop ``kalman.kalman_loglik`` in the kernels' parameters (h, upper
    triangle of R Q R', as :func:`launch_loglik` gives them)."""
    b, d = z.shape
    units = _sym_units(d, h)
    eye = torch.eye(d, dtype=h.dtype, device=h.device).expand(b, d, d)

    def ll_of(theta):
        params = SsmParams(z, t_mat, eye, rqr + torch.einsum(
            "bk,kij->bij", theta[:, 1:], units), h + theta[:, 0], a0, p0)
        return kalman.kalman_loglik(params, y, observed)

    theta = torch.zeros(b, n_params(d), dtype=h.dtype, device=h.device,
                        requires_grad=True)
    with torch.enable_grad():
        ll = ll_of(theta)
        (grad,) = torch.autograd.grad(ll.sum(), theta,
                                      create_graph=order == 2)
        if order == 1:
            return ll.detach(), grad
        hess = torch.stack([torch.autograd.grad(
            grad[:, k].sum(), theta, retain_graph=True)[0]
            for k in range(n_params(d))], dim=1)
    return ll.detach(), grad.detach(), hess


def _sym_map(d, like):
    """[NP, 1 + d*d]: the kernel's parameters (h, then the upper triangle
    of R Q R', row-major) as linear functions of (h, every entry of R Q R'
    row-major). The loglik sees R Q R' only through its symmetric part, so
    an off-diagonal parameter is the mean of its two entries."""
    units = _sym_units(d, like)
    rqr_rows = units / units.sum((-1, -2), keepdim=True)
    return torch.block_diag(torch.ones(1, 1, dtype=like.dtype,
                                       device=like.device),
                            rqr_rows.reshape(-1, d * d))


class _LoglikGrad(torch.autograd.Function):
    """The loglik's gradient [B, 1 + d*d] over (h, R Q R') as a function of
    (h, R Q R'), whose own derivative is the saved Hessian: what makes
    :class:`_Loglik` differentiable twice."""

    @staticmethod
    def forward(ctx, h, rqr, grad, hess):
        ctx.save_for_backward(hess)
        ctx.rqr_shape = rqr.shape
        return grad.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_grad):
        (hess,) = ctx.saved_tensors
        v = (hess @ g_grad[..., None])[..., 0]
        return v[:, 0], v[:, 1:].reshape(ctx.rqr_shape), None, None


class _Loglik(torch.autograd.Function):
    """K1 as a function of (h [B], R Q R' [B, d, d]); the other system
    fields, the series and the mask are constants. The forward pass
    launches K1, or J1 when a gradient is wanted; the backward pass returns
    J1's gradient, or launches J2 when a second derivative can be asked of
    it (grad mode on inside backward: ``create_graph=True``, as
    ``torch.autograd.functional.hessian`` sets it)."""

    @staticmethod
    def forward(ctx, h, rqr, z, t_mat, a0, p0, y, observed):
        if any(ctx.needs_input_grad[2:]):
            raise NotImplementedError(
                "the loglik kernel differentiates in h and R Q R' only "
                "(ROADMAP.md, queue 7: kernel (b))")
        if not any(ctx.needs_input_grad[:2]):
            return launch_loglik(h, rqr, z, t_mat, a0, p0, y, observed)
        ll, grad = launch_loglik(h, rqr, z, t_mat, a0, p0, y, observed,
                                 order=1)
        ctx.save_for_backward(h, rqr, grad @ _sym_map(z.shape[-1], grad))
        ctx.constants = (z, t_mat, a0, p0, y, observed)
        return ll

    @staticmethod
    def backward(ctx, g_ll):
        h, rqr, grad = ctx.saved_tensors
        if torch.is_grad_enabled():
            _ll, grad, hess = launch_loglik(h.detach(), rqr.detach(),
                                            *ctx.constants, order=2)
            jac = _sym_map(rqr.shape[-1], grad)
            grad = _LoglikGrad.apply(h, rqr, grad @ jac,
                                     jac.transpose(0, 1) @ hess @ jac)
        full = grad * g_ll[:, None]
        return (full[:, 0], full[:, 1:].reshape(rqr.shape), None, None,
                None, None, None, None)


def kalman_loglik(params: SsmParams, y, observed=None):
    """[B] marginal log likelihoods of the systems ``params`` (leading
    series axis B) on the series ``y`` [T] (K1 on a CUDA tensor, the plain
    ``kalman.kalman_loglik`` on a CPU tensor)."""
    if not _on_card(params.h):
        return kalman.kalman_loglik(params, y, observed)
    kalman.check_static(params)
    return _Loglik.apply(params.h, params.rqr, params.z, params.t_mat,
                         params.a0, params.p0, y, observed)


def simulation_smoother(params: SsmParams, y, alpha1_z, eta_z, eps_z,
                        observed=None):
    """alpha+ + E_0[alpha | y - y+] [C, T, d] for every chain (K2 or K2w on
    a CUDA tensor, the plain ``kalman.simulation_smoother`` on a CPU
    tensor). y: [T], or [C, T] a series a chain. Normals as
    ``kalman.simulation_smoother`` takes them."""
    if not _on_card(params.h):
        return kalman.simulation_smoother(params, y, alpha1_z, eta_z, eps_z,
                                          observed)
    return launch_smoother(*smoother_operands(params, y, alpha1_z, eta_z,
                                              eps_z, observed))


def smoother_operands(params: SsmParams, y, alpha1_z, eta_z, eps_z,
                      observed=None):
    """K2's (d <= 6) or K2w's (7 <= d <= 16) checked, contiguous operands:
    ({name: tensor}, y [T], the mask bytes or None). The draws' noise
    (alpha_1, w = R chol(Q) eta, sqrt(h) eps) is formed here by
    ``kalman.simulation_inputs``, as the plain version forms it. The
    kernels take one series y [T] for all chains; a series a chain y_c
    [C, T] enters through the observation noise: the smoother reads eps
    only in y - y+ = y - (z' alpha+ + eps), so y_c with eps is the shared
    series 0 with eps - y_c (the same draw up to rounding)."""
    kalman.check_static(params)
    dtype, device = params.h.dtype, params.h.device
    tags, dims = _build.KALMAN_ENTRIES["smoother"]
    if _DTYPE_TAG.get(dtype) not in tags:
        raise TypeError(f"the smoother kernel runs float64 (bsts."
                        f"SMOOTHER_DTYPE), not {dtype}")
    c, d = params.z.shape
    if d not in dims and d not in _build.WIDE_DIMS:
        raise NotImplementedError(
            f"the smoother kernels take state dims {dims} (K2) and "
            f"{_build.WIDE_DIMS[0]}..{_build.WIDE_DIMS[-1]} (K2w), not {d} "
            + _NO_KERNEL)
    y = torch.as_tensor(y, dtype=dtype, device=device)
    per_chain = y.dim() == 2
    if per_chain and tuple(y.shape) != (c, y.shape[-1]):
        raise ValueError(f"a series a chain must be [{c}, T]; got "
                         f"{tuple(y.shape)}")
    t_len = y.shape[-1]
    alpha1, w, eps = kalman.simulation_inputs(params, alpha1_z, eta_z,
                                              eps_z)
    if per_chain:
        eps = eps - y
        y = y.new_zeros(t_len)
    y = _series(y, dtype, device)
    p = _checked({"z": params.z, "t_mat": params.t_mat, "rqr": params.rqr,
                  "h": params.h, "p0": params.p0, "alpha1": alpha1, "w": w,
                  "eps": eps}, dtype, device)
    _shape_check(p, c, d)
    if p["w"].shape != (c, t_len - 1, d) or p["eps"].shape != (c, t_len):
        raise ValueError(f"normals must give w [{c}, {t_len - 1}, {d}] and "
                         f"eps [{c}, {t_len}]")
    return p, y, _observed_bytes(observed, t_len, device)


def launch_smoother(p, y, obs):
    """K2 (d <= 6) or K2w on operands from :func:`smoother_operands` ->
    [C, T, d]."""
    (c, d), t_len = p["z"].shape, y.shape[0]
    scratch = p["z"].new_empty(c, t_len, d + 1)
    out = p["z"].new_empty(c, t_len, d)
    ptrs = [p[k].data_ptr() for k in ("z", "t_mat", "rqr", "h", "p0",
                                      "alpha1", "w", "eps")]
    ptrs += [y.data_ptr(), _ptr(obs), scratch.data_ptr(), out.data_ptr()]
    if d in _build.WIDE_DIMS:
        kind = "smoother_wide"
        rc = _build.library("kalman_wide").boom_kalman_smoother_wide_f64(
            *ptrs, c, t_len, d, WIDE_THREADS, _stream(y.device))
    else:
        kind = "smoother"
        fn = getattr(_build.library("kalman_seq"),
                     f"boom_kalman_smoother_f64_d{d}")
        rc = fn(*ptrs, c, t_len, SMOOTHER_THREADS, _stream(y.device))
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return out


def dpath(t_mat, w):
    """ASIS D-paths [C, G, T, d] (D_0 = 0, D_t = T_c D_{t-1} + w_{c,g,t})
    of t_mat [C, d, d] and w [C, G, T-1, d] (K3 on a CUDA tensor, the plain
    ``kalman.dpath`` on a CPU tensor)."""
    if not _on_card(w):
        return kalman.dpath(t_mat, w)
    return launch_dpath(t_mat, w)


def launch_dpath(t_mat, w):
    """K3 on the card: checks, then one launch -> [C, G, T, d]."""
    dtype, device = w.dtype, w.device
    if dtype not in _DTYPE_TAG:
        raise TypeError(f"the D-path kernel runs float32 or float64, not "
                        f"{dtype}")
    c, g, t_m1, d = w.shape
    if d not in _build.DPATH_DIMS:
        raise NotImplementedError(
            f"the D-path kernel takes state dims {_build.DPATH_DIMS[0]}.."
            f"{_build.DPATH_DIMS[-1]}, not {d} " + _NO_KERNEL)
    p = _checked({"t_mat": t_mat, "w": w}, dtype, device)
    if p["t_mat"].shape != (c, d, d):
        raise ValueError(f"t_mat must be {(c, d, d)}; got "
                         f"{tuple(p['t_mat'].shape)}")
    out = w.new_empty(c, g, t_m1 + 1, d)
    fn = getattr(_build.library("kalman_wide"),
                 f"boom_dpath_{_DTYPE_TAG[dtype]}")
    rc = fn(p["t_mat"].data_ptr(), p["w"].data_ptr(), out.data_ptr(), c, g,
            t_m1 + 1, d, DPATH_THREADS, _stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA dpath launch failed: cudaError {rc}")
    LAUNCHES["dpath"] += 1
    return out

"""Kalman filter and Durbin-Koopman simulation smoother for scalar series,
sequential in time (port of boom_tpu/statespace/kalman.py: ``SsmParams``
:67, ``FilterResult`` :121, ``_filter_core`` :162, ``kalman_filter`` :218,
``kalman_loglik`` :229, ``_smoother_passes`` :289, ``fast_state_smoother``
:353, ``smooth_states`` :361, ``simulate`` :372 and the fused static
``simulation_smoother`` :414-481), and the ASIS D-path recurrence of
boom_tpu/statespace/bsts.py:1077-1084 (:func:`dpath`).

Model:

    y_t     = Z' alpha_t + eps_t,        eps_t ~ N(0, H)
    alpha_1 = a0 + P0^{1/2} xi
    alpha_{t+1} = T alpha_t + R eta_t,   eta_t ~ N(0, Q)

The port carries the series axis explicitly: every field of ``SsmParams``
has a leading ``[B]`` dimension (chains, or chains x candidates), and one
series ``y`` [T] (or one a system, ``[B, T]``; for the loglik and the
filter also one a group of systems, ``[S, T]`` with S dividing B, system b
reading series b // (B / S)) and ``observed`` mask [T] serve them all.
:func:`loglik_jets` differentiates the loglik along directions of the
system (the TIM mode search's derivatives in the variances).

A system may vary in time as the reference's does (kalman.py:67-120): z
[B, T, d], one [T, d] expanded over the systems (stride 0: the dynamic
regression's x_t, the holiday's one-hot day); h_t = h * h_scale_t with
h_scale [T] (1 / max(w_t, 1) of the observation weights); and Q_t =
(q_t q_t') o Q with q_scale [B, T, q] (the Student trend's latent weights
a chain, the holiday's refresh days, expanded); and a time-varying T
(the reference's ``t_seq`` [T, d, d]) as its distinct matrices t_mats [B,
K, d, d] (expanded where every system shares them) and the one each step
takes, t_choice [T] (the monthly cycle's calendar: K = 2). Row t of z and
h serves observation t, row t of q_scale and of t_choice the transition
t -> t+1. A z that differs from system to system (the regression
holiday's) is not ported and raises. The functions here are the plain
PyTorch versions, one Python step per time step; ``kalman_kernel.py`` runs
``kalman_loglik`` and ``simulation_smoother`` as hand-written CUDA kernels
on the card. The arithmetic follows the reference's order step for step
(``_mv``, ``_mm``, the ``0.5 (P + P')`` symmetrization, the ``where(observed,
...)`` zeros and the ``1e-12`` Cholesky jitter), so both agree to rounding.
Random numbers
come in as standard normals, never drawn here.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

LOG_2PI = math.log(2.0 * math.pi)
_PER_SYSTEM_Z = ("a z [B, T, d] that differs from system to system (the "
                 "regression holiday's z_seq_params) is not ported yet "
                 "(ROADMAP.md, queue 1 item 7: RegressionHoliday and "
                 "HierarchicalRegressionHoliday); pass one [T, d] expanded "
                 "over the systems")


class SsmParams(NamedTuple):
    """Batched system; every field has a leading series axis (see the
    module's docstring for the time-varying fields)."""

    z: torch.Tensor  # [B, d] or [B, T, d] (one [T, d], expanded)
    t_mat: torch.Tensor  # [B, d, d] transition
    r_mat: torch.Tensor  # [B, d, q] error expander
    q_mat: torch.Tensor  # [B, q, q] state error covariance
    h: torch.Tensor  # [B] observation variance
    a0: torch.Tensor  # [B, d] initial state mean
    p0: torch.Tensor  # [B, d, d] initial state covariance
    q_scale: torch.Tensor | None = None  # [B, T, q] sd scale of Q
    h_scale: torch.Tensor | None = None  # [T] scale of h
    t_mats: torch.Tensor | None = None  # [B, K, d, d] the distinct T_t
    t_choice: torch.Tensor | None = None  # [T] int: step t's of t_mats

    @property
    def rqr(self):
        """[B, d, d] state error covariance R Q R' (of q_scale 1)."""
        return self.r_mat @ self.q_mat @ self.r_mat.transpose(-1, -2)

    @property
    def time_varying(self):
        """z [B, T, d], a q_scale, an h_scale or a T_t (reference
        ``SsmParams.time_varying``)."""
        return (self.z.dim() == 3 or self.q_scale is not None
                or self.h_scale is not None or self.t_choice is not None)

    def ts(self, t_len):
        """[B, T, d, d] transition matrices (reference ``ts``)."""
        if self.t_choice is None:
            return self.t_mat[:, None].expand(-1, t_len, -1, -1)
        return self.t_mats[:, self.t_choice]

    def zs(self, t_len):
        """[B, T, d] observation vectors."""
        if self.z.dim() == 3:
            return self.z
        return self.z[:, None, :].expand(-1, t_len, -1)

    def hs(self, t_len):
        """[B, T] observation variances h_t = h * h_scale_t."""
        if self.h_scale is None:
            return self.h[:, None].expand(-1, t_len)
        return self.h[:, None] * self.h_scale

    def rqrs(self, t_len):
        """[B, T, d, d] state error covariances R Q_t R' with Q_t =
        (q_t q_t') o Q (reference ``rqrs``, kalman.py:111-120)."""
        if self.q_scale is None:
            return self.rqr[:, None].expand(-1, t_len, -1, -1)
        s = self.q_scale
        q_t = s[..., :, None] * s[..., None, :] * self.q_mat[:, None]
        return torch.einsum("bdq,btqr,ber->btde", self.r_mat, q_t,
                            self.r_mat)

    def cast(self, dtype):
        """The system with every float field in ``dtype``; a field expanded
        over the systems (stride 0: one z_t, T or q_scale for all) stays
        so."""
        return SsmParams(*(f if f is None or not f.is_floating_point()
                           else _cast(f, dtype) for f in self))


def _cast(x, dtype):
    """x in ``dtype``, one row expanded where x is expanded over its
    leading axis (``Tensor.to`` would materialise it)."""
    if x.dim() > 1 and x.shape[0] > 1 and x.stride(0) == 0:
        return x[:1].to(dtype).expand_as(x)
    return x.to(dtype)


class FilterResult(NamedTuple):
    loglik: torch.Tensor  # [B]
    v: torch.Tensor  # [B, T] prediction errors
    f: torch.Tensor  # [B, T] prediction error variances
    k: torch.Tensor  # [B, T, d] Kalman gains (for the T a_t update)
    a: torch.Tensor  # [B, T, d] predicted means E[alpha_t | y_{1:t-1}]
    p: torch.Tensor  # [B, T, d, d] predicted covariances


def _mv(m, v):
    """Matrix-vector product as the reference's elementwise ``_mv``."""
    return (m * v[..., None, :]).sum(-1)


def _mm(a, b):
    """[d, d] product as the reference's elementwise ``_mm``."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _vdot(a, b):
    return (a * b).sum(-1)


def check_system(params: SsmParams):
    """Raise for a system the port does not take: z [B, T, d] of more
    than one row along the systems (a z a system), h not [B]."""
    z = params.z
    if z.dim() == 3 and z.shape[0] > 1 and z.stride(0) != 0:
        raise NotImplementedError(_PER_SYSTEM_Z)
    if params.h.dim() != 1:
        raise ValueError(f"h must be [B] (a time-varying h is h * h_scale, "
                         f"h_scale [T]); got {tuple(params.h.shape)}")


class _Steps(NamedTuple):
    """The system's per-step inputs: rows t of z, h and R Q R' [B, ...]
    (static fields broadcast)."""

    z: torch.Tensor  # [B, d] or [B, T, d]
    h: torch.Tensor  # [B] or [B, T]
    rqr: torch.Tensor  # [B, d, d] or [B, T, d, d]

    def at(self, t):
        z = self.z[:, t] if self.z.dim() == 3 else self.z
        h = self.h[:, t] if self.h.dim() == 2 else self.h
        rqr = self.rqr[:, t] if self.rqr.dim() == 4 else self.rqr
        return z, h, rqr


def _steps(params: SsmParams, t_len) -> _Steps:
    check_system(params)
    return _Steps(z=params.z,
                  h=params.h if params.h_scale is None
                  else params.hs(t_len),
                  rqr=params.rqr if params.q_scale is None
                  else params.rqrs(t_len))


def transitions(params: SsmParams, t_len):
    """T_t of step t as a function of t, [B, d, d]: the static T, or the
    matrix of t_mats that t_choice gives step t (read once from the
    host)."""
    if params.t_choice is None:
        return lambda t: params.t_mat
    choice = params.t_choice.tolist()
    if len(choice) != t_len:
        raise ValueError(f"t_choice must give [T] = [{t_len}] steps; got "
                         f"{len(choice)}")
    mats = [params.t_mats[:, k] for k in range(params.t_mats.shape[1])]
    return lambda t: mats[choice[t]]


def _mask(observed, t_len, device):
    """[T] bool mask (all True when ``observed`` is None)."""
    if observed is None:
        return torch.ones(t_len, dtype=torch.bool, device=device)
    return torch.as_tensor(observed, dtype=torch.bool, device=device)


def _series(y, params):
    """y in the system's dtype, as [T] or [B, T] (broadcast over B)."""
    return torch.as_tensor(y, dtype=params.t_mat.dtype,
                           device=params.t_mat.device)


def _at(y, t):
    """y_t for every series: a scalar or [B]."""
    return y[..., t]


def series_count(y, b):
    """S of y [T] (1) or of y [S, T], S dividing the ``b`` systems: system i
    reads series i // (b / S)."""
    if y.dim() == 1:
        return 1
    if y.dim() != 2 or y.shape[0] < 1 or b % y.shape[0]:
        raise ValueError(f"y must be [T] or [S, T] with S dividing the {b} "
                         f"systems; got {tuple(y.shape)}")
    return y.shape[0]


def per_system(y, b):
    """y [T] as it is, or y [S, T] (``series_count``) as [b, T]."""
    s = series_count(y, b)
    return y if y.dim() == 1 else y.repeat_interleave(b // s, dim=0)


def _filter_step(a, p, y_t, obs_t, z, h, rqr, t_mat):
    """One step of the reference's ``step_core``: (v, f, k, a_next,
    p_next)."""
    v = torch.where(obs_t, y_t - _vdot(z, a), 0.0)
    pz = _mv(p, z)
    f = _vdot(z, pz) + h
    k_gain = torch.where(obs_t, _mv(t_mat, pz) / f[:, None], 0.0)
    l_mat = t_mat - k_gain[..., :, None] * z[..., None, :]
    a_next = _mv(t_mat, a) + k_gain * v[:, None]
    p_next = _mm(_mm(t_mat, p), l_mat.transpose(-1, -2)) + rqr
    p_next = 0.5 * (p_next + p_next.transpose(-1, -2))
    return v, f, k_gain, a_next, p_next


def _step_loglik(obs_t, v, f):
    return torch.where(obs_t, -0.5 * (LOG_2PI + torch.log(f) + v * v / f),
                       0.0)


def _filter_core(params: SsmParams, y, observed, want_ap: bool):
    """The forward pass: per-step (v, f, k, ll) stacked along T, plus the
    predicted (a, P) when ``want_ap``."""
    y = per_system(_series(y, params), params.h.shape[0])
    t_len = y.shape[-1]
    obs = _mask(observed, t_len, y.device)
    steps, t_at = _steps(params, t_len), transitions(params, t_len)
    a, p = params.a0, params.p0
    out = {"v": [], "f": [], "k": [], "ll": [], "a": [], "p": []}
    for t in range(t_len):
        v, f, k_gain, a_next, p_next = _filter_step(
            a, p, _at(y, t), obs[t], *steps.at(t), t_at(t))
        for name, val in (("v", v), ("f", f), ("k", k_gain),
                          ("ll", _step_loglik(obs[t], v, f))):
            out[name].append(val)
        if want_ap:
            out["a"].append(a)
            out["p"].append(p)
        a, p = a_next, p_next
    return {name: torch.stack(vals, dim=1) for name, vals in out.items()
            if vals}


def kalman_filter(params: SsmParams, y, observed=None) -> FilterResult:
    """Forward pass. ``observed`` is a [T] bool mask (True = y_t present)."""
    out = _filter_core(params, y, observed, want_ap=True)
    return FilterResult(loglik=out["ll"].sum(-1), v=out["v"], f=out["f"],
                        k=out["k"], a=out["a"], p=out["p"])


def kalman_loglik(params: SsmParams, y, observed=None, innovations=False):
    """[B] marginal log likelihoods: the filter with the loglik carried
    step by step and nothing else stored along T; with ``innovations`` also
    the prediction errors v and their variances f [B, T] (as
    ``kalman_filter`` gives them: the reference's ``kalman_filter``,
    kalman.py:218), as (ll, v, f)."""
    y = per_system(_series(y, params), params.h.shape[0])
    t_len = y.shape[-1]
    obs = _mask(observed, t_len, y.device)
    steps, t_at = _steps(params, t_len), transitions(params, t_len)
    a, p = params.a0, params.p0
    ll = torch.zeros_like(params.h)
    vs, fs = [], []
    for t in range(t_len):
        v, f, _k, a, p = _filter_step(a, p, _at(y, t), obs[t],
                                      *steps.at(t), t_at(t))
        ll = ll + _step_loglik(obs[t], v, f)
        if innovations:
            vs.append(v)
            fs.append(f)
    if innovations:
        return ll, torch.stack(vs, dim=1), torch.stack(fs, dim=1)
    return ll


def along(h, rqr, dh, dm, c):
    """The systems moved along K directions: (h + sum_k c_k dh_k [B],
    R Q R' + sum_k c_k dm_k [B, d, d]) for c [B, K], dh [K], dm [K, d, d]."""
    return h + c @ dh, rqr + torch.einsum("bk,kij->bij", c, dm)


def loglik_along(c, h0, q0, dh, dm, z, t_mat, a0, p0, y, observed=None):
    """[B] loglik of the systems (z, t_mat, a0, p0) with (h, R Q R') moved
    from (h0, q0) along K directions by c [B, K] (:func:`along`); autograd
    differentiates it in c through the plain loop."""
    h, rqr = along(h0, q0, dh, dm, c)
    eye = torch.eye(z.shape[-1], dtype=c.dtype, device=c.device)
    return kalman_loglik(SsmParams(z, t_mat, eye.expand_as(rqr), rqr, h, a0,
                                   p0), y, observed)


def loglik_jets(h, rqr, z, t_mat, a0, p0, y, observed, dh, dm, order):
    """The loglik of each system with its derivatives along K directions
    of (h, R Q R') (:func:`along`) at c = 0, by autograd of the plain loop:
    ``order`` 1 gives (ll [B], grad [B, K]), 2 (ll, grad, hess [B, K, K]).
    The plain version of the jets J1 and J2 (``kalman_kernel``)."""
    c = torch.zeros(z.shape[0], dh.shape[0], dtype=h.dtype, device=h.device,
                    requires_grad=True)
    with torch.enable_grad():
        ll = loglik_along(c, h, rqr, dh, dm, z, t_mat, a0, p0, y, observed)
        (grad,) = torch.autograd.grad(ll.sum(), c, create_graph=order == 2)
        if order == 1:
            return ll.detach(), grad
        hess = torch.stack([torch.autograd.grad(
            grad[:, k].sum(), c, retain_graph=True)[0]
            for k in range(dh.shape[0])], dim=1)
    return ll.detach(), grad.detach(), hess


def _smoother_passes(params: SsmParams, v, f, k, observed):
    """Backward r recursion, then the forward state recursion, from the
    filter's (v [B, T], f [B, T], k [B, T, d]) streams -> [B, T, d]."""
    t_len = v.shape[1]
    obs = _mask(observed, t_len, v.device)
    steps, t_at = _steps(params, t_len), transitions(params, t_len)
    r = torch.zeros_like(params.a0)
    rs = [None] * t_len
    for t in range(t_len - 1, -1, -1):
        z = steps.at(t)[0]
        l_mat = t_at(t) - k[:, t, :, None] * z[..., None, :]
        r = (torch.where(obs[t], z * (v[:, t] / f[:, t])[:, None], 0.0)
             + _mv(l_mat.transpose(-1, -2), r))
        rs[t] = r  # r_{t-1} in the reference's indexing
    alpha = params.a0 + _mv(params.p0, rs[0])
    alphas = [alpha]
    for t in range(1, t_len):
        # alpha_{t+1} = T_t alpha_t + R Q_t R' r_t (reference :340-343)
        alpha = _mv(t_at(t - 1), alpha) + _mv(steps.at(t - 1)[2], rs[t])
        alphas.append(alpha)
    return torch.stack(alphas, dim=1)


def fast_state_smoother(params: SsmParams, filt: FilterResult,
                        observed=None):
    """Koopman (1993) fast state smoother: E[alpha_t | y_{1:T}]."""
    return _smoother_passes(params, filt.v, filt.f, filt.k, observed)


def smooth_states(params: SsmParams, y, observed=None):
    """Filter + smoother without storing the per-step (a, P)."""
    out = _filter_core(params, y, observed, want_ap=False)
    return _smoother_passes(params, out["v"], out["f"], out["k"], observed)


def _chol_jitter(m):
    """Cholesky factor of m + 1e-12 I, as the reference takes it. Like
    ``jnp.linalg.cholesky`` it does not raise (a failed factor carries NaN
    on), so it never waits for the device."""
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    return torch.linalg.cholesky_ex(m + 1e-12 * eye).L


def simulation_inputs(params: SsmParams, alpha1_z, eta_z, eps_z):
    """The fused smoother's draws from standard normals: alpha_1 [B, d],
    the state innovations w = R (q_t o chol(Q) eta_t) [B, T-1, d] and the
    observation noise sqrt(h_t) eps [B, T] (reference kalman.py:442-455;
    with q_scale and h_scale as ``simulate`` forms them, :383-390, :409)."""
    p0_chol = _chol_jitter(params.p0)
    alpha1 = params.a0 + _mv(p0_chol, alpha1_z)
    q_chol = _chol_jitter(params.q_mat)
    eta = torch.einsum("bij,btj->bti", q_chol, eta_z)
    if params.q_scale is not None:
        eta = params.q_scale[:, :-1] * eta
    w = torch.einsum("bdq,btq->btd", params.r_mat, eta)
    eps = torch.sqrt(params.hs(eps_z.shape[-1])) * eps_z
    return alpha1, w, eps


def simulate(params: SsmParams, t_len: int, alpha1_z, eta_z, eps_z):
    """Unconditional (alpha [B, T, d], y [B, T]) draw from the standard
    normals alpha1_z [B, d], eta_z [B, T-1, q], eps_z [B, T]."""
    check_system(params)
    t_at = transitions(params, t_len)
    alpha = params.a0 + (_chol_jitter(params.p0) @ alpha1_z[..., None])[
        ..., 0]
    etas = torch.einsum("bij,btj->bti", _chol_jitter(params.q_mat), eta_z)
    if params.q_scale is not None:
        etas = params.q_scale[:, :-1] * etas
    alphas = [alpha]
    for t in range(t_len - 1):
        alpha = _mv(t_at(t), alpha) + _mv(params.r_mat, etas[:, t])
        alphas.append(alpha)
    alphas = torch.stack(alphas, dim=1)
    eps = torch.sqrt(params.hs(t_len)) * eps_z
    return alphas, torch.einsum("btd,btd->bt", params.zs(t_len), alphas) + eps


def simulation_smoother(params: SsmParams, y, alpha1_z, eta_z, eps_z,
                        observed=None):
    """Draw alpha ~ p(alpha | y) [B, T, d] by the Durbin-Koopman
    mean-correction smoother: the unconditional simulation is fused into
    the filter's forward pass on y - y+, then the backward r pass and the
    forward state pass give E_0[alpha | y - y+], and the draw is alpha+ +
    that. Normals: alpha1_z [B, d], eta_z [B, T-1, q], eps_z [B, T]
    (``bsts._smoother_noise_spec``'s ``sim_alpha1``, ``sim_eta``,
    ``sim_eps``). A time-varying system takes this fused form too, where
    the reference simulates first and then smooths y - y+
    (kalman.py:432-437): the same draw from the same normals, to
    rounding."""
    y = _series(y, params)
    t_len = y.shape[-1]
    obs = _mask(observed, t_len, y.device)
    steps, t_at = _steps(params, t_len), transitions(params, t_len)
    alpha_sim, w, eps = simulation_inputs(params, alpha1_z, eta_z, eps_z)
    a, p = torch.zeros_like(params.a0), params.p0
    plus, vs, fs, ks = [], [], [], []
    for t in range(t_len):
        z, h, rqr = steps.at(t)
        t_mat = t_at(t)
        yd = _at(y, t) - (_vdot(z, alpha_sim) + eps[:, t])
        v, f, k_gain, a, p = _filter_step(a, p, yd, obs[t], z, h, rqr,
                                          t_mat)
        plus.append(alpha_sim)
        vs.append(v)
        fs.append(f)
        ks.append(k_gain)
        if t < t_len - 1:
            alpha_sim = _mv(t_mat, alpha_sim) + w[:, t]
    params0 = params._replace(a0=torch.zeros_like(params.a0))
    alpha_hat = _smoother_passes(params0, torch.stack(vs, 1),
                                 torch.stack(fs, 1), torch.stack(ks, 1),
                                 obs)
    return torch.stack(plus, dim=1) + alpha_hat


def dpath(t_mat, w):
    """ASIS D-paths [C, G, T, d] of every chain's G groups: D_0 = 0,
    D_t = T_c D_{t-1} + w_{c,g,t} (reference bsts.py:1077-1084, a
    sequential ``lax.scan``), one Python step a time step. t_mat [C, d, d]
    (shared by the groups), w [C, G, T-1, d]."""
    c, g, t_m1, d = w.shape
    cur = w.new_zeros(c, g, d)
    out = [cur]
    for t in range(t_m1):
        cur = _mv(t_mat[:, None], cur) + w[:, :, t]
        out.append(cur)
    return torch.stack(out, dim=2)

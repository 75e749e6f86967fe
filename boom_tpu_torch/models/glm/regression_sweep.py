"""SWEEP-operator fast path of the SSVS indicator sweep (port of
boom_tpu/models/glm/regression_sweep.py), batched over chains.

For the inclusion set g of each chain it keeps the swept form of the
augmented matrix

    S = sweep_g( [[Omega + X'X, Omega b + X'y], [., prior_ss + y'y]] )

and a swept copy of Omega, so that a flip needs only scalar reads to give
its Gibbs odds and, if taken, two rank-1 sweeps. This module is the plain
PyTorch version of everything kernel (a) (``csrc/ssvs_sweep.cu``) computes
in one launch; ``ssvs_kernel.draw_indicators_swept`` launches the kernel on
a CUDA tensor and calls :func:`draw_indicators_swept` on a CPU tensor.

Every chain has its own flip order, so the index ``j`` of a flip is a
tensor [C]. The arithmetic follows the reference's in its order; where the
reference sums, the port adds in index order where the kernel does (the
spike, the proposal's log probability), so that the kernel can agree with
this version to the last bit on the card. Differences from the reference:

- the ``1e-300`` clamps (:131-135, :209, :279) are ``finfo(dtype).tiny``:
  ``1e-300`` is 0 in float32 (ROADMAP.md §3);
- the prior's ``max_size`` is enforced: a flip that would include a
  coordinate past it has log probability -inf, and so has a mode jump
  whose proposal exceeds it. The reference's SWEEP path takes the spike
  prior once and then adds log odds, so it never applies the cap
  (ROADMAP.md §3);
- noise comes in as tensors: ``perm`` [C, p] (each chain's flip order),
  ``flip_u`` [C, p] (a uniform a flip), ``jump_u`` [C, p] and ``jump_acc``
  [C] (the mode jump's proposal and acceptance uniforms).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from boom_tpu_torch.linalg.sweep import gated_flip_sweep
from boom_tpu_torch.models.glm.regression import RegSuf, SpikeSlabPrior

# Hamming budget of the incremental mode-jump move (reference :170)
MODE_JUMP_BUDGET = 16


def valid_for_prior(prior: SpikeSlabPrior) -> bool:
    """True if the SWEEP path is exact for this prior: every coordinate
    with a nonzero prior mean is forced in (reference :55). Reads the
    prior on the host once, when a kernel is built."""
    mean = prior.mean.detach().cpu().numpy()
    forced = prior.log_inclusion_odds.detach().cpu().numpy() >= 30.0
    return bool(((mean == 0.0) | forced).all())


class SweepState(NamedTuple):
    s: torch.Tensor  # [C, p+1, p+1] augmented swept matrix
    o: torch.Tensor  # [C, p, p] swept prior precision
    logdet_a: torch.Tensor  # [C] logdet (Omega + X'X)_g
    logdet_o: torch.Tensor  # [C] logdet Omega_g
    q: torch.Tensor  # [C] b_g' Omega_g b_g
    spike: torch.Tensor  # [C] log spike prior of g
    mask: torch.Tensor  # [C, p] bool
    size: torch.Tensor  # [C] int64, |g|


def border(suf: RegSuf, prior: SpikeSlabPrior):
    """Row and column p of S0: (Omega b + X'y, prior_ss + y'y), [p+1] or,
    with per-chain statistics, [C, p+1]."""
    pm = prior.unscaled_precision @ prior.mean + suf.xty
    c = prior.prior_ss + suf.yty
    return torch.cat([pm, c[..., None]], dim=-1)


def _augmented(suf: RegSuf, prior: SpikeSlabPrior):
    """S0 [p+1, p+1] (reference :75), or [C, p+1, p+1] when the
    statistics X'y and y'y are per chain (the reference's under ``vmap``)."""
    a = prior.unscaled_precision + suf.xtx
    edge = border(suf, prior)
    a = a.expand(*edge.shape[:-1], *a.shape)
    top = torch.cat([a, edge[..., :-1, None]], dim=-1)
    return torch.cat([top, edge[..., None, :]], dim=-2)


def _q(prior: SpikeSlabPrior, mask):
    """b_g' Omega_g b_g [C]."""
    bm = prior.mean * mask.to(prior.mean.dtype)
    return (bm * (bm @ prior.unscaled_precision)).sum(-1)


def build_sweep_state(suf: RegSuf, prior: SpikeSlabPrior, mask) -> SweepState:
    """The swept state of every chain's mask [C, p]: p gated sweeps in
    index order (reference :84), from one S0 or one a chain."""
    c, p = mask.shape
    s = _augmented(suf, prior).expand(c, p + 1, p + 1)
    o = prior.unscaled_precision.expand(c, p, p)
    zero = torch.zeros(c, dtype=s.dtype, device=s.device)
    ld_a, ld_o, spike = zero, zero, zero
    for j in range(p):
        incl = mask[:, j]
        piv_a, piv_o = s[:, j, j], o[:, j, j]
        s = gated_flip_sweep(s, j, False, incl)
        o = gated_flip_sweep(o, j, False, incl)
        ld_a = ld_a + torch.where(incl, torch.log(piv_a), 0.0)
        ld_o = ld_o + torch.where(incl, torch.log(piv_o), 0.0)
        spike = spike + torch.where(incl, prior.log_inclusion_odds[j], 0.0)
    size = mask.sum(-1)
    spike = spike + prior.log_inclusion_norm
    if prior.max_size is not None:
        spike = torch.where(size > prior.max_size, -torch.inf, spike)
    return SweepState(s=s, o=o, logdet_a=ld_a, logdet_o=ld_o,
                      q=_q(prior, mask), spike=spike, mask=mask, size=size)


def _log_model_prob(st: SweepState, df):
    """log p(g | y) up to a constant, from the state (reference :115)."""
    p = st.mask.shape[-1]
    ss = st.s[:, p, p] + st.q
    return (st.spike + 0.5 * (st.logdet_o - st.logdet_a)
            - (0.5 * df - 1.0) * torch.log(ss))


class FlipDeltas(NamedTuple):
    incl: torch.Tensor  # [C] bool, j currently included
    corner: torch.Tensor
    dq: torch.Tensor
    d_ld_a: torch.Tensor
    d_ld_o: torch.Tensor
    d_spike: torch.Tensor


def _flip_deltas(st: SweepState, prior: SpikeSlabPrior, j) -> FlipDeltas:
    """Scalars of the state after flipping each chain's j [C] (reference
    :122; no matrix work)."""
    p = st.mask.shape[-1]
    ar = torch.arange(j.shape[0], device=j.device)
    tiny = torch.finfo(st.s.dtype).tiny
    incl = st.mask[ar, j]
    sjj, ojj = st.s[ar, j, j], st.o[ar, j, j]
    d_ld_a = torch.where(incl, -torch.log(torch.clamp_min(-1.0 / sjj, tiny)),
                         torch.log(torch.clamp_min(sjj, tiny)))
    d_ld_o = torch.where(incl, -torch.log(torch.clamp_min(-1.0 / ojj, tiny)),
                         torch.log(torch.clamp_min(ojj, tiny)))
    corner = st.s[:, p, p] - st.s[ar, p, j] * st.s[ar, j, p] / sjj
    m = st.mask.to(st.s.dtype)
    bj = prior.mean[j]
    om = prior.unscaled_precision
    cross = bj * (om[j] * (prior.mean * m)).sum(-1)
    own = bj * bj * om[j, j]
    dq = torch.where(incl, -(2.0 * cross - own), 2.0 * cross + own)
    d_spike = torch.where(incl, -prior.log_inclusion_odds[j],
                          prior.log_inclusion_odds[j])
    return FlipDeltas(incl, corner, dq, d_ld_a, d_ld_o, d_spike)


def _logp_flip(st: SweepState, fd: FlipDeltas, df, max_size=None):
    """log p(g with j flipped | y) [C]; -inf where the residual sum of
    squares is not positive, or (``max_size``) where the flip would
    include a coordinate past the cap."""
    ss = fd.corner + st.q + fd.dq
    tiny = torch.finfo(ss.dtype).tiny
    logp = torch.where(
        ss > 0,
        st.spike + fd.d_spike
        + 0.5 * ((st.logdet_o + fd.d_ld_o) - (st.logdet_a + fd.d_ld_a))
        - (0.5 * df - 1.0) * torch.log(torch.clamp_min(ss, tiny)),
        -torch.inf)
    if max_size is not None:
        logp = torch.where(~fd.incl & (st.size >= max_size), -torch.inf,
                           logp)
    return logp


def _gated_apply_flip(st: SweepState, j, take, fd: FlipDeltas) -> SweepState:
    """The flip at each chain's j where ``take``, nothing elsewhere
    (reference :150)."""
    ar = torch.arange(j.shape[0], device=j.device)
    mask = st.mask.clone()
    mask[ar, j] = torch.where(take, ~fd.incl, fd.incl)
    step = torch.where(fd.incl, -1, 1)
    return SweepState(
        s=gated_flip_sweep(st.s, j, fd.incl, take),
        o=gated_flip_sweep(st.o, j, fd.incl, take),
        logdet_a=st.logdet_a + torch.where(take, fd.d_ld_a, 0.0),
        logdet_o=st.logdet_o + torch.where(take, fd.d_ld_o, 0.0),
        q=st.q + torch.where(take, fd.dq, 0.0),
        spike=st.spike + torch.where(take, fd.d_spike, 0.0),
        mask=mask, size=st.size + torch.where(take, step, 0))


def log_sigmoid(x):
    """min(x, 0) - log1p(exp(-|x|)), the form kernel (a) computes."""
    return torch.minimum(x, torch.zeros_like(x)) - torch.log1p(
        torch.exp(-x.abs()))


def _log_q(mask, logq, log1mq):
    """log q(g) under the product-Bernoulli proposal [C], summed in index
    order."""
    mf = mask.to(logq.dtype)
    acc = torch.zeros(mask.shape[0], dtype=logq.dtype, device=logq.device)
    for j in range(mask.shape[-1]):
        acc = acc + (mf[:, j] * logq[j] + (1.0 - mf[:, j]) * log1mq[j])
    return acc


def _mode_jump_swept(jump_u, jump_acc, st: SweepState, logp_cur,
                     prior: SpikeSlabPrior, df, qprobs, record=None):
    """The independence mode-jump move on the SWEEP state (reference
    :178): propose g' ~ prod Bernoulli(qprobs) from the uniforms
    ``jump_u`` [C, p], walk from g to g' one flip at a time over the
    differing coordinates in ascending order (at most MODE_JUMP_BUDGET of
    them; more is rejected), and accept with the collapsed posterior odds
    at the uniform ``jump_acc`` [C]. A rejected chain keeps its state as it
    was: the walk runs on new tensors."""
    c, p = st.mask.shape
    prop = jump_u < qprobs
    diff = prop != st.mask
    n_diff = diff.sum(-1)
    budget = min(MODE_JUMP_BUDGET, p)
    # the differing coordinates first, each group in ascending order (as
    # lax.top_k on the diff mask orders them)
    order = torch.sort((~diff).to(torch.int8), dim=-1,
                       stable=True).indices[:, :budget]
    walk, logp_prop = st, logp_cur
    for step in range(budget):
        j = order[:, step]
        fd = _flip_deltas(walk, prior, j)
        logp_flip = _logp_flip(walk, fd, df)
        do = step < n_diff
        walk = _gated_apply_flip(walk, j, do, fd)
        logp_prop = torch.where(do, logp_flip, logp_prop)
    if prior.max_size is not None:
        logp_prop = torch.where(walk.size > prior.max_size, -torch.inf,
                                logp_prop)
    logq, log1mq = torch.log(qprobs), torch.log1p(-qprobs)
    log_ratio = (logp_prop - logp_cur + _log_q(st.mask, logq, log1mq)
                 - _log_q(prop, logq, log1mq))
    take = (n_diff <= budget) & (n_diff > 0) & (torch.log(jump_acc)
                                                < log_ratio)
    if record is not None:
        record.append((torch.log(jump_acc) - log_ratio,
                       torch.where(take[:, None], walk.mask, st.mask)))
    out = SweepState(*(torch.where(
        take.reshape(-1, *([1] * (a.dim() - 1))), a, b)
        for a, b in zip(walk, st)))
    return out, torch.where(take, logp_prop, logp_cur)


def flip_count(p, max_flips=None, qprobs=None):
    """Flips a sweep makes: ``max_flips``, or with the mode jump
    ``max(p - MODE_JUMP_BUDGET, 1)``, the jump replacing its budget's worth
    of single flips (reference :259-272), else p."""
    if max_flips is not None:
        return min(int(max_flips), p)
    if qprobs is not None:
        return max(p - MODE_JUMP_BUDGET, 1)
    return p


def draw_indicators_swept(noise, suf: RegSuf, prior: SpikeSlabPrior, mask,
                          max_flips=None, qprobs=None, record=None):
    """One random-order Gibbs sweep over every chain's indicators mask
    [C, p] on the SWEEP state (reference :241), preceded by the mode jump
    when ``qprobs`` is given, :func:`flip_count` flips long. ``record``, a
    list, receives (log u - log threshold [C], mask after
    the step) for the jump (if any) and each flip: the margin of every
    decision, for checks that compare two implementations. Returns the new
    mask."""
    p = mask.shape[-1]
    df = suf.n + prior.sigma_df
    n_flips = flip_count(p, max_flips, qprobs)
    st = build_sweep_state(suf, prior, mask)
    logp_cur = _log_model_prob(st, df)
    if qprobs is not None:
        st, logp_cur = _mode_jump_swept(noise["jump_u"], noise["jump_acc"],
                                        st, logp_cur, prior, df, qprobs,
                                        record)
    for f in range(n_flips):
        j = noise["perm"][:, f]
        fd = _flip_deltas(st, prior, j)
        logp_flip = _logp_flip(st, fd, df, prior.max_size)
        log_u = torch.log(noise["flip_u"][:, f])
        threshold = log_sigmoid(logp_flip - logp_cur)
        take = log_u < threshold
        st = _gated_apply_flip(st, j, take, fd)
        logp_cur = torch.where(take, logp_flip, logp_cur)
        if record is not None:
            record.append((log_u - threshold, st.mask))
    return st.mask


"""Scalar slice sampler with fixed trip counts (port of
boom_tpu/inference/kernels/slice.py:21-81, ``slice_step``).

Stepping out is bounded by ``expand_iters`` fixed-width steps and shrinkage
by the number of shrink uniforms; an unconverged lane keeps its current
point, which leaves the target invariant. Every lane (chain) is an
independent coordinate. Each loop stops once no lane can change (no lane
grew; every lane is done), reading one flag on the host a round: the
reference's fixed trip counts run the remaining rounds to the same result
(a lane that stopped growing evaluates the same endpoint again, a lane that
is done changes nothing). The reference splits its key into the slice
height, the interval offset and one uniform per shrink step; here those
uniforms are arguments.
"""

from __future__ import annotations

from typing import Callable

import torch


def slice_step(x: torch.Tensor, log_target: Callable, width, h_u, u_u,
               shrink_u, *, expand_iters: int = 16, lower=-float("inf"),
               upper=float("inf")):
    """One scalar slice update, elementwise over ``x``.

    h_u: uniforms in (0, 1] for the slice height (``x.shape``);
    u_u: uniforms in [0, 1) placing the initial interval (``x.shape``);
    shrink_u: uniforms ``[*x.shape, shrink_iters]``, one per shrink step.
    """
    logy = log_target(x) + torch.log(h_u)

    # initial interval around x
    left = torch.clamp(x - width * u_u, min=lower)
    right = torch.clamp(left + width, max=upper)

    # stepping out (Neal 2003, fixed step = width)
    for _ in range(expand_iters):
        grow_l = (log_target(left) > logy) & (left > lower)
        grow_r = (log_target(right) > logy) & (right < upper)
        if not bool((grow_l | grow_r).any()):
            break
        left = torch.where(grow_l, torch.clamp(left - width, min=lower),
                           left)
        right = torch.where(grow_r, torch.clamp(right + width, max=upper),
                            right)

    # shrinkage: sample in [left, right], shrink toward x on rejection
    cur = x
    done = torch.zeros_like(x, dtype=torch.bool)
    for k in range(shrink_u.shape[-1]):
        prop = left + shrink_u[..., k] * (right - left)
        ok = log_target(prop) > logy
        cur = torch.where(ok & ~done, prop, cur)
        done = done | ok
        if bool(done.all()):
            break
        left = torch.where(~done & (prop < x), prop, left)
        right = torch.where(~done & (prop >= x), prop, right)
    return cur

"""Scalar-observation state-space system (port of the ``SsmParams`` part of
boom_tpu/statespace/kalman.py:67-118).

Model:

    y_t     = Z' alpha_t + eps_t,        eps_t ~ N(0, H)
    alpha_1 = a0 + P0^{1/2} xi
    alpha_{t+1} = T alpha_t + R eta_t,   eta_t ~ N(0, Q)

The port carries the chain axis explicitly: every field has a leading
``[C]`` dimension. Only static systems are ported so far; the sequential
Kalman filter and smoother of the reference module are later work
(ROADMAP.md, "kernel (b)").
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SsmParams(NamedTuple):
    """Batched static system; every field has a leading chain axis."""

    z: torch.Tensor  # [C, d] observation vector
    t_mat: torch.Tensor  # [C, d, d] transition
    r_mat: torch.Tensor  # [C, d, q] error expander
    q_mat: torch.Tensor  # [C, q, q] state error covariance
    h: torch.Tensor  # [C] observation variance
    a0: torch.Tensor  # [C, d] initial state mean
    p0: torch.Tensor  # [C, d, d] initial state covariance

    @property
    def rqr(self):
        """[C, d, d] state error covariance R Q R'."""
        return self.r_mat @ self.q_mat @ self.r_mat.transpose(-1, -2)

    @property
    def time_varying(self):
        """Always False: the port's system is static (z [C, d], h [C])."""
        return False

    def zs(self, t_len):
        """[C, T, d] observation vectors."""
        return self.z[:, None, :].expand(-1, t_len, -1)

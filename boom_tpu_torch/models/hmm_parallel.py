"""The HMM forward filter as an associative scan (port of
boom_tpu/models/hmm_parallel.py:29-67, ``parallel_forward_filter``).

The forward message at t is a prefix product of the per-step matrices
M_t[i, j] = P(z_t = j | z_{t-1} = i) p(y_t | z_t = j), carried in
probability space with an accumulated log scale (each combine renormalises
by its largest element). Plain batched PyTorch: a Hillis-Steele scan, each
of its ceil(log2 T) levels one batched [C, T, S, S] product, tens of
launches in all (a combine in ``csrc/parallel_scan.cu`` is ROADMAP.md
queue 2). ``GaussianHmm(parallel_filter=True)`` takes it in place of H1.
"""

from __future__ import annotations

import torch


def _combine(mat_a, log_a, mat_b, log_b):
    """(A, a) then (B, b): (A B / m, a + b + log m), m = max(A B)."""
    prod = mat_a @ mat_b
    norm = torch.clamp_min(prod.amax(dim=(-2, -1), keepdim=True), 1e-300)
    return prod / norm, log_a + log_b + torch.log(norm[..., 0, 0])


def parallel_forward_filter(log_lik, log_trans, log_init):
    """hmm.forward_filter's (log_alphas [C, T, S], loglike [C]) from log_lik
    [C, T, S], log_trans [C, S, S], log_init [C, S], up to rounding."""
    c, t_len, s = log_lik.shape
    # element 0: every row the unnormalised alpha_0, so every prefix
    # product's rows are the filtered message at t
    la0 = log_init + log_lik[:, 0]
    m0 = la0[:, None, :].expand(c, s, s)
    rest = log_trans[:, None] + log_lik[:, 1:, None, :]  # [C, T-1, S, S]
    log_mats = torch.cat([m0[:, None], rest], dim=1)
    shift = log_mats.amax(dim=(-2, -1), keepdim=True)
    mats = torch.exp(log_mats - shift)
    scales = shift[..., 0, 0]
    step = 1
    while step < t_len:
        mat, scale = _combine(mats[:, :-step], scales[:, :-step],
                              mats[:, step:], scales[:, step:])
        mats = torch.cat([mats[:, :step], mat], dim=1)
        scales = torch.cat([scales[:, :step], scale], dim=1)
        step *= 2
    row = mats[:, :, 0, :]  # [C, T, S]
    row_norm = row.sum(-1, keepdim=True)
    log_alpha = torch.log(torch.clamp_min(row / row_norm, 1e-300))
    loglike = scales[:, -1] + torch.log(row_norm[:, -1, 0])
    return log_alpha, loglike

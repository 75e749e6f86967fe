"""Batched SWEEP operator (port of boom_tpu/linalg/sweep.py:19-126).

Sweeping index k of an SPD matrix conditions a Gaussian on coordinate k;
sweeping a subset yields regression coefficients and conditional variances.
Matrices are ``a [..., d, d]`` with any leading batch dims. The index ``k``
is a Python int or an integer tensor of the batch shape: a **per-chain**
index, read and written with ``gather``/``scatter`` where the reference
vmaps a ``dynamic_slice``.

The rank-1 body keeps the reference's arithmetic in its order
(``a - (a[:, k] / p) a[k, :]`` as ``a - (col * inv) * row``; row and column
k scaled by ``sign * inv``; the corner ``-inv``), so results agree to
rounding. One difference: where the gate of :func:`gated_flip_sweep` is off,
the port passes the matrix through even when the pivot is 0; the
reference's folded gate computes ``0 * inf`` there and gives NaN
(ROADMAP.md §3).
"""

from __future__ import annotations

import torch


def _batch_index(a, k):
    """``k`` as an int64 tensor of a's batch shape, on a's device."""
    batch = a.shape[:-2]
    k = torch.as_tensor(k, dtype=torch.int64, device=a.device)
    return k.expand(batch)


def _flag(a, x):
    """A boolean flag (Python bool or tensor) broadcast to a's batch."""
    return torch.as_tensor(x, dtype=torch.bool, device=a.device).expand(
        a.shape[:-2])


def gated_flip_sweep(a, k, currently_swept, gate):
    """Sweep index ``k`` of ``a`` where ``currently_swept`` is False,
    unsweep it where True, and pass ``a`` through unchanged where ``gate``
    is False (each flag per batch entry; reference ``gated_flip_sweep``,
    sweep.py:76)."""
    d = a.shape[-1]
    k = _batch_index(a, k)
    gate = _flag(a, gate)
    sign = torch.where(_flag(a, currently_swept), -1.0, 1.0).to(a.dtype)
    kc = k[..., None, None]
    col = a.gather(-1, kc.expand(*a.shape[:-1], 1))  # [..., d, 1]
    row = a.gather(-2, kc.expand(*a.shape[:-2], 1, d))  # [..., 1, d]
    pivot = col.gather(-2, kc)  # [..., 1, 1]
    # the guard: a gated-off lane never divides by its pivot
    inv = 1.0 / torch.where(gate[..., None, None], pivot, 1.0)
    out = a - (col * inv) * row
    edge = sign[..., None, None] * inv
    out = out.scatter(-2, kc.expand(*a.shape[:-2], 1, d), row * edge)
    out = out.scatter(-1, kc.expand(*a.shape[:-1], 1), col * edge)
    # the corner, out[..., k, k] = -inv, in the flattened matrix
    out = out.reshape(*a.shape[:-2], d * d).scatter(
        -1, kc[..., 0] * (d + 1), -inv[..., 0]).reshape(a.shape)
    return torch.where(gate[..., None, None], out, a)


def flip_sweep(a, k, currently_swept):
    """sweep(a, k) where ``currently_swept`` is False, unsweep(a, k) where
    True (reference sweep.py:61)."""
    return gated_flip_sweep(a, k, currently_swept, True)


def sweep(a, k):
    """Sweep index k of the SPD matrix a (reference sweep.py:47)."""
    return gated_flip_sweep(a, k, False, True)


def unsweep(a, k):
    """Inverse of sweep(a, k) (reference sweep.py:57)."""
    return gated_flip_sweep(a, k, True, True)


def sweep_subset(a, mask):
    """Sweep every index where ``mask [..., d]`` is True, in index order
    (reference sweep.py:113)."""
    for j in range(a.shape[-1]):
        a = gated_flip_sweep(a, j, False, mask[..., j])
    return a

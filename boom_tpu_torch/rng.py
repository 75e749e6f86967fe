"""Generator helpers (port of boom_tpu/rng.py).

JAX threads explicit keys and splits them per chain; the port threads one
explicit ``torch.Generator`` living on the run's device and draws every
chain's noise in one batched call with a leading chain axis ``[C, ...]``.
Samplers never touch a generator themselves: they take their uniforms and
normals as tensors, so a test can feed the port the very numbers the JAX
reference drew from its key tree.

A noise *spec* is a nested mapping ``name -> (shape, kind)`` (or a further
mapping), where ``shape`` is the per-chain shape and ``kind`` one of
``"normal"``, ``"uniform"`` (U[0, 1)), ``"uniform_pos"`` (U(0, 1),
clamped to ``finfo(dtype).tiny`` like the reference's ``minval=tiny``
uniforms that feed a log) and ``"permutation"`` (a uniformly random
permutation of ``range(shape[-1])``, int64). :func:`draw` fills a spec.
"""

from __future__ import annotations

import torch


def generator(seed: int, device="cuda") -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (``rng.key`` analog).
    ``device`` is the CUDA card unless the caller asks for ``"cpu"``; a
    CUDA device on a machine without one raises."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        int(seed))


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device where there is none
    raises instead of falling back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{device} was asked for (the default of the port's entry "
            "points) and no CUDA device is available; pass device='cpu' to "
            "run on the CPU")
    return device


def draw(gen: torch.Generator, spec, num_chains: int, dtype):
    """Fill a noise spec: every leaf becomes a ``[num_chains, *shape]``
    tensor on the generator's device."""
    out = {}
    for name, leaf in spec.items():
        if isinstance(leaf, dict):
            out[name] = draw(gen, leaf, num_chains, dtype)
            continue
        shape, kind = leaf
        full = (num_chains, *shape)
        if kind == "normal":
            out[name] = torch.randn(full, generator=gen, device=gen.device,
                                    dtype=dtype)
        elif kind in ("uniform", "uniform_pos"):
            u = torch.rand(full, generator=gen, device=gen.device,
                           dtype=dtype)
            if kind == "uniform_pos":
                u = u.clamp_min(torch.finfo(dtype).tiny)
            out[name] = u
        elif kind == "permutation":
            # the argsort of float64 uniforms: float32 keys tie about once
            # in 6,000 chain-sweeps at 50 entries
            keys = torch.rand(full, generator=gen, device=gen.device,
                              dtype=torch.float64)
            out[name] = torch.argsort(keys, dim=-1)
        else:
            raise ValueError(f"unknown noise kind {kind!r} for {name!r}")
    return out

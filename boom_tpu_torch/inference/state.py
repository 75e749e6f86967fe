"""Sequential kernel composition (port of ``compose`` in
boom_tpu/inference/state.py:28).

A port kernel is ``sweep(noise, state) -> state`` whose random numbers come
in as tensors (``boom_tpu_torch.rng``). The reference splits one key a
sweep into a key a kernel; here the composed sweep's noise holds one entry
a kernel, keyed by its position ("0", "1", ...), which :func:`compose_spec`
makes from the kernels' own specs so that ``rng.draw`` fills them all at
once.
"""

from __future__ import annotations

from typing import Any, Callable

Kernel = Callable[[Any, Any], Any]


def compose(*kernels: Kernel) -> Kernel:
    """One Gibbs sweep: each kernel in turn on its own noise (reference
    PriorPolicy::sample_posterior's loop over its samplers)."""

    def sweep(noise, state):
        for i, kern in enumerate(kernels):
            state = kern(noise[str(i)], state)
        return state

    return sweep


def compose_spec(*specs) -> dict:
    """The noise spec of ``compose(k0, k1, ...)`` from the kernels' own."""
    return {str(i): spec for i, spec in enumerate(specs)}

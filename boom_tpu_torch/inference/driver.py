"""Multi-chain MCMC driver (port of boom_tpu/inference/driver.py:22-122).

The reference vmaps one chain over chain keys and scans the kernel inside
one jitted program. Here every state tensor already carries the chain axis
``[C, ...]``, so one Python loop of sweeps advances all chains at once.
A kernel is ``sweep(noise, state) -> state``; ``draw_noise(generator,
num_chains)`` makes each sweep's random numbers from one explicit
``torch.Generator``. Draws are recorded chain-major, ``[C, N, ...]``. A
kernel may carry a ``finish()`` that the run calls at its end (a check of
errors the kernel kept on the device).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over nested dicts of tensors."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


@dataclasses.dataclass
class McmcResult:
    """Posterior draws plus bookkeeping.

    draws: nested dict of tensors with leading dims [num_chains, num_draws].
    final_state: nested dict with leading dim [num_chains].
    """

    draws: Any
    final_state: Any

    def stacked(self):
        """Draws flattened over chains, chain-major: [num_chains *
        num_draws, ...] (reference driver.py:37)."""
        return tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])),
                        self.draws)


def run_chain(kernel: Callable, draw_noise: Callable, state, num_draws: int,
              generator: torch.Generator, *, burn: int = 0, thin: int = 1,
              extract: Callable | None = None):
    """Advance the chains ``burn`` sweeps, then record ``extract(state)``
    every ``thin`` sweeps, ``num_draws`` times. Returns (draws, final)."""
    extract = extract or (lambda s: s)
    num_chains = _num_chains(state)

    def step(s):
        return kernel(draw_noise(generator, num_chains), s)

    for _ in range(burn):
        state = step(state)
    kept = []
    for _ in range(num_draws):
        for _ in range(thin):
            state = step(state)
        kept.append(extract(state))
    draws = tree_map(lambda *xs: torch.stack(xs, dim=1), *kept)
    # a kernel's end-of-run check (errors it kept on the device, so that
    # no sweep waits on the host)
    finish = getattr(kernel, "finish", None)
    if finish is not None:
        finish()
    return draws, state


def run_mcmc(kernel: Callable, draw_noise: Callable, init_states,
             num_draws: int, *, generator: torch.Generator,
             num_chains: int | None = None, burn: int = 0, thin: int = 1,
             extract: Callable | None = None) -> McmcResult:
    """Run ``num_chains`` chains of ``kernel``.

    init_states: a nested dict whose tensors have leading dim
    [num_chains], or a callable ``(generator, num_chains) -> state``.
    """
    if callable(init_states):
        if num_chains is None:
            raise ValueError("num_chains is required with an init function")
        init_states = init_states(generator, num_chains)
    draws, final_state = run_chain(kernel, draw_noise, init_states,
                                   num_draws, generator, burn=burn,
                                   thin=thin, extract=extract)
    return McmcResult(draws=draws, final_state=final_state)


def first_leaf(tree):
    """The first tensor of nested dicts, depth first (an empty dict, a
    block without parameters, holds none)."""
    if not isinstance(tree, dict):
        return tree
    for sub in tree.values():
        leaf = first_leaf(sub)
        if leaf is not None:
            return leaf
    return None


def _num_chains(state):
    return first_leaf(state).shape[0]

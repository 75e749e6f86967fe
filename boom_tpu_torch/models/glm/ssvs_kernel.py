"""The SSVS indicator sweep through kernel (a), ``csrc/ssvs_sweep.cu``: one
launch builds every chain's swept state, runs the mode-jump walk and the
random-order Gibbs flips, and writes the new masks (one CUDA block a chain,
the state in shared memory).

The reference runs this as XLA ``lax.scan``s over rank-1 SWEEP updates
(boom_tpu/models/glm/regression_sweep.py); in eager PyTorch each flip would
be ~20 small launches.

With per-chain statistics (X'y [C, p], y'y [C]: bsts, where each chain
regresses its own y - Z alpha) the kernel is given each chain's border of
S0 (``regression_sweep.border``), which it reads in place of S0's own; its
launches count under ``"ssvs_sweep_border"``.

Dispatch is by the device of the mask, as in ``statespace/kalman_kernel.py``:
a CUDA tensor launches the kernel (or raises; there is no fallback), a CPU
tensor runs the plain version ``regression_sweep.draw_indicators_swept``.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from boom_tpu_torch.kernels import _build
from boom_tpu_torch.models.glm import regression_sweep
from boom_tpu_torch.models.glm.regression import RegSuf, SpikeSlabPrior
from boom_tpu_torch.statespace.scan_kernel import _on_card

# kernel launches since the process started (or a caller's reset)
LAUNCHES = {"ssvs_sweep": 0, "ssvs_sweep_border": 0}
_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
# threads of a block (one chain), a warp a row of the rank-1 update: 128
# took 0.1907 ms at the bench shape in float32 against 0.2074 at 256 and
# 0.2652 at 64 (NVIDIA H100 80GB HBM3, 700 W; kernels/ssvs_timing.py)
THREADS = 128
# a block's shared memory at most (an H100's 227 KB)
MAX_SHARED_BYTES = 232448


def shared_bytes(p, jump, itemsize):
    """A block's shared memory (ssvs_sweep.cu, ssvs_smem_bytes): S and
    Omega (twice with the mode jump), their staging rows and columns, the
    flips' log uniforms and the jump's, the log inclusion odds, the walk's
    order and the flags, three masks and the flips' indices."""
    d = p + 1
    mats = (d * d + p * p) * (2 if jump else 1)
    return (mats + 2 * d + 4 * p + 1) * itemsize + 4 * (16 + 4) + 4 * p


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def draw_indicators_swept(noise, suf: RegSuf, prior: SpikeSlabPrior, mask,
                          max_flips=None, qprobs=None, operands=None):
    """One sweep of every chain's mask [C, p] (kernel (a) on a CUDA tensor,
    ``regression_sweep.draw_indicators_swept`` on a CPU tensor).
    ``operands``: :func:`sweep_operands` of the model, made once by the
    caller (else here, at every call)."""
    if not _on_card(mask):
        return regression_sweep.draw_indicators_swept(
            noise, suf, prior, mask, max_flips, qprobs)
    n_flips = regression_sweep.flip_count(mask.shape[-1], max_flips, qprobs)
    return launch_sweep(noise, suf, prior, mask, n_flips, qprobs, operands)


def sweep_operands(suf: RegSuf, prior: SpikeSlabPrior, qprobs=None):
    """The kernel's per-model operands, checked and contiguous: {name:
    tensor or None}. S0 is ``regression_sweep._augmented``; a zero prior
    mean is passed as None (no q terms). With per-chain statistics (X'y
    [C, p]) the kernel reads S0's border a chain from ``launch_sweep``, and
    the border S0 carries here (chain 0's) is not read: these operands need
    only X'X and n, and serve every sweep of a model."""
    dtype = prior.mean.dtype
    if dtype not in _DTYPE_TAG:
        raise TypeError(f"kernel (a) runs float32 or float64, not {dtype}")
    if suf.xty.dim() == 2:
        suf = suf._replace(xty=suf.xty[0], yty=suf.yty[0])
    ops = {"s0": regression_sweep._augmented(suf, prior),
           "omega": prior.unscaled_precision,
           "mean": prior.mean if bool((prior.mean != 0).any()) else None,
           "log_odds": prior.log_inclusion_odds,
           "consts": torch.stack([prior.log_inclusion_norm.reshape(()),
                                  (suf.n + prior.sigma_df).reshape(())]),
           "logq": None if qprobs is None else torch.log(qprobs),
           "log1mq": None if qprobs is None else torch.log1p(-qprobs),
           "qprobs": qprobs}
    out = {}
    for name, x in ops.items():
        if x is not None:
            if x.dtype != dtype or x.device != prior.mean.device:
                raise TypeError(f"{name} is {x.dtype} on {x.device}; the "
                                f"prior is {dtype} on {prior.mean.device}")
            x = x.contiguous()
        out[name] = x
    return out


def launch_sweep(noise, suf, prior, mask, n_flips, qprobs=None,
                 operands=None):
    """Kernel (a): ``n_flips`` flips of every chain after the build (and the
    mode jump with ``qprobs``); returns the new mask [C, p] bool. With
    per-chain statistics (X'y [C, p], y'y [C]) the per-chain entry reads
    each chain's border of S0, ``regression_sweep.border`` [C, p+1]."""
    ops = operands or sweep_operands(suf, prior, qprobs)
    dtype, device = prior.mean.dtype, mask.device
    c, p = mask.shape
    jump = ops["qprobs"] is not None
    need = shared_bytes(p, jump, torch.finfo(dtype).bits // 8)
    if need > MAX_SHARED_BYTES:
        raise NotImplementedError(
            f"kernel (a) holds a chain's state in shared memory: p={p} "
            f"needs {need} bytes in {dtype}{' with the mode jump' * jump}, "
            f"more than a block's {MAX_SHARED_BYTES}")
    if not 0 <= n_flips <= p:
        raise ValueError(f"n_flips {n_flips} is not in [0, {p}]")
    want = {"perm": (c, p), "flip_u": (c, p)}
    if jump:
        want.update(jump_u=(c, p), jump_acc=(c,))
    per_chain = {}
    for name, shape in want.items():
        x = noise[name]
        if tuple(x.shape) != shape or x.device != device:
            raise ValueError(f"noise {name} must be {shape} on {device}; got "
                             f"{tuple(x.shape)} on {x.device}")
        if name == "perm":
            x = x.to(torch.int64)
        elif x.dtype != dtype:
            raise TypeError(f"noise {name} is {x.dtype}, not {dtype}")
        per_chain[name] = x.contiguous()
    # a bool tensor is bytes of 0 and 1: the kernel reads and writes the
    # masks as they are, with no conversion launched
    mask_in = mask.bool().contiguous().view(torch.uint8)
    mask_out = torch.empty((c, p), dtype=torch.bool, device=device)

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    args = [ptr(ops[k]) for k in ("s0", "omega", "mean", "log_odds",
                                  "consts", "logq", "log1mq", "qprobs")]
    args += [mask_in.data_ptr(), per_chain["perm"].data_ptr(),
             per_chain["flip_u"].data_ptr(), ptr(per_chain.get("jump_u")),
             ptr(per_chain.get("jump_acc")), mask_out.data_ptr()]
    kind, edge = "ssvs_sweep", None
    if suf.xty.dim() == 2:
        kind = "ssvs_sweep_border"
        edge = regression_sweep.border(suf, prior)
        if tuple(edge.shape) != (c, p + 1) or edge.dtype != dtype:
            raise ValueError(f"per-chain statistics must give a border "
                             f"[{c}, {p + 1}] in {dtype}; got "
                             f"{tuple(edge.shape)} {edge.dtype}")
        edge = edge.contiguous()
    args.append(ptr(edge))
    fn = getattr(_build.library("ssvs_sweep"),
                 f"boom_ssvs_sweep_{_DTYPE_TAG[dtype]}")
    rc = fn(*args, c, p, int(n_flips),
            -1 if prior.max_size is None else int(prior.max_size), THREADS,
            _stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return mask_out

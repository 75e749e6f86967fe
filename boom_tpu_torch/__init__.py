"""boom_tpu_torch: the PyTorch/CUDA port of boom_tpu.

Module paths mirror ``boom_tpu/`` so each module's reference is easy to
find (``boom_tpu_torch/statespace/bsts.py`` ports
``boom_tpu/statespace/bsts.py``). The JAX package is the reference the port
is tested against; this package imports ``torch`` and never ``jax``.

Conventions that replace JAX idiom:

* chains are an explicit leading tensor axis ``[C, ...]`` on every state
  tensor and on every ``SsmParams`` field (JAX vmaps over chains);
* every function takes its ``device`` and ``dtype`` from its tensor
  arguments, and samplers take their random numbers as tensors (a
  ``noise`` mapping) drawn from an explicit ``torch.Generator``;
* dtype policy: float64 on the CPU (parity tests against the reference),
  float32 on the card;
* the hand-written CUDA kernels (``csrc/``) are built from source at first
  use into ``build/boom_tpu_torch/`` (``kernels/_build.py``). A CPU tensor
  runs each kernel's plain PyTorch version instead.
"""

__version__ = "0.1.0"

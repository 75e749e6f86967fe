"""Regression models (port of boom_tpu/models/glm): the Gaussian
spike-and-slab regression so far."""

from boom_tpu_torch.models.glm.regression import (
    RegSuf,
    SpikeSlabPrior,
    SpikeSlabRegression,
)

__all__ = ["RegSuf", "SpikeSlabPrior", "SpikeSlabRegression"]

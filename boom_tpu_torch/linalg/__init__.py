"""Linear algebra of the spike-and-slab path (port of boom_tpu/linalg)."""

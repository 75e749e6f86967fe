"""The committed data of BASELINE configs #1, #3 and #4
(``boom_tpu_torch/data/{beta_binomial,mixture,hmm}.npz``) are remade here
with the reference's own simulators on the CPU, x64 on, from the keys and
truths of the reference's tests, and compared exactly.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_baseline_data.py

writes the files.
"""

import jax
import numpy as np
import pytest

from boom_tpu.models import BetaBinomialModel
from boom_tpu.models.hmm import GaussianHmm
from boom_tpu.models.mixtures import GaussianMixtureModel
from boom_tpu_torch import data


def hmm_data():
    t = data.HMM_TRUTH
    with jax.enable_x64(True):
        y, z = GaussianHmm.simulate(jax.random.key(0), 1200, t["trans"],
                                    t["mu"], t["sd"])
        return {"y": np.asarray(y), "z": np.asarray(z)}


def mixture_data():
    t = data.MIXTURE_TRUTH
    with jax.enable_x64(True):
        y, z = GaussianMixtureModel.simulate(jax.random.key(0), 1500,
                                             t["weights"], t["mu"], t["sd"])
        return {"y": np.asarray(y), "z": np.asarray(z)}


def beta_binomial_data():
    t = data.BETA_BINOMIAL_TRUTH
    with jax.enable_x64(True):
        k_sim, _k_run = jax.random.split(jax.random.key(42))
        n, y = BetaBinomialModel.simulate(k_sim, t["groups"], t["trials"],
                                          t["a"], t["b"])
        return {"n": np.asarray(n, np.float64), "y": np.asarray(y, np.float64)}


RECIPES = {"hmm": (hmm_data, data.hmm, data.HMM),
           "mixture": (mixture_data, data.mixture, data.MIXTURE),
           "beta_binomial": (beta_binomial_data, data.beta_binomial,
                             data.BETA_BINOMIAL)}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_committed_data_are_the_recipe(name):
    make, load, _path = RECIPES[name]
    want, got = make(), load()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


if __name__ == "__main__":
    for name, (make, _load, path) in RECIPES.items():
        np.savez(path, **make())
        print(f"wrote {path}")

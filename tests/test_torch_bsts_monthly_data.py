"""The committed data of the bsts_monthly and bsts_ar_trig configurations
(``boom_tpu_torch/data/bsts_monthly.npz``, ``bsts_ar_trig.npz``) against
their recipes, ``data.make_bsts_monthly`` and ``data.make_bsts_ar_trig``
(numpy alone).

    PYTHONPATH=. python tests/test_torch_bsts_monthly_data.py

writes both files.
"""

import datetime
import sys

import numpy as np
import pytest

from boom_tpu_torch import data

RECIPES = {"bsts_monthly": (data.make_bsts_monthly, data.bsts_monthly,
                            data.BSTS_MONTHLY),
           "bsts_ar_trig": (data.make_bsts_ar_trig, data.bsts_ar_trig,
                            data.BSTS_AR_TRIG)}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_committed_data_is_its_recipe(name):
    make, load, _path = RECIPES[name]
    made, kept = make(), load()
    assert set(made) == set(kept)
    for key, arr in made.items():
        assert kept[key].dtype == arr.dtype, key
        np.testing.assert_array_equal(kept[key], arr, err_msg=key)


def test_bsts_monthly_follows_the_calendar():
    """730 days from 2022-01-01; each day's month is its calendar month,
    and the months' means keep the reference's effects' order (the noise
    and the level are small beside them)."""
    d = data.bsts_monthly()
    y, months = d["y"], d["months"]
    assert y.shape == (data.BSTS_MONTHLY_DAYS,) and np.isfinite(y).all()
    for t in (0, 30, 31, 58, 59, 364, 365, 729):
        day = data.BSTS_MONTHLY_FIRST + datetime.timedelta(days=t)
        assert months[t] == day.month - 1, t
    effect = np.asarray(data.MONTH_EFFECTS)
    means = np.asarray([y[months == m].mean() for m in range(12)])
    assert np.corrcoef(means, effect)[0, 1] > 0.9


def test_bsts_ar_trig_has_its_mean_cycle_and_ar():
    """520 weeks; the mean near 10; after the annual cycle's harmonics are
    regressed out, the lag-1 autocorrelation is the AR(2)'s, phi1 / (1 -
    phi2) = 0.75, shrunk by the noise's share of the variance (its
    variance 0.5^2 (1 - phi2) / ((1 + phi2) ((1 - phi2)^2 - phi1^2)) beside
    the noise's 0.3^2), within sampling error."""
    y = data.bsts_ar_trig()["y"].astype(np.float64)
    assert y.shape == (data.BSTS_AR_TRIG_WEEKS,) and np.isfinite(y).all()
    assert abs(y.mean() - 10.0) < 1.0
    lam = 2 * np.pi * np.arange(y.size) / data.BSTS_AR_TRIG_PERIOD
    x = np.stack([np.ones_like(lam), np.cos(lam), np.sin(lam),
                  np.cos(2 * lam), np.sin(2 * lam)], 1)
    resid = y - x @ np.linalg.lstsq(x, y, rcond=None)[0]
    rho = np.corrcoef(resid[1:], resid[:-1])[0, 1]
    phi1, phi2 = data.BSTS_AR_TRIG_PHI
    var = 0.25 * (1 - phi2) / ((1 + phi2) * ((1 - phi2) ** 2 - phi1 ** 2))
    assert abs(rho - phi1 / (1 - phi2) * var / (var + 0.09)) < 0.1


if __name__ == "__main__":
    for make, _load, path in RECIPES.values():
        np.savez(path, **make())
        print(path, file=sys.stderr)

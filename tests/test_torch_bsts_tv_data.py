"""The committed bsts_tv data (``boom_tpu_torch/data/bsts_tv.npz``)
against its recipe, ``data.make_bsts_tv`` (numpy alone).

    PYTHONPATH=. python tests/test_torch_bsts_tv_data.py

writes the file.
"""

import sys

import numpy as np

from boom_tpu_torch import data


def test_committed_bsts_tv_data_is_its_recipe():
    made, kept = data.make_bsts_tv(), data.bsts_tv()
    assert set(made) == set(kept)
    for name, arr in made.items():
        assert kept[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(kept[name], arr, err_msg=name)


def test_bsts_tv_data_has_gaps_duplicates_and_holidays():
    d = data.bsts_tv()
    ts = d["timestamps"]
    days, counts = np.unique(ts, return_counts=True)
    assert (ts[0], ts[-1]) == (0, data.BSTS_TV_GRID - 1)
    missing = data.BSTS_TV_GRID - days.size
    assert 0.03 * data.BSTS_TV_GRID < missing < 0.08 * data.BSTS_TV_GRID
    assert 0.005 * data.BSTS_TV_GRID < (counts == 2).sum() < 0.04 * data.BSTS_TV_GRID
    assert counts.max() == 2
    # a duplicated day repeats its design row
    dup = np.flatnonzero(np.diff(ts) == 0)
    np.testing.assert_array_equal(d["x"][dup], d["x"][dup + 1])
    grid = data.BSTS_TV_GRID + data.BSTS_TV_HORIZON
    assert d["x_dyn"].shape == (grid, 2) and d["active"].shape == (grid,)
    assert set(np.unique(d["active"])) == {-1, 0, 1, 2}
    assert d["x"].shape == (ts.size, data.BSTS_TV_P)
    assert d["x_future"].shape == (data.BSTS_TV_HORIZON, data.BSTS_TV_P)
    assert np.isfinite(d["y"]).all()


if __name__ == "__main__":
    np.savez(data.BSTS_TV, **data.make_bsts_tv())
    print(data.BSTS_TV, file=sys.stderr)

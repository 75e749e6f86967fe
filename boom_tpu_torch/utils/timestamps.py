"""Irregular and duplicated timestamps (port of
boom_tpu/utils/timestamps.py, the reference's RegularizeTimestamps of
bsts' format.timestamps.R): the raw observations are collapsed onto a
regular grid before the fit, so that every shape downstream is fixed.

* gaps become grid points with ``observed=False``;
* duplicated timestamps are averaged, exact for the Gaussian observation
  model with variance sigma^2 / n_t at the time point plus the
  within-time-point sum of squares in the variance's posterior
  (``Bsts.obs_weights``, ``Bsts.extra_obs_ss``).

Numbers only (numpy); nothing here touches a tensor. The reference snaps
calendar stamps of a month or coarser to a uniform grid of seconds
(timestamps.py:86), which misplaces them (months differ in length); the
port refuses datetime stamps whose smallest step is 28 days or more
(ROADMAP.md, sec. 3) until the calendar grids of ``utils/dates.py`` are
ported.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np

# a delta counts as a gap if >= 1.8x the smallest delta (the reference's
# floating-point-safe "twice", format.timestamps.R NoGaps)
_GAP_FACTOR = 1.8
# the smallest step of datetime stamps the uniform grid takes (seconds)
_CALENDAR_STEP = 28 * 86400.0


@dataclasses.dataclass(frozen=True)
class TimestampInfo:
    """The reference's TimestampInfo list as a frozen record."""

    timestamps_are_trivial: bool
    number_of_time_points: int
    regular_timestamps: np.ndarray  # [T_grid]
    timestamp_mapping: np.ndarray  # [n_obs] int grid index per raw obs


def no_duplicates(timestamps) -> bool:
    t = np.asarray(timestamps)
    return len(np.unique(t)) == len(t)


def no_gaps(timestamps) -> bool:
    t = np.unique(np.asarray(timestamps))
    if len(t) < 2:
        return True
    dt = np.diff(_as_float(t))
    return bool(np.all(dt < _GAP_FACTOR * dt.min()))


def is_regular(timestamps) -> bool:
    return no_duplicates(timestamps) and no_gaps(timestamps)


def _is_datetime(t):
    return np.issubdtype(t.dtype, np.datetime64) or t.dtype == object


def _as_float(t):
    """Numeric view of numeric / datetime64 / date-like timestamps (seconds
    for the dates)."""
    t = np.asarray(t)
    if np.issubdtype(t.dtype, np.datetime64):
        return t.astype("datetime64[s]").astype(np.float64)
    if t.dtype == object:  # python dates / datetimes
        return np.asarray([np.datetime64(x, "s") for x in t]
                          ).astype(np.float64)
    return t.astype(np.float64)


def regularize_timestamps(timestamps) -> TimestampInfo:
    """The smallest regular grid covering the raw timestamps, its step the
    smallest observed delta, and each raw observation's grid index
    (reference RegularizeTimestamps + zoo::MATCH). Raises
    NotImplementedError for datetime stamps a month or more apart."""
    raw = np.asarray(timestamps)
    tf = _as_float(raw)
    uniq = np.unique(tf)
    if len(uniq) < 2:
        grid = uniq
    else:
        step = np.diff(uniq).min()
        if _is_datetime(raw) and step >= _CALENDAR_STEP:
            raise NotImplementedError(
                "datetime timestamps a month or more apart need a calendar "
                "grid (months, quarters and years differ in length); the "
                "reference snaps them to a uniform grid, which the port "
                "does not copy (ROADMAP.md, sec. 3: a difference from the "
                "reference, not work for the port)")
        n = int(round((uniq[-1] - uniq[0]) / step)) + 1
        grid = uniq[0] + step * np.arange(n)
    # each raw timestamp to its nearest grid point
    idx = np.clip(np.searchsorted(grid, tf), 0, len(grid) - 1)
    left = np.clip(idx - 1, 0, len(grid) - 1)
    mapping = np.where(
        np.abs(grid[left] - tf) < np.abs(grid[idx] - tf), left, idx)
    if len(grid) > 2 * len(raw):
        warnings.warn("Expanding the time series to a regular interval "
                      "resulted in very large amounts of missing data.")
    return TimestampInfo(
        timestamps_are_trivial=is_regular(raw),
        number_of_time_points=len(grid),
        regular_timestamps=grid,
        timestamp_mapping=mapping.astype(np.int64),
    )


def collapse_to_grid(y, info: TimestampInfo, predictors=None):
    """Collapse raw observations onto the regular grid: a dict of y_grid
    [T] (a time point's mean, 0.0 at gaps), observed [T] bool, weights [T]
    (observation counts n_t), extra_ss (the within-time-point sum of
    squares lost by averaging, summed), extra_ss_t [T] (the same a time
    point) and, with predictors, predictors_grid [T, p] (a time point's
    mean row: exact where duplicates share a design row)."""
    y = np.asarray(y, np.float64)
    t_grid = info.number_of_time_points
    m = info.timestamp_mapping
    counts = np.bincount(m, minlength=t_grid).astype(np.float64)
    sums = np.bincount(m, weights=y, minlength=t_grid)
    observed = counts > 0
    means = np.where(observed, sums / np.maximum(counts, 1.0), 0.0)
    sq = np.bincount(m, weights=y * y, minlength=t_grid)
    per_point = sq - counts * means ** 2
    extra_ss = float(np.sum(per_point))
    out = {"y_grid": means, "observed": observed, "weights": counts,
           "extra_ss": max(extra_ss, 0.0),
           "extra_ss_t": np.maximum(per_point, 0.0)}
    if predictors is not None:
        x = np.asarray(predictors, np.float64)
        xg = np.zeros((t_grid, x.shape[1]))
        for j in range(x.shape[1]):
            xg[:, j] = np.bincount(m, weights=x[:, j], minlength=t_grid)
        xg = np.where(observed[:, None], xg
                      / np.maximum(counts[:, None], 1.0), 0.0)
        out["predictors_grid"] = xg
    return out

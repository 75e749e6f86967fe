"""The association order of the tiled CUDA scan, modelled in torch.

``csrc/parallel_scan.cu`` splits T into tiles of L steps scanned by NT
threads of K = L / NT consecutive steps each: the tiles' totals (kernel A),
an inclusive scan of each row's totals, L at a time (kernel B), then each
tile's scan from the scanned total of the tile before it (kernel C). Inside
a tile: a serial scan per thread, a Kogge-Stone scan of the thread totals,
then each thread's elements after its exclusive prefix. The combines are
associative but not commutative, so this order must keep the earlier
element first everywhere. The model below repeats the kernel's order with
the plain combines of ``parallel_kalman`` at small tiles, and must match
the plain Hillis-Steele scan in float64 to 1e-12.
"""

import numpy as np
import pytest
import torch

from boom_tpu_torch.convert import ssm_params_from_numpy
from boom_tpu_torch.statespace import parallel_kalman as pk

torch.set_num_threads(1)

TOL = 1e-12
CHAINS = 2


def _scan_tile(combine, items, k, pre, totals_only=False):
    """``scan_tile`` of the kernel on a list of elements (n <= L)."""
    items = list(items)
    n = len(items)
    n_threads = -(-n // k)
    for j in range(n_threads):  # 1. serial scan of each thread's K
        for i in range(j * k + 1, min((j + 1) * k, n)):
            items[i] = combine(items[i - 1], items[i])
    agg = [items[min((j + 1) * k, n) - 1] for j in range(n_threads)]
    s = 1
    while s < n_threads:  # 2. Kogge-Stone over the thread totals
        agg = [agg[j] if j < s else combine(agg[j - s], agg[j])
               for j in range(n_threads)]
        s *= 2
    if totals_only:
        return agg[-1]
    for j in range(n_threads):  # 3. each thread's exclusive prefix
        if j == 0 and pre is None:
            continue
        if j == 0:
            prefix = pre
        elif pre is None:
            prefix = agg[j - 1]
        else:
            prefix = combine(pre, agg[j - 1])
        for i in range(j * k, min((j + 1) * k, n)):
            items[i] = combine(prefix, items[i])
    return items


def tiled_scan(combine, elems, tile, threads, reverse=False):
    """Inclusive scan of a tuple of [B, T, ...] tensors along T in the
    kernel's order: kernels A, B and C, or C alone for one tile."""
    k = tile // threads
    t_len = elems[0].shape[1]
    seq = [tuple(e[:, t] for e in elems) for t in range(t_len)]
    if reverse:
        seq = seq[::-1]
    tiles = [seq[i:i + tile] for i in range(0, t_len, tile)]
    if len(tiles) == 1:
        out = _scan_tile(combine, tiles[0], k, None)
    else:
        totals = [_scan_tile(combine, t, k, None, totals_only=True)
                  for t in tiles]
        scanned = []
        for c0 in range(0, len(totals), tile):
            scanned += _scan_tile(combine, totals[c0:c0 + tile], k,
                                  scanned[-1] if scanned else None)
        out = []
        for i, t in enumerate(tiles):
            out += _scan_tile(combine, t, k, scanned[i - 1] if i else None)
    if reverse:
        out = out[::-1]
    return tuple(torch.stack([o[f] for o in out], dim=1)
                 for f in range(len(elems)))


def _systems(seed, d, q=2):
    rng = np.random.default_rng(seed)

    def one():
        raw = rng.normal(size=(d, d)) * 0.4
        lq = rng.normal(size=(q, q))
        mp = rng.normal(size=(d, d))
        return dict(
            z=rng.normal(size=d),
            t_mat=raw / max(1.0, 1.1 * np.max(np.abs(np.linalg.eigvals(raw)))),
            r_mat=rng.normal(size=(d, q)), q_mat=lq @ lq.T + 0.5 * np.eye(q),
            h=np.asarray(rng.uniform(0.3, 1.0)),
            a0=rng.normal(size=d), p0=mp @ mp.T + np.eye(d))

    systems = [one() for _ in range(CHAINS)]
    return ssm_params_from_numpy(
        {k: np.stack([s[k] for s in systems]) for k in systems[0]})


def _elements(name, t_len, d=2, q=2, seed=3):
    """Each combine's elements as its scan gets them from the smoother."""
    params = _systems(seed, d, q)
    rng = np.random.default_rng(seed)
    y = torch.tensor(rng.normal(size=(CHAINS, t_len)))
    if name == "filter":
        return pk._combine_filter, tuple(pk._filter_elements(params, y))
    if name == "smooth":
        fm, fp = pk.parallel_filter_moments(params, y)
        return pk._combine_smooth, pk._smooth_elements(params, fm, fp)
    normals = [torch.tensor(rng.normal(size=s))
               for s in ((CHAINS, d), (CHAINS, t_len - 1, q))]
    return pk._combine_affine, pk._simulate_elements(params, t_len,
                                                     *normals)


@pytest.mark.parametrize("tile,threads", [(8, 4), (4, 2)])
@pytest.mark.parametrize("t_rel", ["1", "tile-1", "tile", "tile+1",
                                   "3*tile+5"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", ["filter", "smooth", "affine"])
def test_tiled_order_matches_hillis_steele(name, reverse, t_rel, tile,
                                           threads):
    t_len = eval(t_rel, {"tile": tile})
    combine, elems = _elements(name, 3 * 8 + 5)
    elems = tuple(e[:, :t_len] for e in elems)
    got = tiled_scan(combine, elems, tile, threads, reverse=reverse)
    want = pk.hillis_steele(combine, elems, reverse=reverse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)

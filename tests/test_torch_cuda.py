"""The hand-written CUDA scan kernels against their plain PyTorch versions,
on the card. These need a CUDA device and ``nvcc``: here they skip. Run
them on a machine with the card (the repository's conftest imports JAX,
which that machine need not have):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from boom_tpu_torch.statespace import parallel_kalman as pk
from boom_tpu_torch.statespace import scan_kernel as sk
from boom_tpu_torch.statespace.kalman import SsmParams

pytestmark = pytest.mark.cuda

# normwise relative error, kernel vs plain: the two differ only in the
# association order of the scan
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _system(rng, c, d, dtype, device):
    def one():
        q, _ = np.linalg.qr(rng.normal(size=(d, d)))
        lq = 0.3 * rng.normal(size=(d, d))
        mp = rng.normal(size=(d, d))
        return dict(z=rng.normal(size=d),
                    t_mat=q @ np.diag(rng.uniform(0.5, 0.97, d)) @ q.T,
                    r_mat=np.eye(d), q_mat=lq @ lq.T + 0.1 * np.eye(d),
                    h=np.asarray(rng.uniform(0.3, 1.0)),
                    a0=rng.normal(size=d), p0=mp @ mp.T + np.eye(d))

    systems = [one() for _ in range(c)]
    return SsmParams(**{k: torch.tensor(np.stack([s[k] for s in systems]),
                                        dtype=dtype, device=device)
                        for k in systems[0]})


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _scans(params, y, normals, t_len):
    fm, fp = sk.filter_moments(params, y)
    sm = sk.smooth_means(params, fm, fp)
    al, _ = sk.simulate(params, t_len, *normals)
    return fm, fp, sm, al


def _check_scans(card, dtype, d, t_len, seed, c=3):
    """The three scans through the kernel (one count each in LAUNCHES)
    against their plain versions."""
    rng = np.random.default_rng(seed)
    params = _system(rng, c, d, dtype, card)
    y = torch.tensor(rng.normal(size=(c, t_len)), dtype=dtype, device=card)
    normals = [torch.tensor(rng.normal(size=s), dtype=dtype, device=card)
               for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
    before = dict(sk.LAUNCHES)
    fm, fp, sm, al = _scans(params, y, normals, t_len)
    torch.cuda.synchronize()
    assert {k: sk.LAUNCHES[k] - before[k] for k in before} == {
        "filter": 1, "smooth": 1, "affine": 1}
    fm0, fp0 = pk.parallel_filter_moments(params, y)
    for out, ref in ((fm, fm0), (fp, fp0),
                     (sm, pk.parallel_smooth_means(params, fm, fp)),
                     (al, pk.parallel_simulate(params, t_len, *normals)[0])):
        assert _rel(out, ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 5])
@pytest.mark.parametrize("t_len", [3, 300])
def test_scans_match_plain(card, dtype, d, t_len):
    _check_scans(card, dtype, d, t_len, seed=d * 1000 + t_len, c=4)


def test_wrapper_refuses_what_the_kernel_does_not_take(card):
    x = torch.zeros(2, 6, 10, device=card)
    with pytest.raises(ValueError, match="state dim"):
        sk.inclusive_scan("affine", 7, torch.zeros(2, 56, 10, device=card))
    with pytest.raises(ValueError, match="takes"):
        sk.inclusive_scan("filter", 2, x)
    with pytest.raises(ValueError, match="contiguous"):
        sk.inclusive_scan("affine", 2, x.transpose(0, 1).contiguous()
                          .transpose(0, 1))
    with pytest.raises(TypeError, match="dtype"):
        sk.inclusive_scan("affine", 2, x.half())


# tiles are 256 steps for small elements and 128 for large ones: one step
# below, at and above each, several tiles, and a ragged last tile
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("t_len", [127, 128, 129, 255, 256, 257, 773, 2053])
def test_scans_across_tiles_match_plain(card, dtype, t_len):
    _check_scans(card, dtype, 2, t_len, seed=t_len)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("t_len", [100, 389])
def test_scans_at_d6_match_plain(card, dtype, t_len):
    _check_scans(card, dtype, 6, t_len, seed=6000 + t_len)


def test_repeated_launches_are_bit_identical(card):
    rng = np.random.default_rng(11)
    c, d, t_len = 8, 2, 4096
    dtype = torch.float64
    params = _system(rng, c, d, dtype, card)
    y = torch.tensor(rng.normal(size=(c, t_len)), dtype=dtype, device=card)
    normals = [torch.tensor(rng.normal(size=s), dtype=dtype, device=card)
               for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
    first = _scans(params, y, normals, t_len)
    for _ in range(9):
        again = _scans(params, y, normals, t_len)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_one_scan_counts_one_launch(card):
    """A multi-tile scan makes three CUDA launches and counts one."""
    x = torch.randn(2, 6, 1000, dtype=torch.float64, device=card)
    before = dict(sk.LAUNCHES)
    sk.inclusive_scan("affine", 2, x)
    torch.cuda.synchronize()
    assert {k: sk.LAUNCHES[k] - before[k] for k in before} == {
        "filter": 0, "smooth": 0, "affine": 1}

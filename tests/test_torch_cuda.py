"""The hand-written CUDA kernels (the parallel scans, the sequential
Kalman loglik K1, its derivative kernels J1 and J2, the simulation
smoothers K2 and K2w, the ASIS D-path K3, and kernel (a), the SSVS
indicator sweep, with one S0 and with a border of S0 a chain) against
their plain PyTorch versions, on the card. These need
a CUDA device and ``nvcc``: here they skip. Run them on a machine with the
card (the repository's conftest imports JAX, which that machine need not
have):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace import kalman_kernel as kk
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


def _within(a, b, tol):
    """Normwise relative error at most tol (two all-zero sides agree)."""
    return float((a - b).norm()) <= tol * float(b.norm())


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


# -- the sequential Kalman kernels (csrc/kalman_seq.cu) ----------------------

def _kalman_inputs(card, dtype, d, t_len, seed, c=5, masked=False):
    rng = np.random.default_rng(seed)
    params = _system(rng, c, d, dtype, card)
    y = torch.tensor(rng.normal(size=t_len).cumsum(), dtype=dtype,
                     device=card)
    obs = (torch.tensor(rng.uniform(size=t_len) > 0.3, device=card)
           if masked else None)
    normals = [torch.tensor(rng.normal(size=s), dtype=dtype, device=card)
               for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
    return params, y, obs, normals


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("t_len", [2, 33, 500])
@pytest.mark.parametrize("masked", [False, True])
def test_kalman_kernels_match_plain(card, dtype, d, t_len, masked):
    """K1 (both dtypes) and K2 (float64) against the plain versions on the
    same inputs and normals."""
    params, y, obs, normals = _kalman_inputs(card, dtype, d, t_len,
                                             seed=d * 100 + t_len,
                                             masked=masked)
    before = dict(kk.LAUNCHES)
    ll = kk.kalman_loglik(params, y, obs)
    assert _within(ll, kalman.kalman_loglik(params, y, obs), TOL[dtype])
    if dtype == torch.float64:
        draw = kk.simulation_smoother(params, y, *normals, observed=obs)
        ref = kalman.simulation_smoother(params, y, *normals, observed=obs)
        assert _within(draw, ref, TOL[dtype])
    torch.cuda.synchronize()
    assert kk.LAUNCHES["loglik"] - before["loglik"] == 1
    assert kk.LAUNCHES["smoother"] - before["smoother"] == (
        dtype == torch.float64)


def _kalman_case_matches_plain(card, d, t_len, c, masked, seed):
    """K1 in both dtypes and K2 against the plain versions, one case."""
    for dtype in (torch.float64, torch.float32):
        params, y, obs, normals = _kalman_inputs(card, dtype, d, t_len,
                                                 seed=seed, c=c,
                                                 masked=masked)
        ll = kk.kalman_loglik(params, y, obs)
        assert _within(ll, kalman.kalman_loglik(params, y, obs), TOL[dtype])
        if dtype == torch.float64:
            draw = kk.simulation_smoother(params, y, *normals, observed=obs)
            ref = kalman.simulation_smoother(params, y, *normals,
                                             observed=obs)
            assert _within(draw, ref, TOL[dtype])
    torch.cuda.synchronize()


# K2 stages kk.SMOOTHER_CHUNK = 32 steps at a time and takes a warp of
# chains a block; K1 stages y 1024 steps at a time
@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("t_len", [31, 32, 33, 67, 1025, 4096])
@pytest.mark.parametrize("masked", [False, True])
def test_kalman_kernels_at_chunk_edges_match_plain(card, d, t_len, masked):
    _kalman_case_matches_plain(card, d, t_len, 7, masked,
                               seed=10 * t_len + d)


@pytest.mark.parametrize("c", [33, 4095])
@pytest.mark.parametrize("d", [1, 2, 3, 6])
@pytest.mark.parametrize("masked", [False, True])
def test_kalman_kernels_at_block_edges_match_plain(card, c, d, masked):
    """Chain counts that leave the last block (a warp for K2) partly
    empty."""
    _kalman_case_matches_plain(card, d, 67, c, masked, seed=c + d)


@pytest.mark.parametrize("d", [1, 2])
def test_loglik_derivatives_match_plain(card, d):
    """J1 (the gradient) and J2 (gradient and Hessian) against autograd of
    the plain loop, both on the card: directly in the kernels' parameters
    (three series, masked and dense; ten launches of each bit-identical),
    and through autograd in the log variances, where a gradient launches
    J1 and a Hessian J1 and J2."""
    for masked in (False, True):
        params, y, obs, _ = _kalman_inputs(card, torch.float64, d, 300,
                                           seed=9 + masked, c=3,
                                           masked=masked)
        fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
                  params.a0, params.p0, y, obs)
        for order in (1, 2):
            first = kk.launch_loglik(*fields, order=order)
            want = kk.loglik_jets_plain(*fields, order=order)
            assert len(first) == order + 1
            for got, ref in zip(first, want):
                assert _rel(got, ref) <= 1e-9
            for _ in range(9):
                again = kk.launch_loglik(*fields, order=order)
                assert all(torch.equal(a, b) for a, b in zip(first, again))

    params, y, obs, _ = _kalman_inputs(card, torch.float64, d, 300, seed=9,
                                       c=1, masked=True)

    def lp(fn, u):
        p = params._replace(q_mat=torch.diag_embed(torch.exp(u[:d]))[None],
                            h=torch.exp(u[d:]))
        return fn(p, y, obs)[0]

    u0 = torch.linspace(-1.0, 0.5, d + 1, dtype=torch.float64, device=card)
    out = []
    for fn in (kk.kalman_loglik, kalman.kalman_loglik):
        before = dict(kk.LAUNCHES)
        u = u0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(lp(fn, u), u)
        hess = torch.autograd.functional.hessian(
            lambda x, fn=fn: lp(fn, x), u0)
        out.append((g, hess))
        launched = {k: kk.LAUNCHES[k] - before[k] for k in kk.LOGLIK_KINDS}
        if fn is kk.kalman_loglik:
            assert launched == {"loglik": 0, "loglik_grad": 2,
                                "loglik_hess": 1}
    assert _rel(out[0][0], out[1][0]) <= 1e-9
    assert _rel(out[0][1], out[1][1]) <= 1e-9


def test_loglik_derivative_kernels_refuse_what_they_do_not_take(card):
    """J1 and J2 run float64 at d in {1, 2}: d=3 and float32 raise."""
    params, y, _obs, _ = _kalman_inputs(card, torch.float64, 3, 20, seed=3)
    fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
              params.a0, params.p0, y, None)
    for order in (1, 2):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kk.launch_loglik(*fields, order=order)
    narrow, y2, _obs, _ = _kalman_inputs(card, torch.float32, 2, 20, seed=4)
    fields = (narrow.h, narrow.rqr.contiguous(), narrow.z, narrow.t_mat,
              narrow.a0, narrow.p0, y2, None)
    for order in (1, 2):
        with pytest.raises(TypeError, match="float64"):
            kk.launch_loglik(*fields, order=order)
    h = narrow.h.clone().requires_grad_(True)
    with pytest.raises(TypeError, match="float64"):
        kk.kalman_loglik(narrow._replace(h=h), y2)


def test_kalman_kernels_are_bit_identical(card):
    params, y, _obs, normals = _kalman_inputs(card, torch.float64, 2, 500,
                                              seed=5, c=256)
    first = (kk.kalman_loglik(params, y),
             kk.simulation_smoother(params, y, *normals))
    for _ in range(9):
        again = (kk.kalman_loglik(params, y),
                 kk.simulation_smoother(params, y, *normals))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_kalman_wrappers_refuse_what_the_kernels_do_not_take(card):
    params, y, _obs, normals = _kalman_inputs(card, torch.float64, 3, 20,
                                              seed=1)
    with pytest.raises(TypeError, match="float64"):
        kk.simulation_smoother(SsmParams(*(p.float() for p in params)),
                               y.float(), *(n.float() for n in normals))
    with pytest.raises(ValueError, match="one series"):
        kk.kalman_loglik(params, y.expand(5, -1))
    h = params.h.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.kalman_loglik(params._replace(h=h), y)  # d=3: no jet kernel
    big, y17, _, n17 = _kalman_inputs(card, torch.float64, 17, 20, seed=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.simulation_smoother(big, y17, *n17)


# -- kernel (a), the SSVS indicator sweep -----------------------------------


# p at the edges of warp 0's 32 decisions a round and of a warp's row;
# 1025 chains: a last wave of one block
@pytest.mark.parametrize("p,chains", [(1, 33), (31, 33), (32, 33), (33, 33),
                                      (37, 33), (64, 33), (33, 1025)])
@pytest.mark.parametrize("jump", [False, True])
@pytest.mark.parametrize("max_size", [None, 3])
def test_ssvs_kernel_matches_plain(card, p, chains, jump, max_size):
    """float64: the kernel's masks equal the plain sweep's on every chain,
    one launch counted."""
    from boom_tpu_torch.kernels.ssvs_timing import problem
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as ssk

    rng = np.random.default_rng(p + 100 * jump)
    model, mask, noise, qprobs = problem(rng, chains, p, "float64",
                                         max_size=max_size, mode_jump=jump)
    want = rs.draw_indicators_swept(noise, model.suf, model.prior, mask,
                                    qprobs=qprobs)
    before = ssk.LAUNCHES["ssvs_sweep"]
    got = ssk.draw_indicators_swept(noise, model.suf, model.prior, mask,
                                    qprobs=qprobs)
    torch.cuda.synchronize()
    assert ssk.LAUNCHES["ssvs_sweep"] == before + 1
    assert torch.equal(got, want)


def test_ssvs_kernel_is_bit_identical_and_refuses_what_it_cannot_hold(card):
    from boom_tpu_torch.kernels.ssvs_timing import problem
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as ssk

    rng = np.random.default_rng(7)
    model, mask, noise, _q = problem(rng, 1024, 50, "float32")
    first = ssk.draw_indicators_swept(noise, model.suf, model.prior, mask)
    for _ in range(9):
        assert torch.equal(first, ssk.draw_indicators_swept(
            noise, model.suf, model.prior, mask))
    big, bmask, bnoise, _q = problem(rng, 2, 180, "float64", n=400)
    with pytest.raises(NotImplementedError, match="shared memory"):
        ssk.draw_indicators_swept(bnoise, big.suf, big.prior, bmask)
    with pytest.raises(ValueError, match="perm"):
        ssk.launch_sweep({**noise, "perm": noise["perm"][:, :3]}, model.suf,
                         model.prior, mask, 50)
    assert rs.flip_count(50) == 50


# -- K2w and K3 (kalman_wide.cu), kernel (a)'s per-chain entry ---------------


@pytest.mark.parametrize("d", [7, 8, 9, 13, 16])
@pytest.mark.parametrize("t_len", [31, 32, 33, 500])
@pytest.mark.parametrize("per_chain", [False, True])
@pytest.mark.parametrize("c", [1, 3, 5, 33])
def test_smoother_wide_matches_plain(card, d, t_len, per_chain, c):
    """K2w against the plain smoother, 1, 3 and 5 chains (a partial pack of
    a warp) and 33 (a partial block), masked, with one series or a series a
    chain; one launch."""
    params, y, obs, normals = _kalman_inputs(card, torch.float64, d, t_len,
                                             seed=d * 1000 + t_len, c=c,
                                             masked=True)
    if per_chain:
        gen = torch.Generator(device=card).manual_seed(d)
        y = y + torch.randn(c, t_len, dtype=y.dtype, device=card,
                            generator=gen)
    before = dict(kk.LAUNCHES)
    draw = kk.simulation_smoother(params, y, *normals, observed=obs)
    ref = kalman.simulation_smoother(params, y, *normals, observed=obs)
    torch.cuda.synchronize()
    assert kk.LAUNCHES["smoother_wide"] == before["smoother_wide"] + 1
    assert kk.LAUNCHES["smoother"] == before["smoother"]
    assert _within(draw, ref, TOL[torch.float64])
    for _ in range(9):
        assert torch.equal(draw, kk.simulation_smoother(
            params, y, *normals, observed=obs))


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 13, 16])
@pytest.mark.parametrize("groups", [1, 2, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("c", [5, 33, 4097])
def test_dpath_kernel_matches_plain(card, d, groups, dtype, c):
    """K3 against the plain recurrence, T = 500, 5, 33 and 4097 chains
    (series counts that leave a warp's last pack ragged; the long chunks
    of a grid one wave holds and the short ones of a full card); one
    launch; ten launches bit-identical."""
    rng = np.random.default_rng(d * 10 + groups)
    t_len = 500
    t_mat = _system(rng, c, d, dtype, card).t_mat.contiguous()
    w = torch.tensor(rng.normal(size=(c, groups, t_len - 1, d)),
                     dtype=dtype, device=card)
    before = kk.LAUNCHES["dpath"]
    got = kk.dpath(t_mat, w)
    torch.cuda.synchronize()
    assert kk.LAUNCHES["dpath"] == before + 1
    assert _within(got, kalman.dpath(t_mat, w), TOL[dtype])
    for _ in range(9):
        assert torch.equal(got, kk.dpath(t_mat, w))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dpath_kernel_matches_plain_at_the_fit_shape(card, dtype):
    """K3 at the D-paths of the T = 4096 fit (8 chains x 2 groups, d = 2:
    many chunks a series); one launch; ten launches bit-identical."""
    rng = np.random.default_rng(4096)
    c, d, groups, t_len = 8, 2, 2, 4096
    t_mat = _system(rng, c, d, dtype, card).t_mat.contiguous()
    w = torch.tensor(rng.normal(size=(c, groups, t_len - 1, d)),
                     dtype=dtype, device=card)
    before = kk.LAUNCHES["dpath"]
    got = kk.dpath(t_mat, w)
    torch.cuda.synchronize()
    assert kk.LAUNCHES["dpath"] == before + 1
    assert _within(got, kalman.dpath(t_mat, w), TOL[dtype])
    for _ in range(9):
        assert torch.equal(got, kk.dpath(t_mat, w))


@pytest.mark.parametrize("p", [20, 33, 50])
@pytest.mark.parametrize("chains", [33, 4096])
def test_ssvs_border_kernel_matches_plain(card, p, chains):
    """Kernel (a)'s per-chain entry, float64: masks equal the plain
    sweep's on per-chain statistics, one launch of that entry."""
    from boom_tpu_torch.kernels.ssvs_timing import problem_per_chain
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as ssk

    rng = np.random.default_rng(p + chains)
    suf, prior, mask, noise = problem_per_chain(rng, chains, p, "float64")
    want = rs.draw_indicators_swept(noise, suf, prior, mask)
    before = dict(ssk.LAUNCHES)
    got = ssk.draw_indicators_swept(noise, suf, prior, mask)
    torch.cuda.synchronize()
    assert ssk.LAUNCHES["ssvs_sweep_border"] == (
        before["ssvs_sweep_border"] + 1)
    assert ssk.LAUNCHES["ssvs_sweep"] == before["ssvs_sweep"]
    assert torch.equal(got, want)


def test_log_lik_with_a_regression_refuses_the_card(card):
    """K1 takes one series for every chain; bsts with a regression gives a
    series a chain, y - X beta: on the card ``log_lik`` raises rather than
    run the plain filter."""
    from boom_tpu_torch.api import BstsModel

    rng = np.random.default_rng(9)
    x = rng.normal(size=(40, 3))
    y = x[:, 0] + np.cumsum(rng.normal(size=40))
    fit = (BstsModel().add_local_linear_trend().add_seasonal(nseasons=4)
           .fit(y, predictors=x, niter=2, burn=1, num_chains=4, seed=1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit._model.log_lik(fit._flat())

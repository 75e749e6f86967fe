"""The hand-written CUDA kernels (the parallel scans, the sequential
Kalman loglik K1 and K1w, its derivative kernels J1 and J2, the simulation
smoothers K2 and K2w, their time-varying forms and the calendar's T_t in
K1w's and K2w's, the ASIS D-path K3, kernel (a), the SSVS
indicator sweep, with one S0 and with a border of S0 a chain, and the
HMM's H1 and H2) against their plain PyTorch versions, on the card. These need
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


@pytest.mark.parametrize("d", [1, 2, 3, 8, 16])
def test_loglik_derivatives_match_plain(card, d):
    """J1 (the gradient) and J2 (gradient and Hessian) along K directions
    against autograd of the plain loop, both on the card: directly (three
    systems, one shared series and a series a system, masked and dense, K
    at 3 and at the most the kernels take; ten launches of each
    bit-identical), and through autograd of ``loglik_along`` in the log
    variances, where a gradient launches J1 and a Hessian J1 and J2."""
    from boom_tpu_torch.kernels.host_rehearsal import directions

    rng = np.random.default_rng(40 + d)
    for masked, per_system, k in ((False, False, 3), (True, True, 3),
                                  (True, False, kk.JET_MAX_DIRECTIONS)):
        params, y, obs, _ = _kalman_inputs(card, torch.float64, d, 300,
                                           seed=9 + masked, c=3,
                                           masked=masked)
        if per_system:
            y = torch.stack([y, 0.5 * y, y.flip(0)])
        dh, dm = (x.to(card) for x in directions(rng, k, d))
        fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
                  params.a0, params.p0, y, obs, dh, dm)
        for order in (1, 2):
            first = kk.launch_jets(*fields, order=order)
            want = kalman.loglik_jets(*fields, order)
            assert len(first) == order + 1
            for got, ref in zip(first, want):
                assert _rel(got, ref) <= 1e-9
            for _ in range(9):
                again = kk.launch_jets(*fields, order=order)
                assert all(torch.equal(a, b) for a, b in zip(first, again))

    params, y, obs, _ = _kalman_inputs(card, torch.float64, d, 300, seed=9,
                                       c=1, masked=True)
    dh, dm = (x.to(card) for x in directions(rng, 3, d))
    h0, q0 = 0.5 * params.h, 0.5 * params.rqr

    def lp(fn, u):
        return fn(torch.exp(u)[None], h0, q0, dh, dm, params.z,
                  params.t_mat, params.a0, params.p0, y, obs)[0]

    u0 = torch.linspace(-1.0, 0.5, 3, dtype=torch.float64, device=card)
    out = []
    for fn in (kk.loglik_along, kalman.loglik_along):
        before = dict(kk.LAUNCHES)
        u = u0.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(lp(fn, u), u)
        hess = torch.autograd.functional.hessian(
            lambda x, fn=fn: lp(fn, x), u0)
        out.append((g, hess))
        launched = {k: kk.LAUNCHES[k] - before[k]
                    for k in ("loglik", "loglik_wide", *kk.JET_KINDS.values())}
        if fn is kk.loglik_along:
            assert launched == {"loglik": 0, "loglik_wide": 0,
                                "loglik_grad": 2, "loglik_hess": 1}
    assert _rel(out[0][0], out[1][0]) <= 1e-9
    assert _rel(out[0][1], out[1][1]) <= 1e-9


def _jets_hold(card, d, k, c, series, t_len, masked, seed, reps=2,
               orders=(1, 2)):
    """J1 and J2 (``orders``) on c systems (``series`` of them: one, or one
    a system) against autograd of the plain loop at 1e-9; ``reps`` launches
    of each bit-identical."""
    from boom_tpu_torch.kernels.host_rehearsal import directions

    rng = np.random.default_rng(seed)
    params, y, obs, _ = _kalman_inputs(card, torch.float64, d, t_len,
                                       seed=seed, c=c, masked=masked)
    if series > 1:
        y = torch.stack([y * (1.0 + 0.1 * i) for i in range(series)])
    dh, dm = (x.to(card) for x in directions(rng, k, d))
    fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
              params.a0, params.p0, y, obs, dh, dm)
    for order in orders:
        first = kk.launch_jets(*fields, order=order)
        want = kalman.loglik_jets(*fields, order)
        for got, ref in zip(first, want):
            assert _rel(got, ref) <= 1e-9, (d, order)
        for _ in range(reps - 1):
            again = kk.launch_jets(*fields, order=order)
            assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_loglik_derivatives_at_small_d_match_plain(card, d):
    """J1 and J2 at d 1-4 (one or two rounds of a step's jobs over the
    lanes), K 3 and 16, three systems on three series, masked, T about the
    kernel's chunks of 32 steps of y."""
    for k, t_len in ((3, 33), (kk.JET_MAX_DIRECTIONS, 65)):
        _jets_hold(card, d, k, 3, 3, t_len, True, seed=d + t_len)


@pytest.mark.parametrize("d, t_len", [(2, 500), (8, 500), (3, 31), (3, 32),
                                      (13, 33), (16, 65)])
def test_loglik_derivatives_at_the_paths_shapes_and_chunk_edges(card, d,
                                                                t_len):
    """J1 and J2 as the proposal builds launch them (one series, K = 3, T =
    500 at d 2 and 8: ten launches bit-identical), and about the kernel's
    chunks of y with K 1 and 16 over systems on one series and on a series
    a system, masked."""
    if t_len == 500:
        _jets_hold(card, d, 3, 1, 1, t_len, False, seed=d, reps=10)
        return
    for k, c, series in ((1, 4, 1), (kk.JET_MAX_DIRECTIONS, 3, 3)):
        _jets_hold(card, d, k, c, series, t_len, True, seed=d * t_len + k)


def test_loglik_derivative_kernels_refuse_what_they_do_not_take(card):
    """J1 and J2 run float64 at d 1..16 along 1..JET_MAX_DIRECTIONS
    directions: d = 17, K past the most and float32 raise, and so does a
    gradient of ``kalman_loglik``, which takes none on the card."""
    from boom_tpu_torch.kernels.host_rehearsal import directions

    rng = np.random.default_rng(3)
    big, y17, _obs, _ = _kalman_inputs(card, torch.float64, 17, 20, seed=3)
    dirs = [x.to(card) for x in directions(rng, 2, 17)]
    fields = (big.h, big.rqr.contiguous(), big.z, big.t_mat, big.a0,
              big.p0, y17, None)
    for order in (1, 2):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kk.launch_jets(*fields, *dirs, order=order)
    params, y, _obs, _ = _kalman_inputs(card, torch.float64, 3, 20, seed=3)
    many = [x.to(card) for x in directions(rng, kk.JET_MAX_DIRECTIONS + 1,
                                            3)]
    fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
              params.a0, params.p0, y, None)
    for order in (1, 2):
        with pytest.raises(NotImplementedError, match="directions"):
            kk.launch_jets(*fields, *many, order=order)
    narrow, y2, _obs, _ = _kalman_inputs(card, torch.float32, 2, 20, seed=4)
    fields = (narrow.h, narrow.rqr.contiguous(), narrow.z, narrow.t_mat,
              narrow.a0, narrow.p0, y2, None)
    dirs = [x.float().to(card) for x in directions(rng, 2, 2)]
    for order in (1, 2):
        with pytest.raises(TypeError, match="float64"):
            kk.launch_jets(*fields, *dirs, order=order)
    h = params.h.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="loglik_along"):
        kk.kalman_loglik(params._replace(h=h), y)


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
        kk.simulation_smoother(params.cast(torch.float32),
                               y.float(), *(n.float() for n in normals))
    # a series count that does not divide the systems
    with pytest.raises(ValueError, match="dividing"):
        kk.kalman_loglik(params, y.expand(3, -1))
    with pytest.raises(ValueError, match="a series a chain"):
        kk.simulation_smoother(params, y.expand(3, -1), *normals)
    big, y17, _, n17 = _kalman_inputs(card, torch.float64, 17, 20, seed=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.simulation_smoother(big, y17, *n17)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.kalman_loglik(big, y17)
    with pytest.raises(TypeError, match="float32 or float64"):
        kk.kalman_loglik(params.cast(torch.float16), y.half())


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


def test_log_lik_and_errors_with_a_regression_run_on_the_card(card):
    """bsts with a regression gives a series a chain, y - X beta: on the
    card ``log_lik`` runs K1 (d = 5 here) with a series a chain and the
    one-step errors its innovations, within 1e-4 (float32) of the plain
    filter on the same draws."""
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.statespace import bsts

    rng = np.random.default_rng(9)
    x = rng.normal(size=(40, 3))
    y = x[:, 0] + np.cumsum(rng.normal(size=40))
    fit = (BstsModel().add_local_linear_trend().add_seasonal(nseasons=4)
           .fit(y, predictors=x, niter=2, burn=1, num_chains=4, seed=1))
    model, flat = fit._model, fit._flat()
    before = dict(kk.LAUNCHES)
    got = model.log_lik(flat)
    errs = bsts.one_step_prediction_errors(model, flat)
    assert kk.LAUNCHES["loglik"] == before["loglik"] + 2
    params = model.ssm_params(flat)
    y_adj = model.adjusted_series(flat)
    want = kalman.kalman_loglik(params, y_adj, innovations=True)
    assert _rel(got, want[0]) <= TOL[torch.float32]
    assert _rel(errs, want[1] / torch.sqrt(want[2])) <= TOL[torch.float32]


# -- the time-varying forms of K1, K1w, K2 and K2w -----------------------------


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [1, 2, 4, 6, 7, 13, 16])
@pytest.mark.parametrize("q_mode", ["chain", "shared", None])
@pytest.mark.parametrize("t_len", [1, 33, 500])
@pytest.mark.parametrize("t_kind", ["chain", "bsts", "sparse"])
def test_time_varying_kernels_match_plain(card, dtype, d, q_mode, t_len,
                                          t_kind):
    """K1 / K1w with their innovations (both dtypes) and K2 / K2w (float64)
    of a time-varying system (z_t shared, h_t, Q_t with q_t a system, one
    for all or none), masked, a series a group, T a system, or one T for
    all of bsts' pattern or a random one (an empty row and a full one:
    both loglik forms read its one row): each against its plain version,
    one launch of its time-varying form (K2w's dense form with a T a
    system, its structured form with one T for all)."""
    from boom_tpu_torch.kernels.kalman_timing import time_varying_system

    rng = np.random.default_rng(d * 1000 + t_len)
    tag = str(dtype).split(".")[-1]
    b = 34
    params = time_varying_system(rng, b, d, t_len, tag, q_mode,
                                 t_kind=t_kind)
    y = torch.tensor(rng.normal(size=(17, t_len)).cumsum(-1), dtype=dtype,
                     device=card)
    obs = torch.tensor(rng.uniform(size=t_len) > 0.2, device=card)
    wide = d >= 7
    before = dict(kk.LAUNCHES)
    got = kk.launch_loglik_tv(params, y, obs, innovations=True)
    want = kalman.kalman_loglik(params, y, obs, innovations=True)
    for g, w in zip(got, want):
        assert _within(g, w, TOL[dtype])
    kind = "loglik_wide_tv" if wide else "loglik_tv"
    assert kk.LAUNCHES[kind] == before[kind] + 1
    if dtype == torch.float64:
        y1 = y[0]
        q = params.q_mat.shape[-1]
        normals = [torch.tensor(rng.normal(size=s), dtype=dtype, device=card)
                   for s in ((b, d), (b, t_len - 1, q), (b, t_len))]
        got = kk.simulation_smoother(params, y1, *normals, observed=obs)
        want = kalman.simulation_smoother(params, y1, *normals,
                                          observed=obs)
        assert _within(got, want, TOL[dtype])
        kind = ("smoother_tv" if not wide else "smoother_wide_tv_dense"
                if t_kind == "chain" else "smoother_wide_tv")
        assert kk.LAUNCHES[kind] == before[kind] + 1


def test_time_varying_kernels_are_bit_identical(card):
    from boom_tpu_torch.kernels import kalman_timing as kt

    rng = np.random.default_rng(3)
    for name, (tag, batch, d, t_len, series, t_kind) in kt.TV_SHAPES.items():
        kern = kt.tv_cases(rng, name, tag, min(batch, 257), d, t_len,
                           min(series, 257), t_kind=t_kind)[0]
        first = kern()
        first = first if isinstance(first, tuple) else (first,)
        for _ in range(9):
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            assert all(torch.equal(a, w) for a, w in zip(first, again)), name


def test_tv_bsts_runs_on_the_card(card):
    """A gapped time-varying bsts (a Student trend and a dynamic regression,
    d = 4; with a seasonal and a holiday, d = 13) fit on the card goes
    through K2 / K2w and K1 / K1w in their time-varying forms, and its
    log_lik and errors agree with the plain filter."""
    from boom_tpu_torch import data
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.statespace import bsts as pbsts

    raw = data.bsts_tv()
    keep = raw["timestamps"] < 120
    for small in (True, False):
        model = BstsModel().add_student_local_linear_trend()
        if not small:
            model = model.add_seasonal(7)
        model = model.add_dynamic_regression(raw["x_dyn"][:120])
        if not small:
            model = model.add_random_walk_holiday(raw["active"][:120], 3)
        before = dict(kk.LAUNCHES)
        fit = model.fit(raw["y"][keep], predictors=raw["x"][keep],
                        timestamps=raw["timestamps"][keep], niter=4, burn=2,
                        num_chains=8, seed=1)
        m = fit._model
        states = fit._flat()
        ll = m.log_lik(states)
        errs = pbsts.one_step_prediction_errors(m, states)
        sm_kind = "smoother_tv" if small else "smoother_wide_tv"
        ll_kind = "loglik_tv" if small else "loglik_wide_tv"
        assert kk.LAUNCHES[sm_kind] >= before[sm_kind] + 7
        assert kk.LAUNCHES[ll_kind] == before[ll_kind] + 2
        want = kalman.kalman_loglik(m.ssm_params(states),
                                    m.adjusted_series(states), m.observed,
                                    innovations=True)
        assert _within(ll.double(), want[0].double(), 1e-4)
        assert _within(errs.double(),
                       (want[1] / torch.sqrt(want[2])).double(), 1e-4)


# -- the calendar's T_t in K1w and K2w (chip_smoke.py phase 2g's checks) --


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("d", [11, 14, 16])
@pytest.mark.parametrize("kind", ["calendar", "calendar_shared"])
@pytest.mark.parametrize("t_len", [2, 33, 730])
def test_calendar_kernels_match_plain(card, dtype, d, kind, t_len):
    """The calendar's T_t (two matrices, a step's choice) in K1w's
    time-varying form (with the innovations) and, in float64, K2w's dense
    form, on 33 systems against their plain versions; each launch takes
    its calendar key; a second launch is bit-identical."""
    from boom_tpu_torch.kernels import kalman_timing as kt

    rng = np.random.default_rng(d * 1000 + t_len)
    tag = str(dtype).split(".")[-1]
    params = kt.calendar_system(rng, 33, d, t_len, tag, kind)
    y = torch.tensor(rng.normal(size=t_len).cumsum(), dtype=dtype,
                     device=card)
    obs = torch.tensor(rng.uniform(size=t_len) > 0.1, device=card)
    before = dict(kk.LAUNCHES)
    got = kk.launch_loglik_tv(params, y, obs, innovations=True)
    again = kk.launch_loglik_tv(params, y, obs, innovations=True)
    want = kalman.kalman_loglik(params, y, obs, innovations=True)
    assert kk.LAUNCHES["loglik_wide_tv_calendar"] == (
        before["loglik_wide_tv_calendar"] + 2)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        assert _within(g, w, TOL[dtype])
    if dtype == torch.float64:
        q = params.q_mat.shape[-1]
        nz = [torch.tensor(rng.normal(size=sh), dtype=dtype, device=card)
              for sh in ((33, d), (33, t_len - 1, q), (33, t_len))]
        draw = kk.simulation_smoother(params, y, *nz, observed=obs)
        assert torch.equal(draw, kk.simulation_smoother(params, y, *nz,
                                                        observed=obs))
        assert kk.LAUNCHES["smoother_wide_tv_calendar"] == (
            before["smoother_wide_tv_calendar"] + 2)
        assert _within(draw, kalman.simulation_smoother(
            params, y, *nz, observed=obs), TOL[dtype])


def test_monthly_and_ar_trig_models_run_on_the_card(card):
    """Phase 10a's model (a semilocal trend and the monthly cycle, d = 14)
    and phase 10b's (an intercept, an AR(2) and a two-harmonic cycle, d =
    7, the TIM move) fit on the card go through their kernels: K2w's dense
    form with the calendar and K1w's (log_lik, errors); the static K2w with
    a T a chain, K1w with a T a system, J1 and J2; K3 in both; log_lik and
    the errors agree with the plain filter."""
    from boom_tpu_torch import data
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.statespace import bsts as pbsts

    y_m = data.bsts_monthly()["y"][:200]
    y_a = data.bsts_ar_trig()["y"][:200]
    runs = {
        "monthly": (BstsModel().add_semilocal_linear_trend()
                    .add_monthly_annual_cycle(data.BSTS_MONTHLY_FIRST),
                    y_m, {}, ("smoother_wide_tv_calendar", "dpath"),
                    "loglik_wide_tv_calendar"),
        "ar_trig": (BstsModel().add_static_intercept().add_ar(lags=2)
                    .add_trig(period=data.BSTS_AR_TRIG_PERIOD, nfreq=2),
                    y_a, {"marginal_sigma_slice": True,
                          "marginal_move": "tim"},
                    ("smoother_wide", "dpath", "loglik_wide", "loglik_grad",
                     "loglik_hess"), "loglik_wide")}
    for name, (builder, y, kw, kinds, ll_kind) in runs.items():
        before = dict(kk.LAUNCHES)
        fit = builder.fit(y, niter=4, burn=2, num_chains=64, seed=1, **kw)
        m = fit._model
        states = fit._flat()
        ll = m.log_lik(states)
        errs = pbsts.one_step_prediction_errors(m, states)
        for kind in kinds:
            assert kk.LAUNCHES[kind] > before[kind], (name, kind)
        assert kk.LAUNCHES[ll_kind] >= before[ll_kind] + 2, name
        want = kalman.kalman_loglik(m.ssm_params(states),
                                    m.adjusted_series(states), m.observed,
                                    innovations=True)
        assert _within(ll.double(), want[0].double(), 1e-4), name
        assert _within(errs.double(),
                       (want[1] / torch.sqrt(want[2])).double(), 1e-4), name
        fc = fit.predict(30, max_draws=16)
        assert fc.shape == (16, 30) and bool(torch.isfinite(fc).all())


# -- H1 and H2, csrc/hmm.cu (chip_smoke.py phase 2f's checks) ---------------

HMM_TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# H2's statistics against those of its own path
HMM_STATS_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("s", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("t_len", [1, 2, 33, 1200])
@pytest.mark.parametrize("c", [1, 33, 4097])
def test_hmm_kernels_match_plain(card, dtype, s, t_len, c):
    """H1 within a normwise 1e-9 (float64) / 1e-4 (float32) of the plain
    filter, with and without its alphas; H2's paths identical in float64
    and on at least 99.5 % of chains in float32; its statistics those of
    its own path."""
    from boom_tpu_torch.kernels.hmm_timing import problem
    from boom_tpu_torch.models import hmm, hmm_kernel

    tag = str(dtype).split(".")[-1]
    p = problem(np.random.default_rng(s * t_len + c), c, t_len, s, tag,
                device=card)
    args = (p["log_lik"], p["log_trans"], p["log_init"])
    la, ll = hmm_kernel.launch_forward(*args)
    want_la, want_ll = hmm.forward_filter(*args)
    assert _within(la.double(), want_la.double(), HMM_TOL[dtype])
    assert _within(ll.double(), want_ll.double(), HMM_TOL[dtype])
    assert torch.equal(hmm_kernel.launch_forward(*args, want_alphas=False)[1],
                       ll)
    z, suf, counts, first = hmm_kernel.launch_backward(
        want_la, p["log_trans"], p["path_u"], p["y"])
    want_z = hmm.backward_sample(want_la, p["log_trans"], p["path_u"])
    agree = float((z == want_z).all(-1).double().mean())
    assert agree == 1.0 if dtype == torch.float64 else agree >= 0.995
    own = hmm.path_stats(z, p["y"].double(), s)
    for got, want in zip((*suf, counts, first), (*own[0], *own[1:])):
        assert _within(got.double(), want, HMM_STATS_TOL[dtype])


def _tensors(out):
    """Every tensor of a kernel's output, nested tuples flattened."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in (out or ()) for t in _tensors(o)]


def test_hmm_kernels_are_bit_identical(card):
    """Ten launches of each at phase 9's shape (4096 chains, T = 1200,
    S = 2, float32)."""
    from boom_tpu_torch.kernels.hmm_timing import cases

    for name, (kern, _plain) in cases(np.random.default_rng(0), "float32",
                                      4096, 1200, 2).items():
        first = _tensors(kern())
        for _ in range(9):
            assert all(torch.equal(a, b)
                       for a, b in zip(first, _tensors(kern()))), name


def test_gaussian_hmm_sweeps_on_the_card(card):
    """A float64 sweep of 33 chains on the card against the CPU's on the
    same noise; a sweep launches H1 and H2 once."""
    from boom_tpu_torch import data
    from boom_tpu_torch.models import hmm, hmm_kernel

    y = data.hmm()["y"]
    models = {dev: hmm.GaussianHmm(y=torch.tensor(y, device=dev),
                                   num_states=2) for dev in ("cpu", "cuda")}
    gen = torch.Generator().manual_seed(0)
    cpu = models["cpu"]
    st = cpu.init_state(cpu.draw_init_noise(gen, 33))
    noise = cpu.draw_noise(gen, 33)
    want = cpu.kernel()(noise, st)
    before = dict(hmm_kernel.LAUNCHES)
    got = models["cuda"].kernel()(
        {k: v.cuda() for k, v in noise.items()},
        {k: v.cuda() for k, v in st.items()})
    assert {k: hmm_kernel.LAUNCHES[k] - before[k] for k in before} == {
        "hmm_forward": 1, "hmm_backward": 1}
    for k in want:
        assert _within(got[k].cpu(), want[k], 1e-8)

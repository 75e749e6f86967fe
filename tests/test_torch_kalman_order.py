"""The order of work of the redesigned sequential Kalman kernels
(``csrc/kalman_seq.cu``), modelled in torch and held against the JAX
reference (boom_tpu/statespace/kalman.py) on the CPU.

K2, the fused simulation smoother, stages its per-step streams a chunk of
``kalman_kernel.SMOOTHER_CHUNK`` steps at a time: pass 1 filters y - y+
with one correctly rounded reciprocal of f a step (K = T P z (1/f) and
v (1/f) in place of the reference's divisions) and stores (v/f, K) of each
step in a slot of D + 1; pass 2 walks the chunks in reverse and overwrites
a slot's first D with r_{t-1}; pass 3 regenerates alpha+ from alpha_1 and
w with pass 1's operations and writes alpha+ + alpha-hat once. The model
below repeats that order, chunk edges included, and must match the
reference's ``simulation_smoother`` in float64 to 1e-12 (normwise), at T
one below, at, one above a chunk and over several chunks with a ragged
last one.

K1, the batched loglik, computes in float32 with one correctly rounded
reciprocal of f for K and v^2 / f and the upper triangle of the
symmetrization (its log is the card's ``__logf``, which the model replaces
by ``torch.log``). The model must match the reference's ``kalman_loglik``
within the normwise 1e-4 that PERF.md states for K1 in float32.

The last test compiles the kernels' own source for the host (the shim of
``kernels/host_rehearsal.py``: a block's threads as host threads with real
barriers, cp.async as copies) and runs the wrappers through it on CPU
tensors against the plain versions.
"""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.statespace import kalman as jk
from boom_tpu_torch.convert import ssm_params_from_numpy
from boom_tpu_torch.kernels import _build
from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace import kalman_kernel as kk

torch.set_num_threads(1)

K2_TOL = 1e-12  # float64, normwise relative
K1_F32_TOL = 1e-4  # float32, normwise relative (PERF.md)
C = 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _systems(rng, c, d):
    """C stable static systems (spectral radius < 1) as stacked arrays."""
    def one():
        qm, _ = np.linalg.qr(rng.normal(size=(d, d)))
        lq = 0.3 * rng.normal(size=(d, d))
        mp = rng.normal(size=(d, d))
        return dict(z=rng.normal(size=d),
                    t_mat=qm @ np.diag(rng.uniform(0.5, 0.97, d)) @ qm.T,
                    r_mat=np.eye(d), q_mat=lq @ lq.T + 0.1 * np.eye(d),
                    h=np.asarray(rng.uniform(0.3, 1.0)),
                    a0=rng.normal(size=d), p0=mp @ mp.T + np.eye(d))

    systems = [one() for _ in range(c)]
    return {k: np.stack([s[k] for s in systems]) for k in systems[0]}


def _inputs(d, t_len, masked, seed):
    rng = np.random.default_rng(seed)
    fields = _systems(rng, C, d)
    y = rng.normal(size=t_len).cumsum()
    observed = (rng.uniform(size=t_len) > 0.25 if masked
                else np.ones(t_len, bool))
    return fields, y, observed


def _recip_filter_step(a, p, y_t, obs_t, z, h, rqr, t_mat):
    """``kalman._filter_step`` with K = T P z * (1/f): (v, f, 1/f, k,
    a_next, p_next)."""
    v = torch.where(obs_t, y_t - kalman._vdot(z, a), 0.0)
    pz = kalman._mv(p, z)
    f = kalman._vdot(z, pz) + h
    rf = 1.0 / f
    k_gain = torch.where(obs_t, kalman._mv(t_mat, pz) * rf[:, None], 0.0)
    l_mat = t_mat - k_gain[..., :, None] * z[..., None, :]
    a_next = kalman._mv(t_mat, a) + k_gain * v[:, None]
    p_next = kalman._mm(kalman._mm(t_mat, p), l_mat.transpose(-1, -2)) + rqr
    p_next = 0.5 * (p_next + p_next.transpose(-1, -2))
    return v, f, rf, k_gain, a_next, p_next


def k2_order(params, y, alpha1, w, eps, observed, chunk):
    """alpha+ + alpha-hat [C, T, d] in K2's order of work (float64)."""
    z, tm, rqr, h, p0 = (params.z, params.t_mat, params.rqr, params.h,
                         params.p0)
    c, d = z.shape
    t_len = y.shape[0]
    obs = kalman._mask(observed, t_len, y.device)
    chunks = [(t0, min(chunk, t_len - t0)) for t0 in range(0, t_len, chunk)]
    scratch = torch.full((c, t_len, d + 1), float("nan"), dtype=y.dtype)

    # 1. forward: filter y - y+ and simulate alpha+; slot t = (v/f, K)
    a, p, sim = torch.zeros_like(alpha1), p0.clone(), alpha1.clone()
    for t0, n in chunks:
        n_w = min(n, t_len - 1 - t0)
        w_col, e_col = w[:, t0:t0 + n_w].clone(), eps[:, t0:t0 + n].clone()
        y_col, m_col = y[t0:t0 + n].clone(), obs[t0:t0 + n].clone()
        for s in range(n):
            t = t0 + s
            yd = y_col[s] - (kalman._vdot(z, sim) + e_col[:, s])
            v, _f, rf, k_gain, a, p = _recip_filter_step(a, p, yd, m_col[s],
                                                         z, h, rqr, tm)
            scratch[:, t, 0] = v * rf
            scratch[:, t, 1:] = k_gain
            if t < t_len - 1:
                sim = kalman._mv(tm, sim) + w_col[:, s]

    # 2. backward, chunks in reverse: slot t's first d = r_{t-1}
    r = torch.zeros_like(alpha1)
    for t0, n in reversed(chunks):
        col, m_col = scratch[:, t0:t0 + n].clone(), obs[t0:t0 + n].clone()
        for s in range(n - 1, -1, -1):
            vf, k_gain = col[:, s, 0], col[:, s, 1:]
            l_mat = tm - k_gain[..., :, None] * z[..., None, :]
            r = (torch.where(m_col[s], z * vf[:, None], 0.0)
                 + kalman._mv(l_mat.transpose(-1, -2), r))
            scratch[:, t0 + s, :d] = r

    # 3. forward state, alpha+ regenerated as pass 1 made it
    sim, out = alpha1.clone(), torch.empty(c, t_len, d, dtype=y.dtype)
    ah = None
    for t0, n in chunks:
        n_w = min(n, t_len - 1 - t0)
        r_col, w_col = scratch[:, t0:t0 + n, :d].clone(), w[:, t0:t0 + n_w]
        for s in range(n):
            t = t0 + s
            ah = (kalman._mv(p0, r_col[:, s]) if t == 0 else
                  kalman._mv(tm, ah) + kalman._mv(rqr, r_col[:, s]))
            out[:, t] = sim + ah
            if t < t_len - 1:
                sim = kalman._mv(tm, sim) + w_col[:, s]
    return out


def k1_f32_order(params, y, observed):
    """[B] logliks in K1's float32 order of work (torch.log for __logf)."""
    z, tm, rqr, h = params.z, params.t_mat, params.rqr, params.h
    t_len = y.shape[0]
    obs = kalman._mask(observed, t_len, y.device)
    a, p = params.a0, params.p0
    ll = torch.zeros_like(h)
    log_2pi = torch.tensor(kalman.LOG_2PI, dtype=h.dtype)
    for t in range(t_len):
        o = obs[t]
        v = torch.where(o, y[t] - kalman._vdot(z, a), 0.0)
        pz = kalman._mv(p, z)
        f = kalman._vdot(z, pz) + h
        rf = 1.0 / f
        k_gain = torch.where(o, kalman._mv(tm, pz) * rf[:, None], 0.0)
        l_mat = tm - k_gain[..., :, None] * z[..., None, :]
        a = kalman._mv(tm, a) + k_gain * v[:, None]
        pn = kalman._mm(kalman._mm(tm, p), l_mat.transpose(-1, -2)) + rqr
        upper = torch.triu(0.5 * (pn + pn.transpose(-1, -2)), 1)
        p = upper + upper.transpose(-1, -2) + torch.diag_embed(
            torch.diagonal(pn, dim1=-2, dim2=-1))
        ll = ll + torch.where(o, -0.5 * ((log_2pi + torch.log(f))
                                         + v * v * rf), 0.0)
    return ll


def test_chunk_matches_the_kernel_source():
    """The model's chunk is the kernel's (kChunk in kalman_seq.cu)."""
    src = _build.SOURCES["kalman_seq"].read_text()
    (chunk,) = re.findall(r"constexpr int kChunk = (\d+);", src)
    assert int(chunk) == kk.SMOOTHER_CHUNK


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("d", [1, 2, 6])
@pytest.mark.parametrize("t_rel", ["chunk-1", "chunk", "chunk+1",
                                   "2*chunk+3"])
@pytest.mark.parametrize("chunk", [4, kk.SMOOTHER_CHUNK])
def test_k2_order_matches_reference(chunk, t_rel, d, masked):
    t_len = eval(t_rel, {"chunk": chunk})
    fields, y, observed = _inputs(d, t_len, masked, seed=7 * t_len + d)
    keys = jax.random.split(jax.random.key(11 + d), C)

    def ref_one(p, key):
        k0, ka, ke = jax.random.split(key, 3)
        normals = (jax.random.normal(k0, (d,)),
                   jax.random.normal(ka, (t_len - 1, d)),
                   jax.random.normal(ke, (t_len,)))
        draw = jk.simulation_smoother(key, jk.SsmParams(**p), y, observed)
        return draw, normals

    draw, normals = jax.jit(jax.vmap(ref_one))(
        {k: jnp.asarray(v) for k, v in fields.items()}, keys)
    params = ssm_params_from_numpy(fields, device="cpu")
    alpha1, w, eps = kalman.simulation_inputs(
        params, *(torch.tensor(np.asarray(n)) for n in normals))
    got = k2_order(params, torch.tensor(y), alpha1, w, eps,
                   torch.tensor(observed), chunk)
    assert _rel(got.numpy(), np.asarray(draw)) <= K2_TOL


@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
@pytest.mark.parametrize("d", [1, 2, 6])
@pytest.mark.parametrize("t_len", [33, 500])
@pytest.mark.parametrize("ref_dtype", ["float64", "float32"])
def test_k1_f32_order_matches_reference(ref_dtype, t_len, d, masked):
    fields, y, observed = _inputs(d, t_len, masked, seed=3 * t_len + d)
    cast = {k: jnp.asarray(v, dtype=ref_dtype) for k, v in fields.items()}
    ref = jax.jit(jax.vmap(lambda p: jk.kalman_loglik(
        jk.SsmParams(**p), jnp.asarray(y, dtype=ref_dtype),
        observed)))(cast)
    params = ssm_params_from_numpy(fields, device="cpu")
    params = params.cast(torch.float32)
    got = k1_f32_order(params, torch.tensor(y, dtype=torch.float32),
                       torch.tensor(observed))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(ref)) <= K1_F32_TOL


@pytest.fixture
def host_kernels(monkeypatch):
    """kalman_kernel's wrappers bound to kalman_seq.cu and kalman_wide.cu
    (the jets) compiled for the host, launching on CPU tensors."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    from boom_tpu_torch.kernels import host_rehearsal

    libs = {name: host_rehearsal.build_host_library(name, variant="order")
            for name in ("kalman_seq", "kalman_wide")}
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: libs[n] for n in names})
    monkeypatch.setattr(kk, "_on_card", lambda x: True)
    monkeypatch.setattr(kk, "_stream", lambda device: 0)
    _build.library.cache_clear()
    yield host_rehearsal
    _build.library.cache_clear()


def test_host_compiled_kernels_match_plain(host_kernels):
    """K1 (float64, float32), K2, and J1 and J2 (the loglik's derivatives,
    at d in {1, 2}, masked and dense, through autograd along the unit
    directions of h and R Q R'), compiled from the kernels' source for the
    host, against the plain versions at K2's chunk edges and with a second,
    ragged warp of chains."""
    worst = host_kernels.check_kernels()
    tol = {"loglik float64": 1e-9, "smoother": 1e-9,
           "loglik float32": K1_F32_TOL, "gradient": 1e-9, "hessian": 1e-9}
    assert set(worst) == set(tol)
    for name, err in worst.items():
        assert err <= tol[name], (name, err)


# excerpts of the toolchain's listings for K1 at d=2 in float64, without a
# mask, on a series a group of systems
_K1 = ("_ZN46_GLOBAL__N__bea6d392_13_kalman_seq_cu_88ddba7013loglik_kernelIdLi2"
       "ELb0ELb0EEEvPKT_S3_S3_S3_S3_S3_S3_PKhPS1_S6_S6_iii")
_PTXAS = f"""ptxas info    : Compiling entry function '{_K1}' for 'sm_90a'
ptxas info    : Function properties for {_K1}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""
_SASS = f"""\t\tFunction : {_K1}
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   DFMA R2, R4, R6, R2 ;
        /*0020*/                   DMUL R8, R2, R2 ;
        /*0030*/                   DADD R2, R2, R8 ;
        /*0040*/               @P0 BRA 0x10 ;
        /*0050*/                   IMAD.MOV.U32 R3, RZ, RZ, RZ ;
        /*0060*/              @!P1 BRA 0x0 ;
        /*0070*/                   EXIT ;
"""


def test_timing_reports_read_the_toolchain_listings():
    """kalman_timing's readers of ``nvcc -Xptxas -v`` (registers, spills)
    and of ``cuobjdump -sass`` (the step loop: of the loops, the one with
    the most float arithmetic, the inner one on a tie)."""
    from boom_tpu_torch.kernels import kalman_timing as kt

    key = "loglik f64 d2 dense per-series"
    assert kt.nvcc_report(_PTXAS) == {key: {
        "registers": 64, "spill_bytes": 0, "stack_bytes": 0}}
    assert kt.sass_step_ops(_SASS) == {key: {
        "instructions": 4, "float_ops": 3}}
    # K1w, J1 and J2 in kalman_wide.cu's report
    jet = ("_ZN12_GLOBAL__N_118wide_loglik_kernelIdNS_7TangentIdLi2EEELi8E"
           "Li2EEEvPKT_")
    k1w = "_ZN12_GLOBAL__N_118wide_loglik_kernelIffLi13ELi0EEEvPKT_"
    log = "".join(f"""ptxas info    : Compiling entry function '{n}' for 'sm_90a'
ptxas info    : Function properties for {n}
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used {r} registers, used 1 barriers
""" for n, r in ((jet, 128), (k1w, 90)))
    assert kt.wide_nvcc_report(log) == {
        "loglik_hess f64 d08": {"registers": 128, "spill_bytes": 4,
                                "stack_bytes": 8},
        "loglik_wide f32 d13": {"registers": 90, "spill_bytes": 4,
                                "stack_bytes": 8}}
    # J2's bound counts the work of the loglik with gradient and Hessian
    # as a one-thread jet computes it; J1's, with first-order jets; both
    # over K directions (K = 4 at d = 2: h and R Q R''s upper triangle)
    assert kt.jet_step_flops(2, 4) == 2127
    assert kt.dual_step_flops(2, 4) < kt.jet_step_flops(2, 4)
    assert kt.jet_step_flops(8, 3) < kt.jet_step_flops(8, 37)
    assert kt.jet_step_flops(2, 3) < kt.jet_step_flops(2, 4)

"""Sequential Kalman recurrences through the hand-written CUDA kernels of
``csrc/kalman_seq.cu`` (K1 and K2: one thread a series walking the T steps)
and ``csrc/kalman_wide.cu`` (K1w in float32 to d = 13: a thread a system,
P in its registers; K1w past it and in float64, K2w and K3: a group of
lanes a chain or series, 32 / W groups a warp, a lane a row of the state;
J1 and J2: a warp a (series, direction or pair); d fixed at compile
time).

The reference runs these as XLA ``lax.scan``s (boom_tpu/statespace/
kalman.py); in eager PyTorch each step would be a dozen small launches.

- :func:`kalman_loglik` (K1 for d <= 6, K1w for 7 <= d <= 16): the [B]
  marginal log likelihoods of many static systems on one series y [T], or
  on a series a group of systems (y [S, T], S dividing B: bsts with a
  regression, each chain's y - X beta for its TIM points);
  :func:`innovations` runs the same kernels for the prediction errors v and
  variances f [B, T]. A T or z expanded over the systems (stride 0, as
  ``Bsts.ssm_params`` builds them) goes to K1w as its one row, which the
  thread kernel reads as broadcasts.
- :func:`loglik_along` (K1/K1w, J1, J2): the loglik as a function of c
  [B, K], the system moved along K directions (h = h0 + sum_k c_k dh_k,
  R Q R' = Q0 + sum_k c_k dm_k; the TIM mode search's log variances), twice
  differentiable through a ``torch.autograd.Function``: a gradient launches
  J1 (value and gradient, a dual number a unit of (series, direction)),
  a second derivative J2 (value, gradient and Hessian, a hyper-dual
  number a unit of (series, direction pair)), so ``torch.autograd.grad``
  and ``torch.autograd.functional.hessian`` work on the card without
  autograd of a 500-step loop. ``kalman.loglik_jets`` is J1's and J2's plain
  version.
- :func:`simulation_smoother` (K2 for d <= 6, K2w for 7 <= d <= 16): the
  fused Durbin-Koopman simulation smoother, float64, as
  ``kalman.simulation_smoother``; a series a chain ([C, T], bsts with a
  regression: y - X beta) is taken through the observation noise, which
  the smoother uses only in y+ (see :func:`smoother_operands`).
- :func:`dpath` (K3): the ASIS D-path recurrence D_t = T D_{t-1} + w_t of
  every chain's groups, float32 or float64, d 1..16, as ``kalman.dpath``
  (bsts' ASIS pass at every d).

A time-varying system (``SsmParams.time_varying``: z_t, h_t = h h_scale_t,
Q_t = (q_t q_t') o Q) takes the same four kernels in their time-varying
forms (K1 and K2 ``loglik_tv_kernel`` and ``smoother_kernel<D, true>``, K1w
``loglik_tv_warp_kernel<T, D>``, a warp a system), which read
three streams a step (:func:`time_varying_operands`): z_t [T, d], one for
every system; h_scale [T]; and u_t = R q_t [., T, d], where R is a 0/1
selection (at most one 1 a row: every ported block's), so that R Q_t R' =
(u_t u_t') o R Q R'. K2w has two: where every chain shares T (Bsts'),
``smoother_wide_nz_kernel<D, pass>`` runs T's products over its non-zeros
(a :class:`TransitionPattern`, given or found from T), and where each
chain has its own, ``smoother_wide_kernel<D, pass, true>`` (the dense
form): a choice by the operands' layout, each with its ``LAUNCHES`` key.
The loglik's forms take a T shared by every system as its one row, and a
pattern (Bsts hands its own to log_lik and the errors) only to know R a
selection with no read of the host. A calendar's T_t (``SsmParams.t_mats``
of two matrices, ``t_choice``: the monthly cycle's) goes to K1w's form and
to K2w's dense one (:func:`calendar_operands`), each with the two matrices
where it keeps T and a step's choice staged beside its other streams, with
keys of their own ("loglik_wide_tv_calendar", "smoother_wide_tv_calendar");
K1 and K2 (d <= 6, which no calendar block meets) refuse it.
A z a system and an R that is no selection raise, naming their ROADMAP
item.

Dispatch is by the device of the tensors, as in ``scan_kernel.py``: a CUDA
tensor launches the kernel (or raises — there is no fallback), a CPU tensor
runs the plain version in ``kalman.py``. ``LAUNCHES`` counts kernel
launches, so a run can show its main path went through the kernels.
"""

from __future__ import annotations

import copy
import ctypes

import torch

from boom_tpu_torch.kernels import _build
from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace.kalman import SsmParams
from boom_tpu_torch.statespace.scan_kernel import _on_card

# kernel launches since the process started (or a caller's reset);
# incremented only where a kernel is launched
# (K2w's time-varying forms: "smoother_wide_tv" over T's non-zeros,
# "smoother_wide_tv_dense" with a T a chain, "smoother_wide_tv_calendar"
# with the calendar's T_t; K1w's "loglik_wide_tv_calendar" with it)
LAUNCHES = {"loglik": 0, "loglik_wide": 0, "loglik_grad": 0,
            "loglik_hess": 0, "smoother": 0, "smoother_wide": 0, "dpath": 0,
            "loglik_tv": 0, "loglik_wide_tv": 0, "smoother_tv": 0,
            "smoother_wide_tv": 0, "smoother_wide_tv_dense": 0,
            "loglik_wide_tv_calendar": 0, "smoother_wide_tv_calendar": 0}
# the loglik's jets by the order of derivatives they give: J1, J2
JET_KINDS = {1: "loglik_grad", 2: "loglik_hess"}
JET_MAX_DIRECTIONS = _build.JET_MAX_DIRECTIONS
# K1w's layout bits (kalman_wide.cu, kSharedTm and kSharedZ): T, z is one
# matrix, vector of every system
SHARED_T, SHARED_Z = 1, 2

_DTYPE_TAG = {torch.float32: "f32", torch.float64: "f64"}
# block sizes: 0 lets K1 lay its grid out from the card (one block of
# ceil(B / SMs) threads an SM: 128 blocks of 544 at the bsts_llt shape);
# K2's block is one warp, a lane a chain (kalman_seq.cu, kLanes)
LOGLIK_THREADS = 0
SMOOTHER_THREADS = 32
# steps K2 stages into shared memory at a time (kalman_seq.cu, kChunk)
SMOOTHER_CHUNK = 32
# K2w's, K3's and K1w's blocks: four warps, 32 / W units a warp (the jets
# take blocks of one warp whatever it is)
# (kalman_wide.cu)
WIDE_THREADS = 128
DPATH_THREADS = 128
_NO_KERNEL = ("(ROADMAP.md, queue 1 item 7: kernel (b) for state "
              "dimensions past 16 and the other block classes)")
_NOT_SELECTION = ("the time-varying kernels take R Q_t R' as (u_t u_t') o "
                  "R Q R' with u_t = R q_t, which needs R to be a 0/1 "
                  "selection with at most one 1 a row; this R is not "
                  "(ROADMAP.md, queue 1 item 7: the other block classes)")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _observed_bytes(observed, t_len, device):
    """The [T] mask as aligned contiguous bytes on the card, or None (all
    observed)."""
    if observed is None:
        return None
    obs = torch.as_tensor(observed, device=device)
    if obs.shape != (t_len,):
        raise ValueError(f"observed must be [T] = [{t_len}]; got "
                         f"{tuple(obs.shape)}")
    # a fresh allocation: K2 copies the mask 4 bytes at a time
    return torch.empty(t_len, dtype=torch.uint8, device=device).copy_(obs)


def _checked(tensors: dict, dtype, device):
    """Contiguous copies (where needed) after the wrapper's checks."""
    out = {}
    for name, x in tensors.items():
        if x.dtype != dtype:
            raise TypeError(f"{name} is {x.dtype}; every input must be "
                            f"{dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        out[name] = x.contiguous()
    return out


def _shape_check(p, b, d, shared=0):
    """Raise unless every field is [b, ...] (one row for a field taken as
    one of every system: the ``shared`` bits)."""
    want = {"z": (1 if shared & SHARED_Z else b, d),
            "t_mat": (1 if shared & SHARED_T else b, d, d), "rqr": (b, d, d),
            "h": (b,), "a0": (b, d), "p0": (b, d, d)}
    for name, shape in want.items():
        if name in p and tuple(p[name].shape) != shape:
            raise ValueError(f"{name} must be {shape}; got "
                             f"{tuple(p[name].shape)}")


def _series(y, dtype, device):
    y = torch.as_tensor(y, dtype=dtype, device=device)
    if y.dim() != 1:
        raise ValueError("the smoother kernels take one series y [T] shared "
                         f"by all systems; got {tuple(y.shape)}")
    return y.contiguous()


def _series_rows(y, b, dtype, device):
    """The loglik kernels' series: (y [S, T] contiguous, S), as
    ``kalman.series_count`` takes them."""
    y = torch.as_tensor(y, dtype=dtype, device=device)
    s = kalman.series_count(y, b)
    return y.reshape(s, -1).contiguous(), s


def _loglik_operands(h, rqr, z, t_mat, a0, p0, y, observed, dtypes, dims,
                     what, share=False):
    """The loglik kernels' checked operands: (fields, y [S, T], S, mask,
    shared bits). With ``share``, a T or z of stride 0 along the systems (one
    matrix expanded over them, as ``Bsts.ssm_params`` builds it) is passed
    as its one row, its bit set: the layout alone decides, never its
    values."""
    dtype, device = h.dtype, h.device
    if _DTYPE_TAG.get(dtype) not in dtypes:
        names = {"f32": "float32", "f64": "float64"}
        raise TypeError(f"the {what} run "
                        f"{' or '.join(names[t] for t in dtypes)}, not "
                        f"{dtype}")
    b, d = z.shape
    if d not in dims:
        raise NotImplementedError(
            f"the {what} takes state dims {dims[0]}..{dims[-1]}, not {d} "
            + _NO_KERNEL)
    fields = {"z": z, "t_mat": t_mat, "rqr": rqr, "h": h, "a0": a0,
              "p0": p0}
    shared = 0
    for bit, name in ((SHARED_T, "t_mat"), (SHARED_Z, "z")):
        x = fields[name]
        if share and b > 1 and x.shape[0] == b and x.stride(0) == 0:
            fields[name] = x[:1]
            shared |= bit
    p = _checked(fields, dtype, device)
    _shape_check(p, b, d, shared)
    y, n_series = _series_rows(y, b, dtype, device)
    return (p, y, n_series, _observed_bytes(observed, y.shape[1], device),
            shared)


_FIELDS = ("z", "t_mat", "rqr", "h", "a0", "p0")


def _is_selection(r_mat):
    """R [B, d, q] is 0/1 with at most one 1 a row (one host sync)."""
    r = r_mat[:1] if r_mat.shape[0] > 1 and r_mat.stride(0) == 0 else r_mat
    return bool((((r == 0) | (r == 1)).all()
                 & ((r != 0).sum(-1) <= 1).all()).item())


def _one_of_all(x):
    """x [B, ...] holds one row for every system: B = 1, or stride 0."""
    return x.shape[0] == 1 or x.stride(0) == 0


def expands(x, own):
    """x [B, ...] is ``own`` expanded over B (or B = 1): the same memory,
    dtype and device."""
    return (x.dtype == own.dtype and x.device == own.device
            and _one_of_all(x) and tuple(x.shape[1:]) == tuple(own.shape)
            and x[0].data_ptr() == own.data_ptr()
            and x[0].stride() == own.stride())


def _expands(x, own, version):
    """:func:`expands`, and ``own`` not written since its ``_version`` was
    ``version``."""
    return (own is not None and expands(x, own)
            and own._version == version)


class TransitionPattern:
    """T's non-zeros and R's selection of a system whose chains all share
    one T [d, d] and one R [d, q] (Bsts': no block's T or R moves with a
    chain's parameters), found once with one read of the host. K2w's
    structured time-varying form takes T's rows, their columns and values
    (``rows``, ``values``), as kernel parameters; and where ``r_mat`` is a
    selection (``selection``), u_t = R q_t is formed without
    ``_is_selection``'s read. ``t_mat`` and ``r_mat`` are the tensors they
    were found from: a system whose T and R are these, expanded over its
    chains and not written since, agrees with no further read, and any
    other T is compared with the pattern on the host (:meth:`check`)."""

    def __init__(self, t_mat, r_mat=None):
        d = t_mat.shape[-1]
        if tuple(t_mat.shape) != (d, d):
            raise ValueError(f"a transition pattern takes one T [d, d]; got "
                             f"{tuple(t_mat.shape)}")
        self.t_mat, self.r_mat = t_mat, r_mat
        self._versions = (t_mat._version,
                          None if r_mat is None else r_mat._version)
        t = t_mat.detach().to("cpu", torch.float64)
        self.rows = tuple(tuple(int(j) for j in torch.nonzero(t[i])[:, 0])
                          for i in range(d))
        self.values = tuple(tuple(float(t[i, j]) for j in cols)
                            for i, cols in enumerate(self.rows))
        self.selection = r_mat is not None and _is_selection(r_mat[None])
        ptr = [0]
        for cols in self.rows:
            ptr.append(ptr[-1] + len(cols))
        n = max(ptr[-1], 1)
        self._csr = ((ctypes.c_int * (d + 1))(*ptr),
                     (ctypes.c_int * n)(*(j for c in self.rows for j in c)),
                     (ctypes.c_double * n)(*(v for r in self.values
                                             for v in r)))

    @property
    def nnz(self):
        return sum(len(cols) for cols in self.rows)

    def row_counts(self):
        """T's non-zeros a row."""
        return tuple(len(cols) for cols in self.rows)

    def csr_pointers(self):
        """Host addresses of T's CSR arrays: rowptr [d + 1] ints, the
        columns (ints) and the values (doubles)."""
        return [ctypes.addressof(a) for a in self._csr]

    def bound(self, t_mat, r_mat=None):
        """This pattern for another copy of its T and R (the model's T and
        R in its run's dtype, which this one's were cast from: the caller
        vouches for their values), so that a system expanding those is
        known to be the pattern's with no read."""
        other = copy.copy(self)
        other.t_mat, other.r_mat = t_mat, r_mat
        other._versions = (t_mat._version,
                           None if r_mat is None else r_mat._version)
        return other

    def owns_r(self, r_mat):
        """R [B, d, q] is this pattern's R, expanded (no read)."""
        return _expands(r_mat, self.r_mat, self._versions[1])

    def check(self, t_mat):
        """Raise ValueError unless T [B, d, d] is the pattern's: its own
        tensor expanded and not written since (no read), or else, compared
        on the host, every chain's T with the pattern's values at its
        non-zeros and 0 elsewhere."""
        if _expands(t_mat, self.t_mat, self._versions[0]):
            return
        d = len(self.rows)
        want = torch.zeros(d, d, dtype=torch.float64)
        for i, (cols, vals) in enumerate(zip(self.rows, self.values)):
            want[i, list(cols)] = torch.tensor(vals, dtype=torch.float64)
        t = t_mat[:1] if _one_of_all(t_mat) else t_mat
        got = t.detach().to("cpu", torch.float64)
        if tuple(got.shape[1:]) != (d, d) or not bool((got == want).all()):
            raise ValueError(
                "the transition pattern disagrees with T: the kernels would "
                "take T's non-zeros from the pattern; pass the T it was "
                "found from, or none (the pattern is then found from T)")


def _pattern_found(params: SsmParams):
    """The pattern of the system's T, one for every chain, found from T (a
    read of the host)."""
    r = params.r_mat
    return TransitionPattern(params.t_mat[0],
                             r[0] if _one_of_all(r) else None)


def time_varying_operands(params: SsmParams, t_len, dtype, device,
                          pattern=None):
    """The time-varying kernels' streams of ``params``: (zt [T, d], one z_t
    for every system; hs [T], h_t = h hs[t]; u [U, T, d], u_t = R q_t;
    u_stride, T d where U = B, 0 where U = 1), contiguous, in ``dtype``. A
    field the system keeps static becomes its stream (z broadcast along T,
    hs and u ones). u is one row where q_scale and R are one expanded over
    the systems (stride 0). R is known to be a selection where it is a
    ``pattern``'s own selection (no read of the host), else it is checked.
    Raises NotImplementedError for a z a system (``kalman.check_system``)
    and an R that is no selection."""
    kalman.check_system(params)
    b, d = params.h.shape[0], params.t_mat.shape[-1]
    z = params.z
    if z.dim() == 2 and b > 1 and z.stride(0) != 0:
        raise NotImplementedError(kalman._PER_SYSTEM_Z)
    zt = z[0] if z.dim() == 3 else z[0].expand(t_len, d)
    hs = (params.h_scale if params.h_scale is not None
          else torch.ones(t_len, dtype=dtype, device=device))
    q = params.q_scale
    if q is None:
        u = torch.ones(1, t_len, d, dtype=dtype, device=device)
    else:
        r = params.r_mat
        known = (pattern is not None and pattern.selection
                 and pattern.owns_r(r))
        if not known and not _is_selection(r):
            raise NotImplementedError(_NOT_SELECTION)
        if _one_of_all(r) and _one_of_all(q):
            u = torch.einsum("dq,tq->td", r[0], q[0])[None]
        else:
            u = torch.einsum("bdq,btq->btd", r, q)
    ops = _checked({"zt": zt, "hs": hs, "u": u.to(dtype)}, dtype, device)
    if (ops["zt"].shape != (t_len, d) or ops["hs"].shape != (t_len,)
            or ops["u"].shape[1:] != (t_len, d)
            or ops["u"].shape[0] not in (1, b)):
        raise ValueError(f"a time-varying system's z [T, d], h_scale [T] and "
                         f"q_scale [B, T, q] must span T = {t_len} steps")
    u_stride = 0 if ops["u"].shape[0] == 1 else t_len * d
    return ops["zt"], ops["hs"], ops["u"], u_stride


# distinct T_t the calendar forms of K1w and K2w take (kalman_wide.cu)
CALENDAR_MATRICES = 2
_NO_CALENDAR = ("K1 and K2 (d <= 6) take no time-varying T; the calendar's "
                "T_t runs in K1w and K2w, d 7..16 (ROADMAP.md, queue 1 "
                "item 7: T_t in the narrow kernels)")


def calendar_operands(params: SsmParams, t_len, dtype, device):
    """A calendar's T_t as K1w's and K2w's calendar forms take it: (its
    matrices [U, 2, d, d] contiguous, U = 1 where every system shares them
    (stride 0) else B; the step's choice [T] bytes; the shared bit), or
    (None, None, 0) where the system has no T_t. One distinct matrix is
    the calendar's two alike; more than CALENDAR_MATRICES raise."""
    if params.t_choice is None:
        return None, None, 0
    mats = params.t_mats
    b, k, d = params.h.shape[0], mats.shape[1], mats.shape[-1]
    if d not in _build.WIDE_DIMS:
        raise NotImplementedError(_NO_CALENDAR)
    if k > CALENDAR_MATRICES or tuple(mats.shape) != (b, k, d, d):
        raise NotImplementedError(
            f"the kernels take a T_t of at most {CALENDAR_MATRICES} distinct "
            f"matrices [B, K, d, d]; got {tuple(mats.shape)} (ROADMAP.md, "
            "queue 1 item 7: T_t of more than two matrices)")
    shared = 1 if b > 1 and mats.stride(0) == 0 else 0
    if shared:
        mats = mats[:1]
    if k == 1:
        mats = mats.expand(-1, CALENDAR_MATRICES, -1, -1)
    sel = torch.as_tensor(params.t_choice, device=device)
    if tuple(sel.shape) != (t_len,):
        raise ValueError(f"t_choice must be [T] = [{t_len}]; got "
                         f"{tuple(sel.shape)}")
    if k == 1:
        sel = torch.zeros_like(sel)
    mats = _checked({"t_mats": mats}, dtype, device)["t_mats"]
    return (mats, torch.empty(t_len, dtype=torch.uint8,
                              device=device).copy_(sel), shared)


def launch_loglik(h, rqr, z, t_mat, a0, p0, y, observed, innovations=False):
    """The loglik on the card, K1 (d <= 6) or K1w (7 <= d <= 16), float32
    or float64 -> ll [B]; with ``innovations`` (ll, v [B, T], f [B, T]).
    y: [T], or [S, T] with S dividing B (system b reads series b // (B/S))."""
    tags, dims = _build.KALMAN_ENTRIES["loglik"]
    wide = z.shape[-1] in _build.WIDE_DIMS
    p, y, n_series, obs, shared = _loglik_operands(
        h, rqr, z, t_mat, a0, p0, y, observed, tags,
        dims + _build.WIDE_DIMS, "loglik kernels (K1, K1w)", share=wide)
    b, d, t_len = p["h"].shape[0], p["z"].shape[1], y.shape[1]
    out = [torch.empty(b, dtype=h.dtype, device=h.device)]
    if innovations:
        out += [torch.empty(b, t_len, dtype=h.dtype, device=h.device)
                for _ in range(2)]
    ptrs = [p[k].data_ptr() for k in _FIELDS] + [y.data_ptr(), _ptr(obs)]
    ptrs += [out[0].data_ptr(), *(_ptr(o) for o in (out[1:] or (None,) * 2))]
    tag = _DTYPE_TAG[h.dtype]
    if wide:
        kind = "loglik_wide"
        rc = getattr(_build.library("kalman_wide"),
                     f"boom_kalman_loglik_wide_{tag}")(
            *ptrs, b, t_len, n_series, d, shared, WIDE_THREADS,
            _stream(h.device))
    else:
        kind = "loglik"
        rc = getattr(_build.library("kalman_seq"),
                     f"boom_kalman_loglik_{tag}_d{d}")(
            *ptrs, b, t_len, n_series, LOGLIK_THREADS, _stream(h.device))
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return tuple(out) if innovations else out[0]


def launch_loglik_tv(params: SsmParams, y, observed, innovations=False,
                     pattern=None):
    """The loglik of a time-varying system on the card, K1's (d <= 6) or
    K1w's (7 <= d <= 16) time-varying form, float32 or float64 -> ll [B];
    with ``innovations`` (ll, v [B, T], f [B, T]). y as
    :func:`launch_loglik` takes it; the streams of
    :func:`time_varying_operands`. A T shared by every system (one matrix
    expanded over them, as ``Bsts.ssm_params`` builds it) goes to the
    kernels as its one row. ``pattern``: a :class:`TransitionPattern` of T
    and R (Bsts gives its own), checked against T (no read where T is its
    own), whose R is then known a selection with no read of the host; one
    that disagrees with T raises ValueError."""
    h = params.h
    dtype, device = h.dtype, h.device
    tags, dims = _build.KALMAN_ENTRIES["loglik_tv"]
    if _DTYPE_TAG.get(dtype) not in tags:
        raise TypeError(f"the loglik kernels (K1, K1w) run float32 or "
                        f"float64, not {dtype}")
    b, d = h.shape[0], params.t_mat.shape[-1]
    wide = d in _build.WIDE_DIMS
    if d not in dims and not wide:
        raise NotImplementedError(
            f"the loglik kernels (K1, K1w) take state dims {dims[0]}.."
            f"{_build.WIDE_DIMS[-1]}, not {d} " + _NO_KERNEL)
    if params.t_choice is not None and not wide:
        raise NotImplementedError(_NO_CALENDAR)
    fields = {"t_mat": params.t_mat, "rqr": params.rqr, "h": h,
              "a0": params.a0, "p0": params.p0}
    shared = 0
    if b > 1 and params.t_mat.stride(0) == 0:
        fields["t_mat"] = params.t_mat[:1]
        shared = SHARED_T
    p = _checked(fields, dtype, device)
    _shape_check(p, b, d, shared)
    if pattern is not None:
        pattern.check(params.t_mat)
    y, n_series = _series_rows(y, b, dtype, device)
    t_len = y.shape[1]
    zt, hs, u, u_stride = time_varying_operands(params, t_len, dtype, device,
                                                pattern)
    mats, sel, cal_shared = calendar_operands(params, t_len, dtype, device)
    if mats is not None:
        p["t_mat"], shared = mats, SHARED_T if cal_shared else 0
    obs = _observed_bytes(observed, t_len, device)
    out = [torch.empty(b, dtype=dtype, device=device)]
    if innovations:
        out += [torch.empty(b, t_len, dtype=dtype, device=device)
                for _ in range(2)]
    ptrs = [p[k].data_ptr() for k in ("t_mat", "rqr", "h", "a0", "p0")]
    ptrs += [y.data_ptr(), _ptr(obs), zt.data_ptr(), hs.data_ptr(),
             u.data_ptr()]
    outs = [out[0].data_ptr(), *(_ptr(o) for o in (out[1:] or (None,) * 2))]
    tag = _DTYPE_TAG[dtype]
    if wide:
        kind = ("loglik_wide_tv" if sel is None
                else "loglik_wide_tv_calendar")
        rc = getattr(_build.library("kalman_wide"),
                     f"boom_kalman_loglik_wide_tv_{tag}")(
            *ptrs, _ptr(sel), *outs, b, t_len, n_series, d, shared, u_stride,
            _stream(device))
    else:
        kind = "loglik_tv"
        rc = getattr(_build.library("kalman_seq"),
                     f"boom_kalman_loglik_tv_{tag}_d{d}")(
            *ptrs, *outs, b, t_len, n_series, shared, u_stride,
            _stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return tuple(out) if innovations else out[0]


def launch_jets(h, rqr, z, t_mat, a0, p0, y, observed, dh, dm, order):
    """J1 (``order`` 1) -> (ll [B], grad [B, K]) or J2 (2) -> (ll, grad,
    hess [B, K, K]) on the card: the loglik and its derivatives along the
    directions dh [K], dm [K, d, d] at (h, R Q R'), float64, d 1..16,
    1 <= K <= JET_MAX_DIRECTIONS; y as :func:`launch_loglik` takes it. A
    static system only: z [B, d], h [B]."""
    if z.dim() != 2 or h.dim() != 1:
        raise NotImplementedError(
            "the loglik's derivative kernels (J1, J2) take static systems; "
            "the TIM move on a time-varying system is not ported yet "
            "(ROADMAP.md, queue 1 item 7)")
    p, y, n_series, obs, _shared = _loglik_operands(
        h, rqr, z, t_mat, a0, p0, y, observed, ("f64",), _build.JET_DIMS,
        "loglik's derivative kernels")
    (b, d), t_len = p["z"].shape, y.shape[1]
    k = dh.shape[0] if dh.dim() == 1 else -1
    if not 1 <= k <= JET_MAX_DIRECTIONS or tuple(dm.shape) != (k, d, d):
        raise NotImplementedError(
            f"the loglik's derivative kernels take 1..{JET_MAX_DIRECTIONS} "
            f"directions dh [K], dm [K, {d}, {d}]; got {tuple(dh.shape)}, "
            f"{tuple(dm.shape)} (kalman_wide.cu, kMaxDirections)")
    dirs = _checked({"dh": dh, "dm": dm}, h.dtype, h.device)
    out = [torch.empty(b, dtype=h.dtype, device=h.device),
           torch.empty(b, k, dtype=h.dtype, device=h.device)]
    if order == 2:
        out.append(torch.empty(b, k, k, dtype=h.dtype, device=h.device))
    ptrs = [p[name].data_ptr() for name in _FIELDS]
    ptrs += [y.data_ptr(), _ptr(obs), dirs["dh"].data_ptr(),
             dirs["dm"].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
             _ptr(out[2] if order == 2 else None)]
    rc = _build.library("kalman_wide").boom_kalman_jet_f64(
        *ptrs, b, t_len, n_series, d, k, order, WIDE_THREADS,
        _stream(h.device))
    kind = JET_KINDS[order]
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return tuple(out)


class _GradAlong(torch.autograd.Function):
    """The loglik's gradient [B, K] in c as a function of c, whose own
    derivative is the saved Hessian: what makes :class:`_LoglikAlong`
    differentiable twice."""

    @staticmethod
    def forward(ctx, c, grad, hess):
        ctx.save_for_backward(hess)
        return grad.clone()

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_grad):
        (hess,) = ctx.saved_tensors
        return (hess @ g_grad[..., None])[..., 0], None, None


class _LoglikAlong(torch.autograd.Function):
    """K1 / K1w as a function of c [B, K] (:func:`loglik_along`); the
    system's other fields, the directions, the series and the mask are
    constants. The forward pass launches K1 or K1w, or J1 when a gradient
    is wanted; the backward pass returns J1's gradient, or launches J2 when
    a second derivative can be asked of it (grad mode on inside backward:
    ``create_graph=True``, as ``torch.autograd.functional.hessian`` sets
    it)."""

    @staticmethod
    def forward(ctx, c, h0, q0, dh, dm, z, t_mat, a0, p0, y, observed):
        if any(ctx.needs_input_grad[1:]):
            raise NotImplementedError(
                "the loglik kernels differentiate along the directions' "
                "coefficients c only (ROADMAP.md, queue 1 item 7: kernel (b))")
        h, rqr = kalman.along(h0, q0, dh, dm, c)
        fields = (h, rqr, z, t_mat, a0, p0, y, observed)
        if not ctx.needs_input_grad[0]:
            return launch_loglik(*fields)
        ll, grad = launch_jets(*fields, dh, dm, order=1)
        ctx.save_for_backward(c, grad)
        ctx.fields = fields + (dh, dm)
        return ll

    @staticmethod
    def backward(ctx, g_ll):
        c, grad = ctx.saved_tensors
        if torch.is_grad_enabled():
            _ll, grad, hess = launch_jets(*ctx.fields, order=2)
            grad = _GradAlong.apply(c, grad, hess)
        return (grad * g_ll[:, None],) + (None,) * 10


def loglik_along(c, h0, q0, dh, dm, z, t_mat, a0, p0, y, observed=None):
    """[B] loglik of the systems (z, t_mat, a0, p0 [B, ...]) with h = h0 +
    c @ dh and R Q R' = q0 + sum_k c_k dm_k (``kalman.along``), c [B, K],
    on y [T] or [S, T] (S dividing B). Twice differentiable in c: on a CUDA
    tensor through K1 / K1w, J1 and J2 (:class:`_LoglikAlong`), on a CPU
    tensor by autograd of the plain loop (``kalman.loglik_along``)."""
    if not _on_card(c):
        return kalman.loglik_along(c, h0, q0, dh, dm, z, t_mat, a0, p0, y,
                                   observed)
    return _LoglikAlong.apply(c, h0, q0, dh, dm, z, t_mat, a0, p0, y,
                              observed)


def kalman_loglik(params: SsmParams, y, observed=None, pattern=None):
    """[B] marginal log likelihoods of the systems ``params`` (leading
    series axis B) on y [T] or [S, T], S dividing B (K1 or K1w on a CUDA
    tensor, the plain ``kalman.kalman_loglik`` on a CPU tensor). On the card
    it is a value only: derivatives are taken along directions of the
    system with :func:`loglik_along`. ``pattern``: a
    :class:`TransitionPattern` of a time-varying system's T and R (Bsts
    gives its own), checked against T on either device."""
    if not _on_card(params.h):
        if pattern is not None:
            pattern.check(params.t_mat)
        return kalman.kalman_loglik(params, y, observed)
    kalman.check_system(params)
    if torch.is_grad_enabled() and any(
            f is not None and f.requires_grad for f in params):
        raise NotImplementedError(
            "kalman_kernel.kalman_loglik gives no derivatives on the card: "
            "move the system along directions with loglik_along (J1, J2)")
    if params.time_varying:
        return launch_loglik_tv(params, y, observed, pattern=pattern)
    return launch_loglik(params.h, params.rqr, params.z, params.t_mat,
                         params.a0, params.p0, y, observed)


def innovations(params: SsmParams, y, observed=None, pattern=None):
    """(v, f) [B, T]: the one-step prediction errors and their variances of
    every system on y [T] or [S, T] (K1 or K1w on a CUDA tensor, the plain
    ``kalman.kalman_loglik(..., innovations=True)`` on a CPU tensor);
    ``pattern`` as :func:`kalman_loglik` takes it."""
    if not _on_card(params.h):
        if pattern is not None:
            pattern.check(params.t_mat)
        return kalman.kalman_loglik(params, y, observed, innovations=True)[1:]
    kalman.check_system(params)
    if params.time_varying:
        return launch_loglik_tv(params, y, observed, innovations=True,
                                pattern=pattern)[1:]
    return launch_loglik(params.h, params.rqr, params.z, params.t_mat,
                         params.a0, params.p0, y, observed,
                         innovations=True)[1:]


def simulation_smoother(params: SsmParams, y, alpha1_z, eta_z, eps_z,
                        observed=None, pattern=None):
    """alpha+ + E_0[alpha | y - y+] [C, T, d] for every chain (K2 or K2w on
    a CUDA tensor, the plain ``kalman.simulation_smoother`` on a CPU
    tensor). y: [T], or [C, T] a series a chain. Normals as
    ``kalman.simulation_smoother`` takes them. ``pattern``: a
    :class:`TransitionPattern` of the system's T and R (Bsts finds its own
    once a model), checked against T on either device."""
    if not _on_card(params.h):
        if pattern is not None:
            pattern.check(params.t_mat)
        return kalman.simulation_smoother(params, y, alpha1_z, eta_z, eps_z,
                                          observed)
    return launch_smoother(*smoother_operands(params, y, alpha1_z, eta_z,
                                              eps_z, observed, pattern))


def smoother_operands(params: SsmParams, y, alpha1_z, eta_z, eps_z,
                      observed=None, pattern=None):
    """K2's (d <= 6) or K2w's (7 <= d <= 16) checked, contiguous operands:
    ({name: tensor}, y [T], the mask bytes or None). The draws' noise
    (alpha_1, w = R chol(Q) eta, sqrt(h) eps) is formed here by
    ``kalman.simulation_inputs``, as the plain version forms it. The
    kernels take one series y [T] for all chains; a series a chain y_c
    [C, T] enters through the observation noise: the smoother reads eps
    only in y - y+ = y - (z' alpha+ + eps), so y_c with eps is the shared
    series 0 with eps - y_c (the same draw up to rounding). A time-varying
    system adds the streams of :func:`time_varying_operands` ("zt", "hs",
    "u" and the int "u_stride") and drops z; at 7 <= d <= 16 where every
    chain shares T, also "nz", the :class:`TransitionPattern` of its T
    (``pattern`` once checked against T, or one found from T), which
    K2w's structured form takes in T's place (T is then not copied). A
    calendar's T_t takes K2w's dense form: "t_mat" its two matrices, "sel"
    the step's choice and "t_shared" (:func:`calendar_operands`). A given
    ``pattern`` that disagrees with T raises ValueError."""
    kalman.check_system(params)
    dtype, device = params.h.dtype, params.h.device
    tags, dims = _build.KALMAN_ENTRIES["smoother"]
    if _DTYPE_TAG.get(dtype) not in tags:
        raise TypeError(f"the smoother kernel runs float64 (bsts."
                        f"SMOOTHER_DTYPE), not {dtype}")
    c, d = params.h.shape[0], params.t_mat.shape[-1]
    if d not in dims and d not in _build.WIDE_DIMS:
        raise NotImplementedError(
            f"the smoother kernels take state dims {dims} (K2) and "
            f"{_build.WIDE_DIMS[0]}..{_build.WIDE_DIMS[-1]} (K2w), not {d} "
            + _NO_KERNEL)
    y = torch.as_tensor(y, dtype=dtype, device=device)
    per_chain = y.dim() == 2
    if per_chain and tuple(y.shape) != (c, y.shape[-1]):
        raise ValueError(f"a series a chain must be [{c}, T]; got "
                         f"{tuple(y.shape)}")
    t_len = y.shape[-1]
    alpha1, w, eps = kalman.simulation_inputs(params, alpha1_z, eta_z,
                                              eps_z)
    if per_chain:
        eps = eps - y
        y = y.new_zeros(t_len)
    y = _series(y, dtype, device)
    if params.t_choice is not None and d not in _build.WIDE_DIMS:
        raise NotImplementedError(_NO_CALENDAR)
    # K2w's structured form: a pattern given, or one T for every chain
    # (and no calendar)
    structured = (params.time_varying and d in _build.WIDE_DIMS
                  and params.t_choice is None
                  and (pattern is not None or _one_of_all(params.t_mat)))
    fields = {"t_mat": params.t_mat, "rqr": params.rqr, "h": params.h,
              "p0": params.p0, "alpha1": alpha1, "w": w, "eps": eps}
    if not params.time_varying:
        fields["z"] = params.z
    if structured:
        # it reads T's non-zeros from the pattern: T is checked where it
        # lies (its first row), not copied
        _checked({"t_mat": fields.pop("t_mat")[:1]}, dtype, device)
    p = _checked(fields, dtype, device)
    _shape_check({**p, "t_mat": params.t_mat}, c, d)
    if p["w"].shape != (c, t_len - 1, d) or p["eps"].shape != (c, t_len):
        raise ValueError(f"normals must give w [{c}, {t_len - 1}, {d}] and "
                         f"eps [{c}, {t_len}]")
    if pattern is not None:
        pattern.check(params.t_mat)
    elif structured:
        pattern = _pattern_found(params)
    if params.time_varying:
        p["zt"], p["hs"], p["u"], p["u_stride"] = time_varying_operands(
            params, t_len, dtype, device, pattern)
        mats, p["sel"], p["t_shared"] = calendar_operands(params, t_len,
                                                          dtype, device)
        if mats is not None:
            p["t_mat"] = mats
    if structured:
        p["nz"] = pattern
    return p, y, _observed_bytes(observed, t_len, device)


def launch_smoother(p, y, obs):
    """K2 (d <= 6) or K2w on operands from :func:`smoother_operands` ->
    [C, T, d], in their time-varying forms where the operands hold the
    time-varying streams (K2w's structured form where they hold "nz")."""
    (c, d), t_len = p["alpha1"].shape, y.shape[0]
    scratch = p["alpha1"].new_empty(c, t_len, d + 1)
    out = p["alpha1"].new_empty(c, t_len, d)
    if "zt" in p:
        ptrs = [p[k].data_ptr() for k in ("rqr", "h", "p0", "alpha1", "w",
                                          "eps")]
        ptrs += [y.data_ptr(), _ptr(obs), p["zt"].data_ptr(),
                 p["hs"].data_ptr(), p["u"].data_ptr(), scratch.data_ptr(),
                 out.data_ptr()]
        if "nz" in p:
            kind = "smoother_wide_tv"
            rc = _build.library(
                "kalman_wide").boom_kalman_smoother_wide_nz_f64(
                *ptrs, *p["nz"].csr_pointers(), c, t_len, p["u_stride"],
                d, WIDE_THREADS, _stream(y.device))
        elif d in _build.WIDE_DIMS:
            kind = ("smoother_wide_tv_dense" if p["sel"] is None
                    else "smoother_wide_tv_calendar")
            rc = _build.library(
                "kalman_wide").boom_kalman_smoother_wide_tv_f64(
                p["t_mat"].data_ptr(), *ptrs[:-2], _ptr(p["sel"]), *ptrs[-2:],
                c, t_len, p["u_stride"], p["t_shared"], d, WIDE_THREADS,
                _stream(y.device))
        else:
            kind = "smoother_tv"
            fn = getattr(_build.library("kalman_seq"),
                         f"boom_kalman_smoother_tv_f64_d{d}")
            rc = fn(p["t_mat"].data_ptr(), *ptrs, c, t_len, p["u_stride"],
                    SMOOTHER_THREADS, _stream(y.device))
        if rc != 0:
            raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
        LAUNCHES[kind] += 1
        return out
    ptrs = [p[k].data_ptr() for k in ("z", "t_mat", "rqr", "h", "p0",
                                      "alpha1", "w", "eps")]
    ptrs += [y.data_ptr(), _ptr(obs), scratch.data_ptr(), out.data_ptr()]
    if d in _build.WIDE_DIMS:
        kind = "smoother_wide"
        rc = _build.library("kalman_wide").boom_kalman_smoother_wide_f64(
            *ptrs, c, t_len, d, WIDE_THREADS, _stream(y.device))
    else:
        kind = "smoother"
        fn = getattr(_build.library("kalman_seq"),
                     f"boom_kalman_smoother_f64_d{d}")
        rc = fn(*ptrs, c, t_len, SMOOTHER_THREADS, _stream(y.device))
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} launch failed: cudaError {rc}")
    LAUNCHES[kind] += 1
    return out


def dpath(t_mat, w):
    """ASIS D-paths [C, G, T, d] (D_0 = 0, D_t = T_c D_{t-1} + w_{c,g,t})
    of t_mat [C, d, d] and w [C, G, T-1, d] (K3 on a CUDA tensor, the plain
    ``kalman.dpath`` on a CPU tensor)."""
    if not _on_card(w):
        return kalman.dpath(t_mat, w)
    return launch_dpath(t_mat, w)


def launch_dpath(t_mat, w):
    """K3 on the card: checks, then one launch -> [C, G, T, d]."""
    dtype, device = w.dtype, w.device
    if dtype not in _DTYPE_TAG:
        raise TypeError(f"the D-path kernel runs float32 or float64, not "
                        f"{dtype}")
    c, g, t_m1, d = w.shape
    if d not in _build.DPATH_DIMS:
        raise NotImplementedError(
            f"the D-path kernel takes state dims {_build.DPATH_DIMS[0]}.."
            f"{_build.DPATH_DIMS[-1]}, not {d} " + _NO_KERNEL)
    p = _checked({"t_mat": t_mat, "w": w}, dtype, device)
    if p["t_mat"].shape != (c, d, d):
        raise ValueError(f"t_mat must be {(c, d, d)}; got "
                         f"{tuple(p['t_mat'].shape)}")
    # K3 reads w and writes D 16 bytes at a time from 16-byte boundaries
    w = p["w"] if p["w"].data_ptr() % 16 == 0 else p["w"].clone()
    out = w.new_empty(c, g, t_m1 + 1, d)
    fn = getattr(_build.library("kalman_wide"),
                 f"boom_dpath_{_DTYPE_TAG[dtype]}")
    rc = fn(p["t_mat"].data_ptr(), w.data_ptr(), out.data_ptr(), c, g,
            t_m1 + 1, d, DPATH_THREADS, _stream(device))
    if rc != 0:
        raise RuntimeError(f"CUDA dpath launch failed: cudaError {rc}")
    LAUNCHES["dpath"] += 1
    return out

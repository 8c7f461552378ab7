"""The port's RWKV6 path (``repro_torch.kernels.wkv6``, ``nn.rwkv``,
``models.rwkv6``, ``serving.engine``, ``launch.serve``) against the JAX
package, on the CPU.

The oracle is the JAX package's jnp code (``_wkv6_chunked``,
``wkv6_reference``, the model and its serving engine), never its Pallas
kernel ``wkv6_pallas`` (ROADMAP.md §3, R1).  Inputs come from numpy seeds;
weights from the JAX init, carried across by ``params_from_jax``, with the
leaves that the init rules leave at zero (``mu*``, ``lora_B``, ``w0``,
``w_B``, ``u``) redrawn by ``repro_torch.nn.rwkv.rwkv_redraw``: at zero
every token and channel would see the same decay and no bonus, and a
kernel that read the wrong channel of the decays or dropped the bonus
would pass.
"""
import dataclasses
import functools
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro.nn import rwkv as jrwkv
from repro.serving import engine as jengine
from repro_torch.core import config as tconfig
from repro_torch.kernels import _build
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref, wkv6_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as tregistry
from repro_torch.models.common import CACHE_BATCH_AXIS, params_from_jax
from repro_torch.nn import rwkv as trwkv
from repro_torch.nn.param import tree_leaves, tree_map
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "rwkv6-1.6b"
ROOT = Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

#: the plain K11 against the JAX package's, relative to max(1, max|ref|).
#: fp32: the same function in another order.  The chunked form's decays
#: are exponentials of differences of cumulative sums of up to 64 log
#: decays, each rounded at about |cw| * 2^-24 (|cw| reaches ~100 within a
#: chunk here), and XLA's cumsum rounds differently from torch's, so an
#: output moves by a few 1e-6 of the terms it sums (3e-6 of max|o| seen
#: at 300 steps): 2e-5.  bf16 r/k/v: both sides are fp32 inside and round
#: o once, so they differ by at most one bf16 step of the largest: 2^-7.
TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
#: the model, relative to max(1, max|ref|): fp32 as the kernel (1e-4 on
#: logits through 2 layers); the caches are fp32 states.  bf16 params:
#: every activation is rounded to bf16 some ten times a block, at places
#: the two packages choose differently (silu and the squared relu in bf16
#: in JAX, in fp32 before one rounding in the port) — 2^-4 on logits and
#: the caches, as for the dense models (tests/test_torch_lm.py).
MODEL_TOL = {"float32": {"logits": 1e-4, "cache": 1e-4},
             "bfloat16": {"logits": 2.0 ** -4, "cache": 2.0 ** -4}}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, tol):
    """max |ours - ref| <= tol * max(1, max |ref|)."""
    a, b = _f32(ours), _f32(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(a).all()
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _wkv_inputs(seed, b, s, h, e=64, mean=0.0, sd=0.5):
    """Seeded r, k, v ~ N(0, 1), logw = -exp(N(mean, sd)), u ~ N(0, 0.5)
    and a state ~ N(0, 1), as numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, e)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(mean + sd * rng.standard_normal((b, s, h, e))
                   ).astype(np.float32)
    u = (0.5 * rng.standard_normal((h, e))).astype(np.float32)
    state = rng.standard_normal((b, h, e, e)).astype(np.float32)
    return r, k, v, logw, u, state


def _t(*arrs, dtype=None):
    out = [torch.from_numpy(a) for a in arrs]
    return [t.to(dtype) for t in out] if dtype is not None else out


# -- the plain K11 against the JAX package ------------------------------------


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 16, 50, 64, 100])
def test_plain_k11_matches_jax(s, with_state):
    """Below, at and above the chunk of 64 (100 steps: one chunk and a
    padded one), with and without an initial state: o and the final state
    against JAX's chunked form and its per-step recurrence."""
    r, k, v, logw, u, st = _wkv_inputs(s, 2, s, 3)
    st = st if with_state else None
    o, S = wkv6_chunked_ref(*_t(r, k, v, logw, u), 64,
                            None if st is None else torch.from_numpy(st))
    j = [jnp.asarray(x) for x in (r, k, v, logw, u)]
    js = None if st is None else jnp.asarray(st)
    jo, jS = jrwkv._wkv6_chunked(*j, 64, js)
    ro, rS = jrwkv.wkv6_reference(*j, js)
    for ref_o, ref_S in ((jo, jS), (ro, rS)):
        _close(o, ref_o, TOL["float32"])
        _close(S, ref_S, TOL["float32"])
    # the wrapper takes the plain version for CPU tensors
    wo, wS = wkv6(*_t(r, k, v, logw, u), chunk=64,
                  state=None if st is None else torch.from_numpy(st))
    assert torch.equal(wo, o) and torch.equal(wS, S)


@pytest.mark.parametrize("with_state", [False, True])
def test_plain_recurrence_matches_jax(with_state):
    r, k, v, logw, u, st = _wkv_inputs(3, 2, 37, 2)
    st = st if with_state else None
    o, S = wkv6_reference(*_t(r, k, v, logw, u),
                          None if st is None else torch.from_numpy(st))
    jo, jS = jrwkv.wkv6_reference(*(jnp.asarray(x) for x in
                                    (r, k, v, logw, u)),
                                  None if st is None else jnp.asarray(st))
    _close(o, jo, 1e-5)
    _close(S, jS, 1e-5)


@pytest.mark.parametrize("chunk", [32, 64])
def test_plain_k11_state_hand_off(chunk):
    """Two calls over the halves of a sequence, the second taking the
    first's state, give one call's o and final state."""
    r, k, v, logw, u, _ = _wkv_inputs(4, 1, 150, 2)
    t = _t(r, k, v, logw, u)
    o, S = wkv6_chunked_ref(*t, chunk)
    half = [x[:, :75] for x in t[:4]], [x[:, 75:] for x in t[:4]]
    o1, S1 = wkv6_chunked_ref(*half[0], t[4], chunk)
    o2, S2 = wkv6_chunked_ref(*half[1], t[4], chunk, S1)
    _close(torch.cat([o1, o2], dim=1), o, TOL["float32"])
    _close(S2, S, TOL["float32"])
    jo, jS = jrwkv.wkv6_reference(*(jnp.asarray(x) for x in
                                    (r, k, v, logw, u)))
    _close(S2, jS, TOL["float32"])


def test_plain_k11_strong_decays_stay_finite():
    """logw = -exp(N(2, 1)): a chunk's decays sum far below -88, where a
    product exp(cw_prev_i) exp(-cw_j) would overflow; every factor of the
    chunked form is a difference at most 0."""
    r, k, v, logw, u, st = _wkv_inputs(5, 1, 130, 2, mean=2.0, sd=1.0)
    assert float(np.cumsum(logw[0, :64], axis=0).min()) < -300
    o, S = wkv6_chunked_ref(*_t(r, k, v, logw, u), 64, torch.from_numpy(st))
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    jo, jS = jrwkv.wkv6_reference(*(jnp.asarray(x) for x in
                                    (r, k, v, logw, u)), jnp.asarray(st))
    _close(o, jo, TOL["float32"])
    _close(S, jS, TOL["float32"])


def test_plain_k11_takes_bf16():
    """bf16 r/k/v (the served type): fp32 inside, o in bf16, the state
    fp32, one rounding of JAX's result."""
    r, k, v, logw, u, st = _wkv_inputs(6, 1, 100, 2)
    rb, kb, vb = _t(r, k, v, dtype=torch.bfloat16)
    o, S = wkv6_chunked_ref(rb, kb, vb, *_t(logw, u), 64,
                            torch.from_numpy(st))
    assert o.dtype == torch.bfloat16 and S.dtype == torch.float32
    j = [jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)]
    jo, jS = jrwkv._wkv6_chunked(*j, jnp.asarray(logw), jnp.asarray(u), 64,
                                 jnp.asarray(st))
    _close(o, jo, TOL["bfloat16"])
    _close(S, jS, TOL["float32"])


def test_wkv6_wrapper_checks_its_inputs():
    r, k, v, logw, u, st = _t(*_wkv_inputs(7, 1, 8, 2))
    with pytest.raises(ValueError, match="wkv6"):
        wkv6(r, k[:, :4], v, logw, u, chunk=64)
    with pytest.raises(ValueError, match="wkv6"):
        wkv6(r, k, v, logw, u[:1], chunk=64)
    with pytest.raises(ValueError, match="wkv6"):
        wkv6(r, k, v, logw, u, chunk=64, state=st[:, :1])
    with pytest.raises(ValueError, match="unsupported device"):
        wkv6(*(x.to("meta") for x in (r, k, v, logw, u)), chunk=64)


# -- the smoke's limit of K11 -------------------------------------------------


def _faulty_chunked(r, k, v, logw, u, chunk, fault):
    """The plain K11 with one seeded fault: ``cw`` where ``cw_prev``
    belongs (every intra-chunk and state term of row i gains a factor
    exp(logw_i): the same as r_i * exp(logw_i) there, the bonus
    unchanged), or the u bonus dropped."""
    if fault == "no_bonus":
        return wkv6_chunked_ref(r, k, v, logw, torch.zeros_like(u), chunk)[0]
    rs = (r.float() * torch.exp(logw)).to(r.dtype)
    o, _ = wkv6_chunked_ref(rs, k, v, logw, torch.zeros_like(u), chunk)
    bonus = torch.einsum("bihe,he,bihe->bih", r.float(), u, k.float())
    return (o.float() + bonus[..., None] * v.float()).to(r.dtype)


@pytest.mark.parametrize("dtype,fault", [
    ("bfloat16", "none"), ("bfloat16", "cw_for_cw_prev"),
    ("bfloat16", "no_bonus"), ("float32", "cw_for_cw_prev"),
    ("float32", "no_bonus")])
def test_k11_smoke_limit_rejects_seeded_faults(dtype, fault):
    """``chip_smoke.py`` holds K11 element by element within rtol * |plain|
    + atol (``LM_KERNEL_TOL``).  That limit passes the per-step recurrence
    in bf16 (the same function in another order, rounded once) and fails
    the plain version with either seeded fault in both types.  (In fp32
    the per-step recurrence is no stand-in for the kernel: it forms no
    cumulative sums, and the card holds the kernel, which forms the same
    ones, against the plain chunked form.)"""
    rtol, atol = SMOKE.LM_KERNEL_TOL[dtype]
    dt = getattr(torch, dtype)
    r, k, v, logw, u, _ = _wkv_inputs(8, 1, 300, 2)
    r, k, v = _t(r, k, v, dtype=dt)
    logw, u = _t(logw, u)
    plain, _ = wkv6_chunked_ref(r, k, v, logw, u, 64)
    if fault == "none":
        got = wkv6_reference(r, k, v, logw, u)[0]
    else:
        got = _faulty_chunked(r, k, v, logw, u, 64, fault)
    ok = bool(((got.float() - plain.float()).abs()
               <= rtol * plain.float().abs() + atol).all())
    assert ok == (fault == "none")


# -- K11's chunk-parallel schedule (csrc/wkv6.cu) on the CPU -----------------

LOG2E = np.float32(1.4426950408889634)


def _wk_constants():
    """The integer constants ``WK_*`` as ``csrc/wkv6.cu`` declares them."""
    src = (_build.CSRC / "wkv6.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"\b(WK_[A-Z_]+) = (\d+);", src)}


def _emulate_k11(r, k, v, logw, u, chunk, state=None, exps=None, slices=4):
    """K11's three passes in numpy fp32, as ``csrc/wkv6.cu`` orders them ->
    (o, final state), both fp32.  cw by one sequential sum a channel and
    cw_prev = cw - logw, as the plain version forms them; anchors C_q =
    cw_prev at each sub-chunk's first row (C_4 = cw_L).  Pass 1 the chunks'
    U_c = sum_j (k_j exp(cw_L - cw_j)) v_j^T and D_c = exp(cw_L); pass 2
    the walk S_c = D_c S_{c-1} + U_c, its value columns in ``slices``
    slices walked apart; pass 3 A from the factored off-diagonal blocks
    (r exp(cw_prev - C_q), k exp(C_{p+1} - cw), pair factors exp(C_q -
    C_{p+1})), the diagonal blocks' pairwise exps and the bonus, then o =
    A v + (r exp(cw_prev - C_q) exp(C_q)) S_{c-1}.  Each exp is taken as
    2^(x log2 e); ``exps`` gets (the largest exponent, the largest |cw| it
    came from) of each."""
    f32 = np.float32
    r, k, v, logw = (np.asarray(x, f32) for x in (r, k, v, logw))
    b, s, h, e = r.shape
    L = min(chunk, s)
    nc = -(-s // L)
    lm, sub = wkv6_ops.MAX_CHUNK, wkv6_ops.SUB
    nsub = lm // sub

    def decay(x, cw):
        x = np.asarray(x, f32)
        if exps is not None:
            exps.append((float(x.max()), float(np.abs(cw).max())))
        return np.exp2(x * LOG2E).astype(f32)

    def rows(x, c):  # chunk c of x as [b, h, lm, e], rows past s zero
        out = np.zeros((b, h, lm, e), f32)
        t0 = c * L
        n = min(L, s - t0)
        out[:, :, :n] = x[:, t0:t0 + n].transpose(0, 2, 1, 3)
        return out

    def cumulative(c):  # cw and cw_prev, rows in order
        w = rows(logw, c)
        cw = np.empty_like(w)
        acc = np.zeros((b, h, e), f32)
        for t in range(lm):
            acc = (acc + w[:, :, t]).astype(f32)
            cw[:, :, t] = acc
        return cw, (cw - w).astype(f32)

    U = np.empty((nc, b, h, e, e), f32)
    D = np.empty((nc, b, h, e), f32)
    for c in range(nc):  # pass 1
        cw, _ = cumulative(c)
        total = cw[:, :, -1:]
        D[c] = decay(total[:, :, 0], cw)
        kp = rows(k, c) * decay(total - cw, cw)
        U[c] = np.einsum("bhje,bhjf->bhef", kp, rows(v, c))
    S = (np.zeros((b, h, e, e), f32) if state is None
         else np.array(state, f32))
    Sp = np.empty_like(U)
    width = e // slices
    for sl in range(slices):  # pass 2, one slice of value columns at a time
        cols = slice(sl * width, (sl + 1) * width)
        walk = S[..., cols].copy()
        for c in range(nc):
            Sp[c][..., cols] = walk
            walk = (D[c][..., None] * walk + U[c][..., cols]).astype(f32)
        S[..., cols] = walk
    o = np.zeros((b, s, h, e), f32)
    mi, mj = np.nonzero(np.tril(np.ones((sub, sub), bool), -1))
    per_row = functools.partial(np.repeat, repeats=sub, axis=2)
    for c in range(nc):  # pass 3
        rc, kc, vc = rows(r, c), rows(k, c), rows(v, c)
        cw, cp = cumulative(c)
        C = np.concatenate([cp[:, :, ::sub], cw[:, :, -1:]], axis=2)
        G = decay(C[:, :, :nsub], cw)
        pair = {(2, 0): decay(C[:, :, 2] - C[:, :, 1], cw),
                (3, 1): decay(C[:, :, 3] - C[:, :, 2], cw),
                (3, 0): decay(C[:, :, 3] - C[:, :, 1], cw)}
        A = np.zeros((b, h, lm, lm), f32)
        for q in range(nsub):
            i, j = q * sub + mi, q * sub + mj
            fac = decay(cp[:, :, i] - cw[:, :, j], cw)
            A[:, :, i, j] = np.einsum("bhpe,bhpe->bhp",
                                      rc[:, :, i] * kc[:, :, j], fac)
            d = q * sub + np.arange(sub)
            A[:, :, d, d] = np.einsum("bhie,he,bhie->bhi", rc[:, :, d],
                                      np.asarray(u, f32), kc[:, :, d])
        rt = rc * decay(cp - per_row(C[:, :, :nsub]), cw)
        kt = kc * decay(per_row(C[:, :, 1:]) - cw, cw)
        for q in range(1, nsub):
            for p in range(q):
                kk = kt[:, :, p * sub:(p + 1) * sub]
                if (q, p) in pair:
                    kk = kk * pair[(q, p)][:, :, None]
                A[:, :, q * sub:(q + 1) * sub, p * sub:(p + 1) * sub] = (
                    np.einsum("bhie,bhje->bhij",
                              rt[:, :, q * sub:(q + 1) * sub], kk))
        oc = (np.einsum("bhij,bhjf->bhif", A, vc)
              + np.einsum("bhie,bhef->bhif", rt * per_row(G), Sp[c]))
        t0 = c * L
        n = min(L, s - t0)
        o[:, t0:t0 + n] = oc[:, :, :n].transpose(0, 2, 1, 3)
    return o, S


def _exponents_at_most_noise(exps):
    """Every exponent the emulation forms is <= 0 up to the rounding of
    the cumulative sums it is a difference of (4 ulps of the largest): no
    factor grows past 1 + 2^-21 |cw|."""
    assert exps
    for top, cw in exps:
        assert top <= 4 * np.spacing(np.float32(max(cw, 1.0))), (top, cw)


def _kernel_close(ours, ref, dtype):
    """Element by element within ``chip_smoke.LM_KERNEL_TOL``: the limit
    the card holds K11 to against its plain version."""
    rtol, atol = SMOKE.LM_KERNEL_TOL[dtype]
    a, b = _f32(ours), _f32(ref)
    assert a.shape == b.shape and np.isfinite(a).all()
    over = np.abs(a - b) - (rtol * np.abs(b) + atol)
    assert over.max() <= 0.0, (float(np.abs(a - b).max()), float(over.max()))


def _card_cumsum(x, dim):
    """``torch.cumsum`` as PyTorch's CUDA kernel takes it along an outer
    dim of fp32: one fp32 sum a column, rows in order (the CPU kernel
    accumulates in fp64 and rounds each output)."""
    out = torch.empty_like(x)
    acc = torch.zeros_like(x.select(dim, 0))
    for t in range(x.shape[dim]):
        acc = acc + x.select(dim, t)
        out.select(dim, t).copy_(acc)
    return out


def _plain_on_card(monkeypatch, *args):
    """The plain version with the card's cumulative sums: what the smoke
    holds the kernel to."""
    with monkeypatch.context() as m:
        m.setattr(torch, "cumsum", _card_cumsum)
        return wkv6_chunked_ref(*args)


def test_card_cumsum_is_a_cumsum():
    x = torch.from_numpy(_wkv_inputs(13, 1, 64, 2)[3])
    got = _card_cumsum(x, 1)
    assert torch.allclose(got, torch.cumsum(x, 1), rtol=1e-5, atol=1e-5)
    seq = np.zeros((1, 2, 64), np.float32)
    for t in range(64):
        seq = seq + x[:, t].numpy()
        assert np.array_equal(got[:, t].numpy(), seq)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("s", [1, 15, 16, 17, 37, 64, 100, 300])
def test_k11_schedule_matches_jax(s, chunk, with_state, dtype, monkeypatch):
    """The emulated chunk-parallel order (sub-chunk factoring, U_c, the walk
    in value-column slices, o) against JAX's chunked form and per-step
    recurrence (within TOL) and the port's plain version (element by
    element within the smoke's limit, its cumulative sums taken as on the
    card), below, at and past a sub-chunk, a chunk and a short sub-chunk
    tail; every exponent it forms is <= 0 but for rounding noise."""
    r, k, v, logw, u, st = _wkv_inputs(100 + s, 1, s, 2)
    st = st if with_state else None
    tdt = getattr(torch, dtype)
    rt, kt, vt = _t(r, k, v, dtype=tdt)
    r32, k32, v32 = (x.float().numpy() for x in (rt, kt, vt))
    exps = []
    o, S = _emulate_k11(r32, k32, v32, logw, u, chunk, st, exps)
    _exponents_at_most_noise(exps)
    o = torch.from_numpy(o).to(tdt)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    j = [jnp.asarray(x, jdt) for x in (r, k, v)]
    js = None if st is None else jnp.asarray(st)
    jo, jS = jrwkv._wkv6_chunked(*j, jnp.asarray(logw), jnp.asarray(u),
                                 chunk, js)
    _close(o, jo, TOL[dtype])
    _close(S, jS, TOL["float32"])
    if dtype == "float32":
        ro, rS = jrwkv.wkv6_reference(*j, jnp.asarray(logw), jnp.asarray(u),
                                      js)
        _close(o, ro, TOL[dtype])
        _close(S, rS, TOL["float32"])
    po, pS = _plain_on_card(monkeypatch, rt, kt, vt, *_t(logw, u), chunk,
                            None if st is None else torch.from_numpy(st))
    _kernel_close(o, po, dtype)
    _kernel_close(S, pS, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [32, 64])
def test_k11_schedule_with_strong_decays(chunk, dtype, monkeypatch):
    """logw = -exp(N(2, 1)): the decays of one sub-chunk already sum below
    -88, where exp(cw_prev_i) exp(-cw_j) would overflow, yet every
    exponent of the factored order is <= 0 and o and the state stay finite
    and within the limits of the normal case."""
    r, k, v, logw, u, st = _wkv_inputs(11, 1, 130, 2, mean=2.0, sd=1.0)
    assert float(np.cumsum(logw[0, :16], axis=0).min()) < -88
    tdt = getattr(torch, dtype)
    rt, kt, vt = _t(r, k, v, dtype=tdt)
    r32, k32, v32 = (x.float().numpy() for x in (rt, kt, vt))
    exps = []
    o, S = _emulate_k11(r32, k32, v32, logw, u, chunk, st, exps)
    _exponents_at_most_noise(exps)
    assert np.isfinite(o).all() and np.isfinite(S).all()
    o = torch.from_numpy(o).to(tdt)
    jo, jS = jrwkv.wkv6_reference(*(jnp.asarray(x) for x in
                                    (r32, k32, v32, logw, u)),
                                  jnp.asarray(st))
    _close(o, jo, TOL[dtype])
    _close(S, jS, TOL["float32"])
    po, pS = _plain_on_card(monkeypatch, rt, kt, vt, *_t(logw, u), chunk,
                            torch.from_numpy(st))
    _kernel_close(o, po, dtype)
    _kernel_close(S, pS, "float32")


def test_k11_walk_slices_give_the_whole_walk():
    """The walk of one slice of value columns reads only its own columns:
    one slice, four and sixty-four give the same bits."""
    r, k, v, logw, u, st = _wkv_inputs(12, 1, 150, 2)
    outs = [_emulate_k11(r, k, v, logw, u, 64, st, slices=n)
            for n in (1, 4, 64)]
    for o, S in outs[1:]:
        assert np.array_equal(o, outs[0][0]) and np.array_equal(S, outs[0][1])


def test_k11_constants_match_the_wrapper():
    """``csrc/wkv6.cu``'s constants against ``kernels.wkv6.ops``'s."""
    c = _wk_constants()
    assert c == {"WK_E": wkv6_ops.HEAD_DIM, "WK_LMAX": wkv6_ops.MAX_CHUNK,
                 "WK_SUB": wkv6_ops.SUB, "WK_P": wkv6_ops.ROW_STRIDE,
                 "WK_THREADS": wkv6_ops.THREADS,
                 "WK_WALK_THREADS": wkv6_ops.WALK_THREADS,
                 "WK_WALK_AHEAD": 8,
                 "WK_STATE_BLOCKS": wkv6_ops.STATE_BLOCKS,
                 "WK_OUT_BLOCKS": wkv6_ops.OUT_BLOCKS}
    # a thread a (channel, sub-chunk); 16-byte rows; 16 x 16 thread tiles
    assert c["WK_THREADS"] == c["WK_E"] * c["WK_LMAX"] // c["WK_SUB"] == 256
    assert c["WK_P"] % 4 == 0 and c["WK_P"] >= c["WK_E"]
    assert (c["WK_E"] * c["WK_E"]) % c["WK_WALK_THREADS"] == 0
    src = (_build.CSRC / "wkv6.cu").read_text()
    flat = " ".join(src.split())
    assert "STATE_SMEM = (int)sizeof(float) * 3 * TILE;" in flat
    assert ("OUT_SMEM = (int)sizeof(float) * (6 * TILE + NSUB * WK_E + 3 * "
            "WK_E + WK_E + WK_LMAX + NSUB * WK_SUB * WK_SUB);") in flat
    assert "TILE = WK_LMAX * WK_P;" in flat
    assert re.search(r"\batomic[A-Z]\w*\(", src) is None  # no atomics


def test_k11_diagonal_pairs_cover_each_lower_pair_once():
    """``wkv6_chunk_out`` lays the 120 strictly lower pairs of a diagonal
    16 x 16 block on a 15 x 8 rectangle, two blocks a round over 240 of its
    256 threads: each pair once, none on or above the diagonal."""
    src = " ".join((_build.CSRC / "wkv6.cu").read_text().split())
    assert ("const int ti = x <= y ? y + 1 : WK_SUB - 1 - y; const int tj = "
            "x <= y ? x : WK_SUB - 1 - x;") in src
    sub = wkv6_ops.SUB
    seen = []
    for tid in range(wkv6_ops.THREADS):
        if tid >= 2 * (sub * (sub - 1) // 2):
            continue
        y, x = (tid % 120) // (sub // 2), tid % (sub // 2)
        ti, tj = (y + 1, x) if x <= y else (sub - 1 - y, sub - 1 - x)
        seen += [(2 * rnd + tid // 120, ti, tj) for rnd in range(2)]
    assert sorted(seen) == [(a, i, j) for a in range(4) for i in range(sub)
                            for j in range(i)]


#: dynamic shared memory a block may opt in to, and an SM's, on the H100
SMEM_LIMIT, SM_SMEM = 232448, 233472


@pytest.mark.parametrize("b,s,h,L", [(1, 4500, 32, 64), (1, 1500, 32, 64),
                                     (1, 300, 32, 64), (1, 16, 32, 16),
                                     (1, 37, 32, 37), (2, 100, 3, 32),
                                     (1, 8192, 32, 64), (4, 1, 2, 1)])
def test_wkv6_plan_covers_every_chunk_and_sub_chunk_once(b, s, h, L):
    """The items of passes 1 and 3 are every (batch, head, chunk) once, the
    chunks' rows cover the sequence once, and the sub-chunks a chunk's
    rows once; the walk has one thread a state element."""
    plan = wkv6_ops.wkv6_plan(b, s, h, L, 132)

    def item_of(idx):  # as the kernels read blockIdx.x
        bh, ch = divmod(idx, plan.chunks)
        return bh // h, bh % h, ch

    seen = {item_of(i) for i in range(plan.items)}
    assert len(seen) == plan.items == b * h * plan.chunks
    assert seen == {(bb, hh, c) for bb in range(b) for hh in range(h)
                    for c in range(plan.chunks)}
    covered = np.zeros(s, int)
    for c in range(plan.chunks):
        covered[c * L:min(s, (c + 1) * L)] += 1
    assert (covered == 1).all()
    in_chunk = np.zeros(L, int)
    for r0, n in plan.sub_rows:
        assert 1 <= n <= wkv6_ops.SUB and r0 % wkv6_ops.SUB == 0
        in_chunk[r0:r0 + n] += 1
    assert (in_chunk == 1).all()
    assert plan.grids == (plan.items, plan.walkers // wkv6_ops.WALK_THREADS,
                          plan.items)
    assert plan.walkers == b * h * 64 * 64
    assert plan.walkers % wkv6_ops.WALK_THREADS == 0


def test_wkv6_plan_fills_the_card_at_the_prefill():
    """rwkv6-1.6b's 4500-token prefill (b 1, 32 heads, chunks of 64): 2272
    chunk blocks, over 132 SMs' worth, and 512 walk blocks."""
    plan = wkv6_ops.wkv6_plan(1, 4500, 32, 64, 132)
    assert plan.items == 2272 and min(plan.grids) >= 132
    assert plan.grids[1] == 512
    assert plan.waves == pytest.approx(2272 / 264)
    # exps: the factored A needs about 39 k a chunk (164 k before)
    lower = 4 * 16 * 15 // 2 * 64
    assert lower + 2 * 64 * 64 + 3 * 64 < 40_000
    assert plan.exps < 60_000 * plan.items


def test_wkv6_plan_shared_memory_fits_the_card():
    """A chunk-state block and a chunk-output block fit an H100 block's
    227 KB, and as many of each as their launch bounds ask fit an SM (1 KB
    of each block reserved)."""
    plan = wkv6_ops.wkv6_plan(1, 4500, 32, 64, 132)
    state, walk, out = plan.smem
    assert walk == 0 and max(state, out) <= SMEM_LIMIT
    assert wkv6_ops.STATE_BLOCKS * (state + 1024) <= SM_SMEM
    assert wkv6_ops.OUT_BLOCKS * (out + 1024) <= SM_SMEM


@pytest.mark.parametrize("s,mb", [(4500, 37.8), (8192, 68.2)])
def test_wkv6_plan_scratch(s, mb):
    """U (then S_prev) and the decays, fp32: 37 MB at 4500 tokens, 67 MB at
    8192 (``max_len``), b 1 and 32 heads."""
    plan = wkv6_ops.wkv6_plan(1, s, 32, 64, 132)
    nc = -(-s // 64)
    assert plan.scratch_elems == 32 * nc * (64 * 64 + 64)
    assert 4 * plan.scratch_elems / 1e6 == pytest.approx(mb, abs=0.1)


class _WkvEntry:
    """A stand-in of the C entries ``wkv6_f32`` / ``wkv6_bf16`` that records
    its arguments and which pointers are the data of live tensors."""

    def __init__(self):
        self.tensors, self.calls = [], []

    def __call__(self, *args):
        live = {t.data_ptr(): t for t in (w() for w in self.tensors)
                if t is not None}
        self.calls.append((args, [p is None or p in live for p in args[:9]],
                           {p: live[p].numel() for p in args[:9]
                            if p in live}))
        return 0


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [37, 4500])
def test_k11_launch_passes_live_tensors_and_its_scratch(s, dtype,
                                                        with_state,
                                                        monkeypatch):
    """``_launch`` hands the C entry of r's type r, k, v, logw, u, the state
    (or null), o, the final state and one scratch tensor of the plan's
    size, all alive when it is called; b, s, h, L and the stream handle;
    and steps the counter once a call."""
    import weakref

    h = 32 if s == 4500 else 2
    tdt = getattr(torch, dtype)
    r, k, v = (torch.zeros(1, s, h, 64, dtype=tdt) for _ in range(3))
    logw = torch.zeros(1, s, h, 64)
    u = torch.zeros(h, 64)
    st = torch.zeros(1, h, 64, 64) if with_state else None
    entry = _WkvEntry()
    entry.tensors = [weakref.ref(t) for t in (r, k, v, logw, u)
                     + (() if st is None else (st,))]
    empty, empty_like = torch.empty, torch.empty_like
    allocs = []

    def recording(fn):
        def alloc(*a, **kw):
            out = fn(*a, **kw)
            entry.tensors.append(weakref.ref(out))
            allocs.append(out.numel())
            return out
        return alloc

    name = "wkv6_bf16" if dtype == "bfloat16" else "wkv6_f32"
    fake = type("Lib", (), {name: entry})()
    monkeypatch.setattr(wkv6_ops, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(wkv6_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(wkv6_ops, "stream_handle", lambda dev: 77)
    monkeypatch.setattr(wkv6_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(wkv6_ops.torch, "empty", recording(empty))
    monkeypatch.setattr(wkv6_ops.torch, "empty_like", recording(empty_like))
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(wkv6, "launches", 0)
    for call in (1, 2):
        o, S = wkv6_ops._launch(r, k, v, logw, u, min(64, s), st)
        args, live, sizes = entry.calls[-1]
        assert all(live)
        assert args[:9] == (r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            logw.data_ptr(), u.data_ptr(),
                            None if st is None else st.data_ptr(),
                            o.data_ptr(), S.data_ptr(), args[8])
        plan = wkv6_ops.wkv6_plan(1, s, h, min(64, s), 132)
        assert sizes[args[8]] == plan.scratch_elems
        assert args[9:] == (1, s, h, min(64, s), 77)
        assert o.shape == r.shape and o.dtype == r.dtype
        assert S.shape == (1, h, 64, 64) and S.dtype == torch.float32
        assert wkv6.launches == call
    # o, the final state and the scratch: three allocations a call
    assert len(allocs) == 6


def test_k11_launch_refuses_unaligned_tensors(monkeypatch):
    """A logw that does not start on a 16-byte boundary cannot be read as
    float4 rows: ``_launch`` raises before the C entry is reached."""
    monkeypatch.setattr(wkv6_ops, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(wkv6_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    r = torch.zeros(1, 4, 2, 64)
    logw = torch.zeros(4 * 2 * 64 + 1)[1:].view(1, 4, 2, 64)
    with pytest.raises(ValueError, match="aligned"):
        wkv6_ops._launch(r, r, r, logw, torch.zeros(2, 64), 4, None)


# -- the layers and the model -------------------------------------------------


def _cfgs(dtype="float32"):
    j = dataclasses.replace(jconfig.get_arch(ARCH).reduced(), dtype=dtype,
                            param_dtype=dtype)
    t = dataclasses.replace(tconfig.get_arch(ARCH).reduced(), dtype=dtype,
                            param_dtype=dtype)
    return j, t


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


_MODELS = {}


def _models(dtype="float32"):
    """(JAX model, JAX params, port model) with the same weights: the JAX
    init carried over by ``params_from_jax``, its zero time- and
    channel-mix leaves redrawn by ``rwkv_redraw``, and the result handed
    back to the JAX side."""
    if dtype not in _MODELS:
        jcfg, tcfg = _cfgs(dtype)
        jm = jregistry.get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               device="cpu")
        trwkv.rwkv_redraw(tree, torch.Generator().manual_seed(1))
        tm = tregistry.get_model(tcfg).load_tree(tree)
        _MODELS[dtype] = (jm, tree_map(_to_jax, tree), tm)
    return _MODELS[dtype]


def test_redraw_spreads_decays_and_bonus():
    """The redrawn leaves are nonzero, and exp(w0) spans about [0.05, 5]."""
    _, jp, tm = _models()
    w0 = tm.layers[0]["time"]["w0"]
    assert 0.02 < float(torch.exp(w0).min()) < 0.2
    assert 3.0 < float(torch.exp(w0).max()) < 30.0
    for name in ("mu", "mu_x", "lora_B", "w0", "w_B", "u"):
        assert tm.layers[1]["time"][name].abs().min() > 0, name
        assert np.array_equal(np.asarray(jp["layers"]["time"][name][1]),
                              tm.layers[1]["time"][name].numpy())


def test_time_and_channel_mix_match_jax():
    """``rwkv_time_apply`` (prefill of 40 tokens, two chunks of 32 with
    padding, from a nonzero cache; then a decode step) and
    ``rwkv_channel_apply`` against JAX's, outputs and new caches."""
    jm, jp, tm = _models()
    cfg = tm.cfg
    d, h = trwkv.rwkv_dims(cfg)
    rng = np.random.default_rng(9)
    jt = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["time"])
    jc = jax.tree_util.tree_map(lambda a: a[0], jp["layers"]["chan"])
    pt, pc = tm.layers[0]["time"], tm.layers[0]["chan"]
    last = rng.standard_normal((2, d)).astype(np.float32)
    state = rng.standard_normal((2, h, 64, 64)).astype(np.float32)
    for s, mode in ((40, "full"), (1, "decode")):
        x = rng.standard_normal((2, s, d)).astype(np.float32)
        cache = {"last": torch.from_numpy(last.copy()),
                 "state": torch.from_numpy(state.copy())}
        out = trwkv.rwkv_time_apply(pt, torch.from_numpy(x), cfg,
                                    cache=cache, mode=mode)
        jout, jnew = jrwkv.rwkv_time_apply(
            jt, jnp.asarray(x), jm.cfg, mode=mode,
            cache={"last": jnp.asarray(last), "state": jnp.asarray(state)})
        _close(out, jout, MODEL_TOL["float32"]["logits"])
        _close(cache["last"], jnew["last"], 0.0)
        _close(cache["state"], jnew["state"], MODEL_TOL["float32"]["cache"])
        ccache = {"last": torch.from_numpy(last.copy())}
        out = trwkv.rwkv_channel_apply(pc, torch.from_numpy(x), cfg, ccache)
        jout, jnew = jrwkv.rwkv_channel_apply(
            jc, jnp.asarray(x), jm.cfg, cache={"last": jnp.asarray(last)})
        _close(out, jout, MODEL_TOL["float32"]["logits"])
        _close(ccache["last"], jnew["last"], 0.0)
    # without a cache: a zero token shift and a zero state
    x = rng.standard_normal((1, 40, d)).astype(np.float32)
    out = trwkv.rwkv_time_apply(pt, torch.from_numpy(x), cfg)
    jout, _ = jrwkv.rwkv_time_apply(jt, jnp.asarray(x), jm.cfg)
    _close(out, jout, MODEL_TOL["float32"]["logits"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """The reduced model: prefill logits at every position of 40-token
    prompts (two chunks of 32) and the fp32 caches written, then two
    ``decode_step``s."""
    jm, jp, tm = _models(dtype)
    tol = MODEL_TOL[dtype]
    rng = np.random.default_rng(10)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 40))
    jc = jm.init_cache(2, 64)
    jl, jc, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                           mode="prefill", cache=jc)
    tc = tm.init_cache(2, 64)
    with torch.no_grad():
        tl, tc, _ = tm({"tokens": torch.from_numpy(toks)}, mode="prefill",
                       cache=tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, 40, 512)
    _close(tl, jl, tol["logits"])
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert a.dtype == torch.float32
        _close(a, b, tol["cache"])
    pos = np.array([40, 40], np.int32)
    for _ in range(2):
        nxt = rng.integers(0, tm.cfg.vocab_size, (2, 1))
        jl2, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        with torch.no_grad():
            tl2, tc = tm.decode_step(torch.from_numpy(nxt),
                                     torch.from_numpy(pos), tc)
        _close(tl2, jl2, tol["logits"])
        for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            _close(a, b, tol["cache"])
        pos = pos + 1


def test_forward_without_cache_matches_jax():
    jm, jp, tm = _models()
    toks = np.random.default_rng(11).integers(0, 512, (1, 33))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, mode="prefill")
    with torch.no_grad():
        tl, aux = tm({"tokens": torch.from_numpy(toks)}, mode="prefill",
                     window_override=16)
    _close(tl, jl, MODEL_TOL["float32"]["logits"])


def test_full_width_shape():
    cfg = tconfig.get_arch(ARCH)
    m = tregistry.get_model(cfg)
    assert (cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size,
            cfg.rwkv.head_dim, cfg.rwkv.chunk_size) == (24, 2048, 7168,
                                                         65536, 64, 64)
    assert len(m.layers) == 24
    assert all(p.device.type == "meta" for p in m.parameters())
    assert cfg.num_params() == 1_599_673_856
    spec = m.cache_spec(4, 8192)
    assert spec["time"]["state"].shape == (24, 4, 32, 64, 64)
    assert spec["chan"]["last"].shape == (24, 4, 2048)
    assert CACHE_BATCH_AXIS == 1


# -- weights and caches -------------------------------------------------------


def test_params_from_jax_is_bit_exact_for_rwkv():
    """bf16 projections and fp32 mix leaves cross bit for bit, per layer."""
    jcfg, tcfg = _cfgs("bfloat16")
    jp = jregistry.get_model(jcfg).init(jax.random.PRNGKey(2))
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jp), tree_leaves(tree)
    assert len(jl) == len(tl)
    kinds = set()
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        kinds.add(str(a.dtype))
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            assert np.array_equal(a.view(np.uint16),
                                  b.view(torch.int16).numpy().view(np.uint16))
        else:
            assert b.dtype == torch.float32 and np.array_equal(a, b.numpy())
    assert kinds == {"bfloat16", "float32"}
    tm = tregistry.get_model(tcfg).load_tree(tree)
    w = tm.layers[1]["chan"]["wk"]["w"]
    assert np.array_equal(
        np.asarray(jp["layers"]["chan"]["wk"]["w"][1]).view(np.uint16),
        w.view(torch.int16).numpy().view(np.uint16))


_PORTED = [a for a in jconfig.list_archs()
           if jconfig.get_arch(a).family in ("dense", "ssm")
           and jconfig.get_arch(a).moe is None]


@pytest.mark.parametrize("arch", _PORTED)
def test_init_cache_dtypes_match_jax(arch):
    """Every leaf of the port's cache has the JAX package's dtype and
    shape: bf16 KV caches, fp32 RWKV token-shift rows and states."""
    jcfg = jconfig.get_arch(arch).reduced()
    tcfg = tconfig.get_arch(arch).reduced()
    jc = jregistry.get_model(jcfg).init_cache(2, 16)
    tc = tregistry.get_model(tcfg).init_cache(2, 16, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert not b.any()


def test_rwkv_state_cache_is_fp32():
    """The cache spec says float32 and the port now keeps it (it made
    every leaf bf16): a state rounded to bf16 would move the next token's
    logits far past the fp32 tolerance."""
    jm, jp, tm = _models()
    assert all(p.dtype == "float32" for p in
               tree_leaves(tm.cache_spec(1, 8)))
    assert all(t.dtype == torch.float32 for t in
               tree_leaves(tm.init_cache(1, 8)))
    toks = torch.from_numpy(np.random.default_rng(12).integers(0, 512,
                                                                (1, 40)))
    with torch.no_grad():
        _, cache, _ = tm({"tokens": toks}, mode="prefill",
                         cache=tm.init_cache(1, 64))
        rounded = tree_map(lambda t: t.bfloat16().float(), cache)
        a, _ = tm.decode_step(toks[:, -1:], None, cache)
        b, _ = tm.decode_step(toks[:, -1:], None, rounded)
    err = float((a - b).abs().max())
    assert err > 10 * MODEL_TOL["float32"]["logits"] * max(
        1.0, float(a.abs().max()))


# -- serving and the launcher -------------------------------------------------


def _serve(engine_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, max_batch=2, max_len=64, **kw)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    return eng.run_until_drained()


def test_serving_matches_jax_greedy():
    """Four requests on two slots (so slots are reused), among them a
    1-token prompt (the per-step path) and one of 45 tokens (two chunks of
    32): the port's engine gives the JAX engine's token lists."""
    jm, jp, tm = _models()
    rng = np.random.default_rng(13)
    reqs = [Request(rid, rng.integers(0, 512, n).tolist(), max_new_tokens=m)
            for rid, (n, m) in enumerate(((1, 5), (45, 4), (7, 6), (20, 3)))]
    ours = _serve(ServingEngine, tm, None, reqs, device="cpu")
    theirs = _serve(jengine.ServingEngine, jm, jp, reqs)
    assert sorted(ours) == list(range(4))
    assert ours == theirs


def test_prefill_resets_only_its_slot():
    """A prefill zeroes its slot's state before writing the prompt's, and
    leaves the other slots' states as they were."""
    _, _, tm = _models()
    eng = ServingEngine(tm, max_batch=3, max_len=32, device="cpu")
    eng._prefill_into_slot(0, Request(0, [1, 2, 3], max_new_tokens=2))
    first = [t.narrow(CACHE_BATCH_AXIS, 0, 1).clone()
             for t in tree_leaves(eng.cache)]
    eng._prefill_into_slot(1, Request(1, [4, 5, 6, 7], max_new_tokens=2))
    eng._prefill_into_slot(0, Request(2, [1, 2, 3], max_new_tokens=2))
    for f, t in zip(first, tree_leaves(eng.cache)):
        assert torch.equal(f, t.narrow(CACHE_BATCH_AXIS, 0, 1))
        assert t.narrow(CACHE_BATCH_AXIS, 1, 1).abs().sum() > 0
        assert not t.narrow(CACHE_BATCH_AXIS, 2, 1).any()


@pytest.mark.parametrize("arch", [ARCH, "internlm2-20b"])
def test_launcher_serves_on_the_cpu(arch, capsys):
    """``repro_torch.launch.serve.main`` with ``--device cpu``: a token list
    for every request, JAX's output line and return dict."""
    out = tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--max-len", "32"])
    assert set(out) == {"tokens", "seconds", "done"}
    assert sorted(out["done"]) == [0, 1, 2]
    assert all(len(t) == 4 for t in out["done"].values())
    assert out["tokens"] == 12
    assert f"[serve] {arch}: 3 requests, 12 tokens" in capsys.readouterr().out


def test_launcher_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--arch", ARCH, "--requests", "1"])

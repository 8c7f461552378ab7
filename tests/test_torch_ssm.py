"""The port's Mamba2 (SSD) block (``repro_torch.nn.ssm``) against the JAX
package's (``repro.nn.ssm``), on the CPU.

The JAX package computes the causal conv and the chunked scan with jnp,
outside any Pallas kernel, so its functions are the oracle as they are.
Inputs come from numpy seeds; the block's weights from the JAX init, with
the leaves that the init rules leave at zeros or ones (``A_log``,
``dt_bias``, ``conv_b``, ``D``) redrawn by
``repro_torch.nn.ssm.ssm_redraw``: at their init every head would decay
alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import ModelConfig as JModelConfig
from repro.core.config import SSMConfig as JSSMConfig
from repro.nn import param as jparam
from repro.nn import ssm as jssm
from repro_torch.core.config import ModelConfig, SSMConfig
from repro_torch.nn import ssm as tssm

# the JAX references, jitted: one compile a shape instead of an eager
# scan's on every call
J_SSD = jax.jit(jssm._ssd_chunked, static_argnums=5)
J_SSD_REF = jax.jit(jssm.ssd_reference)
J_APPLY = jax.jit(jssm.ssm_apply, static_argnums=2,
                  static_argnames="mode")

#: the chunked scan against JAX's, relative to max(1, max|ref|).  fp32:
#: the same function in another order (the chunks batched, the products
#: as matmuls, XLA's and torch's cumulative sums and exps): within a few
#: 1e-7 of the largest output at these sizes (4.8e-7 at max|y| 6.4), held
#: to 1e-5.  The exps of differences of cumulative sums lose about |cs| *
#: 2^-24 each, so the strong-decay case (|cs| past 3000) is held to 1e-4.
#: bf16 x, B, C: both sides are fp32 inside and round y once: one bf16
#: step of the largest, 2^-7.
TOL = {"float32": 1e-5, "strong": 1e-4, "bfloat16": 2.0 ** -7}
#: the conv against JAX's, relative to max(1, max|ref|).  Its products and
#: sums before the activation are bit for bit (the same order, each step
#: rounded to the input type).  silu: the port takes y times an fp32
#: sigmoid rounded to y's dtype (``act_fn``); XLA's CPU backend expands a
#: bf16 sigmoid into bf16 exp, add and reciprocal, each rounded — at most
#: about one bf16 rounding of the output apart (0.0156 at max|y| 4.3
#: seen), held to 2^-7.  fp32: 1e-6 (sigmoid's implementations).
CONV_TOL = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
#: ``ssm_apply`` against JAX's, relative to max(1, max|ref|): fp32 as the
#: scan, through two projections and the norm; bf16 params: the
#: activations are rounded to bf16 at a few places the two packages round
#: differently (silu, the projections' plain version) — 2^-5.
APPLY_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, tol):
    """max |ours - ref| <= tol * max(1, max |ref|), every element finite."""
    a, b = _f32(ours), _f32(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(a).all()
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _t(a):
    """A JAX or numpy array as a tensor, bf16 carried bit for bit."""
    a = np.array(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _bits_equal(ours, ref):
    a = np.array(ref)
    b = ours.numpy() if ours.dtype != torch.bfloat16 else \
        ours.view(torch.int16).numpy().view(jnp.bfloat16)
    assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                                 b.view(np.uint8))


# -- the causal conv -----------------------------------------------------------


@pytest.mark.parametrize("s", [2, 45])
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(dtype, streaming, s, monkeypatch):
    """Full (zero history) and streaming (the previous call's trailing
    inputs) over 45 steps and over 2, fewer than the K - 1 = 3 rows of
    history, whose state keeps rows of the history: the activation's
    input bit for bit, the output within ``CONV_TOL``, the new state
    bit for bit."""
    rng = np.random.default_rng(s + 2 * streaming)
    b, c, K = 2, 24, 4
    x = jnp.asarray(rng.standard_normal((b, s, c)), dtype)
    w = jnp.asarray(rng.standard_normal((K, c)) / 2, dtype)
    bias = jnp.asarray(0.1 * rng.standard_normal(c), jnp.float32)
    # the cache is an fp32 leaf holding values of the input's type
    state = (jnp.asarray(rng.standard_normal((b, K - 1, c)), dtype
                         ).astype(jnp.float32) if streaming else None)
    tstate = None if state is None else _t(state)
    jy, jst = jssm._causal_conv(x, w, bias, state)
    y, st = tssm._causal_conv(_t(x), _t(w), _t(bias), tstate)
    assert y.dtype == getattr(torch, dtype) and st.dtype == y.dtype
    _close(y, jy, CONV_TOL[dtype])
    _bits_equal(st, jst)
    if streaming:
        assert torch.equal(st[:, :max(0, K - 1 - s)].float(),
                           tstate[:, s:])
    # before the activation: bit for bit
    monkeypatch.setattr(jax.nn, "silu", lambda v: v)
    monkeypatch.setattr(tssm, "_silu", lambda v: v)
    jy, _ = jssm._causal_conv(x, w, bias, state)
    y, _ = tssm._causal_conv(_t(x), _t(w), _t(bias), tstate)
    _bits_equal(y, jy)


def test_softplus_is_jaxs_above_20():
    """``_softplus`` is JAX's logaddexp(x, 0) to 2 ulps (torch's and XLA's
    log1p and exp round apart), also above 20, where ``F.softplus``
    switches to its linear branch."""
    x = np.linspace(-60.0, 60.0, 4001).astype(np.float32)
    ours = tssm._softplus(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    ulp = np.spacing(np.maximum(np.abs(ref), np.abs(ours)))
    assert (np.abs(ours - ref) <= 2 * ulp).all()
    assert (x > 20).sum() > 1000


# -- the chunked scan ------------------------------------------------------------


def _ssd_inputs(seed, b, s, h=3, p=8, n=5, a_mean=0.0, dt_shift=-1.0):
    """Seeded x, B, C ~ N(0, 1); dt = softplus(N(dt_shift, 1)) and A =
    -exp(N(a_mean, 1)), as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    raw = (rng.standard_normal((b, s, h)) + dt_shift).astype(np.float32)
    dt = np.asarray(jax.nn.softplus(jnp.asarray(raw)))
    A = -np.exp(a_mean + rng.standard_normal(h)).astype(np.float32)
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, A, B, C


def _both_scans(arrs, chunk, dtype="float32"):
    """(ours, JAX's chunked, JAX's recurrence) on the same inputs, x, B
    and C in ``dtype``."""
    x, dt, A, B, C = arrs
    jx, jB, jC = (jnp.asarray(a, dtype) for a in (x, B, C))
    jdt, jA = jnp.asarray(dt), jnp.asarray(A)
    ours = tssm._ssd_chunked(_t(jx), _t(jdt), _t(jA), _t(jB), _t(jC), chunk)
    return (ours, J_SSD(jx, jdt, jA, jB, jC, chunk),
            J_SSD_REF(jx, jdt, jA, jB, jC))


@pytest.mark.parametrize("s,chunk", [(45, 16), (10, 16), (48, 16), (1, 16),
                                     (100, 32)])
def test_ssd_chunked_matches_jax(s, chunk):
    """s = 45 with chunks of 16 (the last padded by 3 zero rows), s under
    one chunk, an exact multiple, one step, and 100 over 32: y and the
    final state against JAX's chunked form and its per-step recurrence;
    the port's recurrence against JAX's."""
    arrs = _ssd_inputs(s, 2, s)
    (y, S), (jy, jS), (ry, rS) = _both_scans(arrs, chunk)
    assert y.dtype == torch.float32 and S.shape == (2, 3, 8, 5)
    for ref_y, ref_S in ((jy, jS), (ry, rS)):
        _close(y, ref_y, TOL["float32"])
        _close(S, ref_S, TOL["float32"])
    py, pS = tssm.ssd_reference(*(_t(a) for a in arrs))
    _close(py, ry, TOL["float32"])
    _close(pS, rS, TOL["float32"])


def test_ssd_strong_decays_stay_finite():
    """A = -exp(N(3, 1)) and dt = softplus(N(1, 1)): a chunk's cumulative
    log-decay goes past -3000, where exp(cs_l - cs_m) above the diagonal
    is inf and exp(cs) underflows to 0; the mask selects, so y and the
    state stay finite and match."""
    arrs = _ssd_inputs(5, 1, 100, a_mean=3.0, dt_shift=1.0)
    x, dt, A = arrs[:3]
    assert float(np.cumsum(dt * A, axis=1).min()) < -3000
    (y, S), (jy, jS), (ry, rS) = _both_scans(arrs, 32)
    assert torch.isfinite(y).all() and torch.isfinite(S).all()
    for ref_y, ref_S in ((jy, jS), (ry, rS)):
        _close(y, ref_y, TOL["strong"])
        _close(S, ref_S, TOL["strong"])


@pytest.mark.parametrize("strong", [False, True])
def test_ssd_gradients_match_jax(strong):
    """The scan's gradients (of sum(y * gy) + sum(S * gS)) against
    ``jax.grad`` of JAX's per-step recurrence.  Moderate decays: also
    against JAX's chunked form.  Strong decays (as above): the exponent
    above the diagonal overflows, where JAX's chunked form, selecting the
    exp's inf away after it, has NaN gradients (0 * inf in the backward);
    the port sets the exponent to -inf before the exp, and its gradients
    stay finite."""
    arrs = (_ssd_inputs(5, 1, 100, a_mean=3.0, dt_shift=1.0) if strong
            else _ssd_inputs(9, 2, 45))
    rng = np.random.default_rng(11)
    b, s, h, p = arrs[0].shape
    gy = rng.standard_normal((b, s, h, p)).astype(np.float32)
    gS = rng.standard_normal((b, h, p, arrs[3].shape[-1])).astype(np.float32)
    chunk = 32 if strong else 16

    def loss(fn):
        return lambda *a: (jnp.sum(fn(*a)[0] * gy)
                           + jnp.sum(fn(*a)[1] * gS))

    argnums = (0, 1, 2, 3, 4)
    ref = jax.grad(loss(jssm.ssd_reference), argnums)(*arrs)
    chunked = jax.grad(loss(lambda *a: jssm._ssd_chunked(*a, chunk)),
                       argnums)(*arrs)
    leaves = [_t(jnp.asarray(a)).requires_grad_(True) for a in arrs]
    y, S = tssm._ssd_chunked(*leaves, chunk)
    ((y * _t(jnp.asarray(gy))).sum() + (S * _t(jnp.asarray(gS))).sum()
     ).backward()
    for t, r, c in zip(leaves, ref, chunked):
        assert torch.isfinite(t.grad).all()
        _close(t.grad, r, TOL["strong" if strong else "float32"])
        if not strong:
            _close(t.grad, c, TOL["float32"])
    assert strong == any(not np.isfinite(np.asarray(c)).all()
                         for c in chunked)


def test_ssd_dt_raw_above_20():
    """dt_raw + dt_bias above 20 (dt = softplus, the value itself): the
    scan on such steps against JAX's, finite."""
    x, _, A, B, C = _ssd_inputs(6, 1, 40)
    raw = np.random.default_rng(7).uniform(18.0, 30.0, (1, 40, 3)
                                           ).astype(np.float32)
    dt = tssm._softplus(torch.from_numpy(raw)).numpy()
    assert (raw > 20).mean() > 0.5
    np.testing.assert_array_equal(dt, np.asarray(jax.nn.softplus(raw)))
    (y, S), (jy, jS), _ = _both_scans((x, dt, A, B, C), 16)
    assert torch.isfinite(y).all()
    _close(y, jy, TOL["strong"])
    _close(S, jS, TOL["strong"])


def test_ssd_takes_bf16():
    """bf16 x, B, C (the served type): fp32 inside, y in bf16 within one
    rounding of JAX's, the state fp32."""
    (y, S), (jy, jS), _ = _both_scans(_ssd_inputs(8, 2, 45), 16, "bfloat16")
    assert y.dtype == torch.bfloat16 and S.dtype == torch.float32
    _close(y, jy, TOL["bfloat16"])
    _close(S, jS, TOL["float32"])


# -- the block -----------------------------------------------------------------


def _cfgs(dtype):
    """A small Mamba2 block (d_model 32, 8 heads of 8, d_state 8, chunks of
    8) in both packages."""
    kw = dict(name="t", family="hybrid", num_layers=1, d_model=32,
              num_heads=0, num_kv_heads=0, d_ff=64, vocab_size=64,
              head_dim=8, dtype=dtype, param_dtype=dtype)
    ssm = dict(d_state=8, d_conv=4, expand=2, head_dim=8, chunk_size=8)
    return (JModelConfig(**kw, ssm=JSSMConfig(**ssm)),
            ModelConfig(**kw, ssm=SSMConfig(**ssm)))


_PARAMS = {}


def _params(dtype):
    """(JAX params, port params): the JAX init, carried over bit for bit,
    with ``ssm_redraw``'s leaves redrawn and handed back to the JAX side."""
    if dtype not in _PARAMS:
        jcfg, _ = _cfgs(dtype)
        jp = jparam.init_tree(jssm.ssm_spec(jcfg), jax.random.PRNGKey(0),
                              dtype)
        tp = jax.tree_util.tree_map(_t, jp)
        tssm.ssm_redraw({"mamba": {"ssm": tp}},
                        torch.Generator().manual_seed(1))
        _PARAMS[dtype] = (jax.tree_util.tree_map(_j, tp), tp)
    return _PARAMS[dtype]


def _spec_rows(spec, path=""):
    """(path, shape, axes, init, scale, dtype) of every Param of a spec
    tree, keys in sorted order."""
    if isinstance(spec, dict):
        return [r for k in sorted(spec)
                for r in _spec_rows(spec[k], f"{path}/{k}")]
    return [(path, tuple(spec.shape), tuple(spec.axes), spec.init,
             spec.scale, spec.dtype)]


def test_spec_matches_jax():
    jcfg, tcfg = _cfgs("float32")
    assert _spec_rows(tssm.ssm_spec(tcfg)) == _spec_rows(
        jssm.ssm_spec(jcfg))
    assert tssm.ssm_dims(tcfg) == jssm.ssm_dims(jcfg) == (64, 8)


def test_redraw_spreads_the_heads():
    """The redrawn leaves vary by head: A over more than a factor 5 across
    the 8 heads, dt's bias around -3, D around 1, a nonzero conv bias."""
    _, tp = _params("float32")
    A = torch.exp(tp["A_log"])
    assert float(A.max() / A.min()) > 5
    assert -5.0 < float(tp["dt_bias"].mean()) < -1.0
    assert tp["conv_b"].abs().min() > 0 and tp["D"].std() > 0.1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_apply_full_matches_jax(dtype):
    """A 20-step prompt (chunks of 8, the last padded) without a cache,
    and with a cache whose conv rows are nonzero (the scan still starts
    from a zero state, as JAX's does): the output and the new cache."""
    jp, tp = _params(dtype)
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.standard_normal((2, 20, 32)), dtype)
    jy, _ = J_APPLY(jp, x, jcfg, mode="full")
    _close(tssm.ssm_apply(tp, _t(x), tcfg), jy, APPLY_TOL[dtype])
    conv = jnp.asarray(rng.standard_normal((2, 3, 80)), dtype
                       ).astype(jnp.float32)
    state = jnp.asarray(rng.standard_normal((2, 8, 8, 8)), jnp.float32)
    cache = {"conv": _t(conv).clone(), "state": _t(state).clone()}
    jy, jc = J_APPLY(jp, x, jcfg, mode="full",
                            cache={"conv": conv, "state": state})
    y = tssm.ssm_apply(tp, _t(x), tcfg, mode="full", cache=cache)
    assert y.dtype == getattr(torch, dtype)
    _close(y, jy, APPLY_TOL[dtype])
    assert cache["conv"].dtype == cache["state"].dtype == torch.float32
    _close(cache["conv"], jc["conv"], 0.0 if dtype == "float32"
           else APPLY_TOL[dtype])
    _close(cache["state"], jc["state"], APPLY_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_prefill_then_decode_matches_full(dtype):
    """As tests/test_mixers.py: a 6-step prefill into a zero cache, then 6
    decode steps, give one 12-step pass; each decode step's output and
    cache also against JAX's decode step."""
    jp, tp = _params(dtype)
    jcfg, tcfg = _cfgs(dtype)
    x = jnp.asarray(np.random.default_rng(12).standard_normal((2, 12, 32)),
                    dtype)
    tol = APPLY_TOL[dtype]
    full = tssm.ssm_apply(tp, _t(x), tcfg)
    cache = {"conv": torch.zeros(2, 3, 80), "state": torch.zeros(2, 8, 8, 8)}
    jc = {"conv": jnp.zeros((2, 3, 80)), "state": jnp.zeros((2, 8, 8, 8))}
    pre = tssm.ssm_apply(tp, _t(x[:, :6]), tcfg, mode="full", cache=cache)
    _, jc = J_APPLY(jp, x[:, :6], jcfg, mode="full", cache=jc)
    _close(pre, full[:, :6], tol)
    for t in range(6, 12):
        y = tssm.ssm_apply(tp, _t(x[:, t:t + 1]), tcfg, mode="decode",
                           cache=cache)
        jy, jc = J_APPLY(jp, x[:, t:t + 1], jcfg, mode="decode",
                                cache=jc)
        _close(y, full[:, t:t + 1], tol)
        _close(y, jy, tol)
        _close(cache["state"], jc["state"], tol)
        _close(cache["conv"], jc["conv"].astype(jnp.float32), tol)
    with pytest.raises(ValueError, match="mode"):
        tssm.ssm_apply(tp, _t(x[:, :1]), tcfg, mode="train", cache=cache)

"""The port's gradients (``repro_torch.kernels``: K3's ``MatmulFusedFn``,
K10's ``FlashAttentionFn`` with its plain backward, K11's ``Wkv6Fn``)
against ``jax.grad`` of the JAX package's jnp paths, on the CPU, in fp32;
and ``torch.autograd.gradcheck`` of each backward in float64 at tiny
sizes (the accumulation type set to float64 for it).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.matmul_fused.ref import matmul_fused_ref as jmm_ref
from repro.nn import attention as jattn
from repro.nn import linear as jlinear
from repro.nn import rwkv as jrwkv
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention import ref as attn_ref
from repro_torch.kernels.matmul_fused import ops as mm_ops
from repro_torch.kernels.matmul_fused import ref as mm_ref
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.kernels.wkv6 import ref as wkv6_ref

ACTS = ["none", "relu", "silu", "gelu"]


def _t(a, grad=True):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _close(ours, ref, tol):
    """max |ours - ref| <= tol * max(1, max |ref|)."""
    a = ours.detach().float().numpy() if isinstance(ours, torch.Tensor) \
        else np.asarray(ours, np.float32)
    b = np.asarray(ref, np.float32)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


# -- K3 -----------------------------------------------------------------------


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", ACTS)
def test_k3_gradients_match_jax(act, bias):
    """dx, dw and db of ``dense`` through ``MatmulFusedFn`` against
    ``jax.grad`` of the JAX package's jnp ``dense`` and of its
    ``matmul_fused_ref`` on the same cotangent, fp32."""
    rng = np.random.default_rng(ACTS.index(act) + 10 * bias)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    w = (rng.standard_normal((12, 9)) / 3).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32) if bias else None
    dy = rng.standard_normal((2, 7, 9)).astype(np.float32)
    tx, tw = _t(x), _t(w)
    tb = _t(b) if bias else None
    y = mm_ops.matmul_fused(tx, tw, tb, act)
    assert y.grad_fn is not None
    with torch.no_grad():  # the same values as the call without autograd
        assert torch.equal(y, mm_ops.matmul_fused(tx, tw, tb, act))
    (y * torch.from_numpy(dy)).sum().backward()

    def f_dense(x, w, b):
        params = {"w": w} if b is None else {"w": w, "b": b}
        return jnp.sum(jlinear.dense(params, x, act=act) * dy)

    def f_ref(x, w, b):
        return jnp.sum(jmm_ref(x, w, b, act) * dy)

    argn = (0, 1, 2) if bias else (0, 1)
    for f in (f_dense, f_ref):
        g = jax.grad(f, argnums=argn)(jnp.asarray(x), jnp.asarray(w),
                                      None if b is None else jnp.asarray(b))
        _close(tx.grad, g[0], 1e-5)
        _close(tw.grad, g[1], 1e-5)
        if bias:
            _close(tb.grad, g[2], 1e-5)


def test_k3_backward_is_k3_calls(monkeypatch):
    """The backward's products are K3 calls on transposed copies: dz w^T,
    x^T dz, and for silu/gelu one more for z; relu reads y."""
    calls = []
    real = mm_ops._call

    def spy(x, w, b, act, role="forward"):
        calls.append((role, tuple(x.shape), tuple(w.shape), act,
                      w.is_contiguous()))
        return real(x, w, b, act, role)

    monkeypatch.setattr(mm_ops, "_call", spy)
    for act, z in (("none", 0), ("relu", 0), ("gelu", 1), ("silu", 1)):
        calls.clear()
        x, w = _t(np.ones((5, 4))), _t(np.ones((4, 3)))
        mm_ops.matmul_fused(x, w, act=act).sum().backward()
        roles = [c[0] for c in calls]
        assert roles == ["forward"] + ["z"] * z + ["dx", "dw"], roles
        assert calls[-2][1:] == ((5, 3), (3, 4), "none", True)
        assert calls[-1][1:] == ((4, 5), (5, 3), "none", True)


def test_k3_needs_no_grad_to_call_as_before():
    """Under ``no_grad`` or with nothing requiring grad, no graph: the
    serving path is the call it was."""
    x, w = _t(np.ones((3, 4))), _t(np.ones((4, 2)))
    with torch.no_grad():
        assert mm_ops.matmul_fused(x, w).grad_fn is None
    assert mm_ops.matmul_fused(x.detach(), w.detach()).grad_fn is None


# -- K10 ----------------------------------------------------------------------

#: (sq, skv, h, kvh, causal, window, cap): causal; a window; the softcap;
#: GQA; non-causal with sq != skv; sq not a multiple of the chunk (16)
K10_CASES = [
    (40, 40, 4, 4, True, 0, 0.0),
    (40, 40, 4, 2, True, 12, 0.0),
    (40, 40, 4, 2, True, 0, 5.0),
    (37, 37, 4, 1, True, 20, 3.0),
    (24, 40, 4, 2, False, 0, 0.0),
    (21, 53, 2, 1, False, 0, 4.0),
]


def _attn_inputs(seed, b, sq, skv, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, sq, h, hd)).astype(np.float32))


@pytest.mark.parametrize("case", K10_CASES)
def test_k10_gradients_match_jax(case):
    """dq, dk, dv through ``FlashAttentionFn`` (the plain forward and its
    m/l, the plain backward over chunk pairs of 16) against ``jax.grad``
    of ``chunked_attention`` (JAX's custom-VJP flash backward) at chunks
    of 16, fp32."""
    sq, skv, h, kvh, causal, window, cap = case
    q, k, v, do = _attn_inputs(sum(case[:4]), 2, sq, skv, h, kvh, 8)
    tq, tk, tv = _t(q), _t(k), _t(v)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    out = attn_ops.flash_attention(tq, tk, tv, chunk=16, **kw)
    (out * torch.from_numpy(do)).sum().backward()

    def f(q, k, v):
        o = jattn.chunked_attention(q, k, v, chunk_q=16, chunk_kv=16, **kw)
        return jnp.sum(o * do), o

    (_, jo), g = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(out, jo, 1e-5)
    for ours, ref in zip((tq.grad, tk.grad, tv.grad), g):
        _close(ours, ref, 1e-4)


@pytest.mark.parametrize("case", K10_CASES[:4] + K10_CASES[5:])
def test_k10_m_and_l_match_jax(case):
    """The plain version's m and l ([b, h, sq]) against those
    ``_flash_fwd_scan`` saves ([b, sq_p, h], kv heads repeated)."""
    sq, skv, h, kvh, causal, window, cap = case
    q, k, v, _ = _attn_inputs(sum(case[:4]), 2, sq, skv, h, kvh, 8)
    scale = 1.0 / math.sqrt(8)
    _, m, l = attn_ref.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, attn_softcap=cap, scale=scale,
        return_ml=True)
    cq, ck = min(16, sq), min(16, skv)
    pq, pk = (-sq) % cq, (-skv) % ck
    jq = jnp.pad(jnp.asarray(q), ((0, 0), (0, pq), (0, 0), (0, 0)))
    rep = lambda a: jnp.repeat(jnp.pad(  # noqa: E731
        jnp.asarray(a), ((0, 0), (0, pk), (0, 0), (0, 0))), h // kvh, axis=2)
    pairs = jattn._visible_pairs((sq + pq) // cq, (skv + pk) // ck, cq, ck,
                                 causal, window, 0)
    meta = (causal, window, cap, scale, 0, cq, ck, skv)
    _, jm, jl = jattn._flash_fwd_scan(jq, rep(k), rep(v),
                                      jnp.asarray(pairs, jnp.int32), meta)
    _close(m, np.asarray(jm)[:, :sq].transpose(0, 2, 1), 1e-6)
    _close(l, np.asarray(jl)[:, :sq].transpose(0, 2, 1), 1e-5)
    assert m.dtype == l.dtype == torch.float32


def test_k10_bwd_pairs_are_jax_visible_pairs():
    for n_q, n_kv, causal, window in ((4, 4, True, 0), (5, 5, True, 20),
                                      (3, 7, False, 0), (6, 6, True, 17)):
        assert attn_ops._visible_pairs(n_q, n_kv, 8, 8, causal, window) == \
            jattn._visible_pairs(n_q, n_kv, 8, 8, causal, window, 0)


# -- K11 ----------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(37, 16), (32, 32), (9, 16)])
def test_k11_gradients_match_jax(s, chunk):
    """dr, dk, dv, dlogw, du and the initial state's gradient through
    ``Wkv6Fn`` (its backward autodiff of ``wkv6_chunked_ref``) against
    ``jax.grad`` of ``_wkv6_chunked`` with a nonzero state in, both
    outputs given cotangents; fp32."""
    b, h, e = 2, 3, 8
    rng = np.random.default_rng(s + chunk)
    r, k, v = (rng.standard_normal((b, s, h, e)).astype(np.float32) * 0.5
               for _ in range(3))
    logw = -np.exp(rng.standard_normal((b, s, h, e)).astype(np.float32) - 1)
    u = rng.standard_normal((h, e)).astype(np.float32)
    s0 = rng.standard_normal((b, h, e, e)).astype(np.float32)
    do = rng.standard_normal((b, s, h, e)).astype(np.float32)
    ds = rng.standard_normal((b, h, e, e)).astype(np.float32)
    ins = [_t(a) for a in (r, k, v, logw, u, s0)]
    o, sf = wkv6_ops.wkv6(*ins[:5], chunk=chunk, state=ins[5])
    ((o * torch.from_numpy(do)).sum()
     + (sf * torch.from_numpy(ds)).sum()).backward()

    def f(*a):
        jo, js = jrwkv._wkv6_chunked(*a[:5], chunk, a[5])
        return jnp.sum(jo * do) + jnp.sum(js * ds)

    g = jax.grad(f, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (r, k, v, logw, u, s0)))
    for t, ref in zip(ins, g):
        _close(t.grad, ref, 1e-4)


def test_k11_final_state_unused():
    """Training passes no cache: the final state gets no cotangent and the
    backward differentiates o alone."""
    rng = np.random.default_rng(1)
    r, k, v = (_t(rng.standard_normal((1, 10, 2, 4))) for _ in range(3))
    logw = _t(-np.exp(rng.standard_normal((1, 10, 2, 4)) - 1))
    u = _t(rng.standard_normal((2, 4)))
    o, _ = wkv6_ops.wkv6(r, k, v, logw, u, chunk=4)
    o.sum().backward()
    r2, k2, v2, w2, u2 = (t.detach().clone().requires_grad_(True)
                          for t in (r, k, v, logw, u))
    wkv6_ref.wkv6_chunked_ref(r2, k2, v2, w2, u2, 4)[0].sum().backward()
    for a, b in zip((r, k, v, logw, u), (r2, k2, v2, w2, u2)):
        assert torch.allclose(a.grad, b.grad, rtol=1e-6, atol=1e-6)


# -- gradcheck ----------------------------------------------------------------


@pytest.fixture
def float64_acc(monkeypatch):
    """The plain versions' accumulation type set to float64, so that
    gradcheck's finite differences see no fp32 rounding."""
    for mod in (mm_ref, mm_ops, attn_ref, attn_ops, wkv6_ref):
        monkeypatch.setattr(mod, "ACC_DTYPE", torch.float64)


def _d(shape, rng, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale
                            ).requires_grad_(True)


@pytest.mark.parametrize("act", ACTS)
def test_k3_gradcheck(act, float64_acc):
    rng = np.random.default_rng(3)
    x, w, b = _d((4, 3), rng), _d((3, 5), rng), _d((5,), rng)
    assert torch.autograd.gradcheck(
        lambda x, w, b: mm_ops.matmul_fused(x, w, b, act), (x, w, b))


@pytest.mark.parametrize("causal,window,cap,kvh", [
    (True, 0, 0.0, 2), (True, 3, 2.0, 1), (False, 0, 1.5, 1)])
def test_k10_gradcheck(causal, window, cap, kvh, float64_acc):
    rng = np.random.default_rng(4)
    q, k, v = _d((1, 5, 2, 4), rng), _d((1, 5, kvh, 4), rng), \
        _d((1, 5, kvh, 4), rng)
    assert torch.autograd.gradcheck(
        lambda q, k, v: attn_ops.flash_attention(
            q, k, v, causal=causal, window=window, attn_softcap=cap,
            chunk=2), (q, k, v))


def test_k11_gradcheck(float64_acc):
    rng = np.random.default_rng(5)
    r, k, v = (_d((1, 5, 1, 3), rng, 0.5) for _ in range(3))
    logw = torch.from_numpy(-np.exp(rng.standard_normal((1, 5, 1, 3)) - 1)
                            ).requires_grad_(True)
    u, s0 = _d((1, 3), rng), _d((1, 1, 3, 3), rng)

    def f(r, k, v, logw, u, s0):
        o, s = wkv6_ops.wkv6(r, k, v, logw, u, chunk=2, state=s0)
        return o, s

    assert torch.autograd.gradcheck(f, (r, k, v, logw, u, s0))


def test_k11_backward_is_finite_at_strong_decays():
    """Decays past fp32's exp range inside a chunk (|cw| up to about 500):
    the pairs j >= i are selected away in the exponent, so the plain
    backward stays finite and equals autograd through the per-step
    recurrence, whose every decay is at most 1."""
    rng = np.random.default_rng(9)
    shape = (1, 40, 2, 8)
    r, k, v = (_t(rng.standard_normal(shape) * 0.5) for _ in range(3))
    logw = _t(-np.exp(2.0 + rng.standard_normal(shape)))
    u = _t(rng.standard_normal((2, 8)))
    o, _ = wkv6_ops.wkv6(r, k, v, logw, u, chunk=32)
    o.sum().backward()
    ins2 = [t.detach().clone().requires_grad_(True) for t in (r, k, v, logw,
                                                               u)]
    wkv6_ref.wkv6_reference(*ins2)[0].sum().backward()
    for a, b in zip((r, k, v, logw, u), ins2):
        assert torch.isfinite(a.grad).all()
        _close(a.grad, b.grad.numpy(), 1e-4)

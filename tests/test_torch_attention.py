"""The port's attention (``repro_torch.nn.attention``) and the plain
version of its flash-attention kernel K10
(``repro_torch.kernels.attention``) against the JAX package, on the CPU.

The oracles are the JAX package's jnp paths (``chunked_attention``,
``reference_attention``, ``decode_attention``, ``cache_update``), never its
Pallas kernel, which does not run under the installed jax (ROADMAP.md §3,
R1).  Inputs are numpy arrays from a seed, handed to both packages.
"""
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.nn import attention as tattn

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(seed, b, sq, skv, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32),
            rng.standard_normal((b, skv, kvh, hd)).astype(np.float32))


def _both(arrs, dtype):
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrs],
            [jnp.asarray(a, jdt) for a in arrs])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _err(a, b):
    return float(np.abs(_f32(a) - _f32(b)).max())


#: K10's tiles (BQ, BK in csrc/flash_attention.cu)
BQ = 64
BK = 64


def kv_tile_range(q_tile, n_kv, causal, window, bq=BQ, bk=BK):
    """``(lo, hi)``, inclusive, of the kv tiles K10's block of query tile
    ``q_tile`` visits: those with any key that a query row of the tile
    (padded to ``bq`` rows) can see.  The kernel's ``j_lo``/``j_hi``
    restated; ``hi < lo`` means none."""
    q_lo = q_tile * bq
    hi = n_kv - 1
    if causal:
        hi = min(hi, (q_lo + bq - 1) // bk)
    lo = 0
    if window > 0:
        t = q_lo - window + 2 - bk
        if t > 0:
            lo = -(-t // bk)
    return lo, hi


def smem_bytes(hd):
    """K10's dynamic shared memory a block (``smem_bytes<HD>`` restated):
    q and k tiles (rows padded by one float), the v tile, the score tile
    and three row vectors."""
    return 4 * (BQ * (hd + 1) + BK * (hd + 1) + BK * hd + BQ * (BK + 1)
                + 3 * BQ)


#: relative to max(1, max|out|).  fp32: both sides sum the same fp32
#: products in another order.  bf16: the output is rounded to bf16 (one
#: ulp is up to 2^-7 of |out|), and JAX's chunked path casts p to bf16
#: before p.v (2^-9 on each weight), which K10 does not: 2^-6 allows two
#: ulps.
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}


def _close(a, b, dtype):
    err, top = _err(a, b), float(np.abs(_f32(b)).max())
    assert err <= TOL[dtype] * max(1.0, top), (err, top)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_matches_jax(causal, window, cap, group, dtype):
    """K10's plain version against JAX's ``chunked_attention`` (chunks of
    16, so 37 query rows are not a multiple of the tile) and its
    materialized ``reference_attention``."""
    kvh = 2
    arrs = _qkv(7 + group, 2, 37, 37, kvh * group, kvh, 32)
    (q, k, v), (jq, jk, jv) = _both(arrs, dtype)
    kw = dict(causal=causal, window=window, attn_softcap=cap)
    ours = flash_attention_ref(q, k, v, **kw)
    assert ours.dtype == q.dtype and ours.shape == q.shape
    chunked = jattn.chunked_attention(jq, jk, jv, chunk_q=16, chunk_kv=16,
                                      **kw)
    ref = jattn.reference_attention(jq, jk, jv, **kw)
    _close(ours, chunked, dtype)
    _close(ours, ref, dtype)
    # the wrapper takes the plain version for a CPU tensor, no launch
    before = attn_ops.flash_attention.launches
    assert torch.equal(attn_ops.flash_attention(q, k, v, **kw), ours)
    assert attn_ops.flash_attention.launches == before


def _emulate_k10(q, k, v, *, causal, window, cap, scale,
                 tile_range=kv_tile_range):
    """The kernel's schedule in PyTorch: per 64-row query tile, the kv
    tiles of ``tile_range`` in order, an online softmax with fp32 m, l
    and acc, the masks of the kernel, out = acc / max(l, 1e-30)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    bq, bk = BQ, BK
    n_kv = -(-skv // bk)
    qf = q.float()
    kf = k.float().repeat_interleave(g, 2)
    vf = v.float().repeat_interleave(g, 2)
    out = torch.zeros(b, sq, h, hd)
    for t in range(-(-sq // bq)):
        q0 = t * bq
        qb = qf[:, q0:q0 + bq]                        # [b, r, h, hd]
        rows = qb.shape[1]
        m = torch.full((b, h, rows), -1e30)
        l = torch.zeros(b, h, rows)
        acc = torch.zeros(b, h, rows, hd)
        lo, hi = tile_range(t, n_kv, causal, window)
        for j in range(lo, hi + 1):
            k0 = j * bk
            s = torch.einsum("bqhd,bkhd->bhqk", qb, kf[:, k0:k0 + bk]) * scale
            if cap > 0:
                s = cap * torch.tanh(s / cap)
            qp = q0 + torch.arange(rows)[:, None]
            kp = k0 + torch.arange(s.shape[-1])[None, :]
            ok = kp < skv
            if causal:
                ok = ok & (qp >= kp)
            if window > 0:
                ok = ok & (kp > qp - window)
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None]) * (m_new > -5e29)[..., None]
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ vf[:, k0:k0 + bk].transpose(1, 2)
            m = m_new
        res = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + rows] = res.transpose(1, 2)
    return out.to(q.dtype)


@pytest.mark.parametrize("sq,window", [(200, 0), (200, 70), (130, 64),
                                       (64, 1), (300, 150)])
@pytest.mark.parametrize("causal", [True, False])
def test_k10_schedule_matches_plain_version(sq, window, causal):
    """Tile skipping and the online softmax, as the kernel runs them,
    give the plain version's result: no visible tile is skipped."""
    arrs = _qkv(sq + window, 1, sq, sq, 4, 2, 16)
    q, k, v = (torch.from_numpy(a) for a in arrs)
    kw = dict(causal=causal, window=window, cap=7.0, scale=0.25)
    got = _emulate_k10(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, causal=causal, window=window,
                               attn_softcap=7.0, scale=0.25)
    assert _err(got, want) <= 1e-5


def _smoke_limit():
    """``chip_smoke.py``'s element-wise limit of K10 on bf16 outputs."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.LM_KERNEL_TOL["bfloat16"]


def _skip_first(t, n_kv, causal, window):
    lo, hi = kv_tile_range(t, n_kv, causal, window)
    return (lo + 1 if lo > 0 else lo), hi


@pytest.mark.parametrize("fault", ["none", "skip_edge_tile", "no_window"])
def test_k10_smoke_limit_sees_a_window_fault(fault):
    """The card's check of K10 (every element within rtol * |plain| +
    atol) passes the kernel's schedule in bf16 and fails one that skips
    the window's lowest visible tile or drops the window mask: 600 rows
    with window 300, so the window and the skip bite."""
    rtol, atol = _smoke_limit()
    arrs = _qkv(11, 1, 600, 600, 2, 1, 64)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    kw = dict(causal=True, window=300, cap=50.0, scale=0.125)
    plain = flash_attention_ref(q, k, v, causal=True, window=300,
                                attn_softcap=50.0, scale=0.125)
    if fault == "no_window":
        kw["window"] = 0
    tiles = _skip_first if fault == "skip_edge_tile" else kv_tile_range
    got = _emulate_k10(q, k, v, tile_range=tiles, **kw)
    ok = bool(((got.float() - plain.float()).abs()
               <= rtol * plain.float().abs() + atol).all())
    assert ok == (fault == "none")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 63, 64, 65, 100, 4096])
def test_kv_tile_range_matches_visible_pairs(causal, window):
    """K10's kv-tile range per query tile equals the JAX package's static
    pair list (``_visible_pairs``) at the kernel's 64 x 64 tiles."""
    for sq in (1, 63, 64, 65, 200, 4500):
        n_q = -(-sq // BQ)
        n_kv = n_q
        pairs = set(jattn._visible_pairs(n_q, n_kv, BQ,
                                         BK, causal, window, 0))
        ours = set()
        for i in range(n_q):
            lo, hi = kv_tile_range(i, n_kv, causal, window)
            ours |= {(i, j) for j in range(lo, hi + 1)}
        assert ours == pairs, (sq, causal, window)


def test_k10_tiles_skip_what_the_window_hides():
    """At gemma2's longest smoke prompt (4500 rows, window 4096) a local
    layer's first query tiles see no more than the causal range and the
    last ones skip the tiles the window hides."""
    n = -(-4500 // BQ)
    assert kv_tile_range(0, n, True, 4096) == (0, 0)
    lo, hi = kv_tile_range(n - 1, n, True, 4096)
    assert (lo, hi) == (6, n - 1)
    assert kv_tile_range(n - 1, n, True, 0) == (0, n - 1)


@pytest.mark.parametrize("hd", attn_ops.HEAD_DIMS)
def test_k10_shared_memory_fits_the_card(hd):
    """One block's dynamic shared memory fits an H100 block's 227 KB."""
    assert smem_bytes(hd) <= 232448
    assert smem_bytes(256) > 48 * 1024  # hence the opt-in


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("window", [0, 8])
def test_decode_attention_matches_jax(window, group, dtype):
    """Ring buffers (window 8 on an 8-slot cache, positions past S) and a
    full cache, per-request positions; p cast to the cache dtype before
    the PV product as in JAX."""
    b, S, kvh, hd = 3, 8 if window else 24, 2, 32
    rng = np.random.default_rng(window + group)
    q = rng.standard_normal((b, 1, kvh * group, hd)).astype(np.float32)
    kc = rng.standard_normal((b, S, kvh, hd)).astype(np.float32)
    vc = rng.standard_normal((b, S, kvh, hd)).astype(np.float32)
    pos = np.array([3, 17, 23] if window else [0, 9, 23], np.int32)
    (tq, tk, tv), (jq, jk, jv) = _both((q, kc, vc), dtype)
    kw = dict(window=window, attn_softcap=5.0)
    ours = tattn.decode_attention(tq, tk, tv, torch.from_numpy(pos), **kw)
    ref = jattn.decode_attention(jq, jk, jv, jnp.asarray(pos), **kw)
    assert ours.dtype == tq.dtype
    _close(ours, ref, dtype)


def test_decode_slot_arithmetic_is_floored():
    """pos - mod(pos - i, S) needs the floored modulo: with fmod's
    truncation a slot ahead of the position would look valid."""
    S, pos = 8, torch.tensor([[3]])
    idx = torch.arange(S)[None, :]
    p_slot = pos - torch.remainder(pos - idx, S)
    assert p_slot.tolist() == [[0, 1, 2, 3, -4, -3, -2, -1]]
    q = torch.zeros(1, 1, 2, 4)
    k = torch.zeros(1, S, 2, 4)
    v = torch.arange(S, dtype=torch.float32)[None, :, None, None].expand(
        1, S, 2, 4).contiguous()
    # uniform scores: the mean of the values of the valid slots 0..3
    out = tattn.decode_attention(q, k, v, torch.tensor([3]), window=S)
    assert torch.allclose(out, torch.full_like(out, 1.5))


@pytest.mark.parametrize("window", [0, 6])
def test_cache_update_matches_jax(window):
    rng = np.random.default_rng(window)
    kc = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    vc = rng.standard_normal((3, 6, 2, 4)).astype(np.float32)
    kn = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    vn = rng.standard_normal((3, 1, 2, 4)).astype(np.float32)
    pos = np.array([0, 5, 13], np.int32) if window else np.array([0, 2, 5])
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    tattn.cache_update(tk, tv, torch.from_numpy(kn), torch.from_numpy(vn),
                       torch.from_numpy(pos), window)
    jk, jv = jattn.cache_update(jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(kn), jnp.asarray(vn),
                                jnp.asarray(pos), window)
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tv.numpy(), np.asarray(jv))


def test_flash_attention_refuses_other_devices():
    meta = torch.empty((1, 4, 2, 64), device="meta")
    with pytest.raises(ValueError, match="device"):
        attn_ops.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="flash_attention"):
        attn_ops.flash_attention(torch.zeros(1, 4, 3, 64),
                                 torch.zeros(1, 4, 2, 64),
                                 torch.zeros(1, 4, 2, 64))


def test_reference_attention_matches_jax():
    """K10's plain version at an explicit scale and the softcap against
    JAX's materialized ``reference_attention`` and ``softcap``."""
    arrs = _qkv(3, 1, 12, 12, 4, 2, 16)
    (q, k, v), (jq, jk, jv) = _both(arrs, "float32")
    kw = dict(causal=True, window=5, attn_softcap=3.0, scale=0.3)
    assert _err(flash_attention_ref(q, k, v, **kw),
                jattn.reference_attention(jq, jk, jv, **kw)) <= 1e-6
    assert math.isclose(float(tattn.softcap(torch.tensor(100.0), 50.0)),
                        float(jattn.softcap(jnp.float32(100.0), 50.0)),
                        rel_tol=1e-6)

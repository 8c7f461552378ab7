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
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jattn
from repro_torch.kernels import _build
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
    """A meta tensor (the dry run's trace) gives the output's shape and
    type alone; a head count that does not divide raises."""
    meta = torch.empty((1, 4, 2, 64), device="meta")
    out = attn_ops.flash_attention(meta, meta, meta)
    assert out.device.type == "meta" and out.shape == meta.shape
    assert out.dtype == meta.dtype
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


# -- K10's tensor-core path (bf16: TMA + wgmma, ``flash_wgmma``) ------------


def _wgmma_constants():
    """The wgmma path's integer constants (``FA_BQ``, ``FA_BK``,
    ``FA_STAGES``, ``FA_THREADS``, ``FA_BOX``) as the kernel's source
    declares them."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"\b(FA_[A-Z]+) = (\d+);", src)}


#: dynamic shared memory a block may opt in to on the H100 (227 KB)
SMEM_LIMIT = 232448


def wgmma_smem_bytes(hd):
    """The wgmma block's dynamic shared memory (``FaSmem<HD>::BYTES``
    restated): the bf16 q tile, the ring of k and v tiles, 1 KB of
    alignment and the barriers (q's, a full and an empty one a stage)."""
    c = _wgmma_constants()
    stage = 2 * 2 * c["FA_BK"] * hd
    return (2 * c["FA_BQ"] * hd + c["FA_STAGES"] * stage + 1024
            + 8 * (1 + 2 * c["FA_STAGES"]))


def test_wgmma_constants():
    """Two consumer warpgroups of 64 query rows beside the producer, 64-row
    kv tiles, a ring of at least two stages, boxes one 128-byte swizzle
    row of bf16 wide."""
    c = _wgmma_constants()
    assert c == {"FA_BQ": 128, "FA_BK": 64, "FA_STAGES": 2,
                 "FA_THREADS": 384, "FA_BOX": 64}
    assert c["FA_THREADS"] == 128 * (1 + c["FA_BQ"] // 64)
    assert 2 * c["FA_BOX"] == 128
    for hd in attn_ops.HEAD_DIMS:
        assert hd % c["FA_BOX"] == 0


@pytest.mark.parametrize("hd", attn_ops.HEAD_DIMS)
def test_wgmma_shared_memory_fits_the_card(hd):
    """The q tile and two k + v stages fit an H100 block's 227 KB at every
    head_dim (192 KB and a little at 256), and every box lands on the
    128-byte swizzle's 1 KB pattern."""
    c = _wgmma_constants()
    assert wgmma_smem_bytes(hd) <= SMEM_LIMIT
    assert (2 * c["FA_BQ"] * 128) % 1024 == 0
    assert (2 * c["FA_BK"] * 128) % 1024 == 0
    if hd == 256:
        assert wgmma_smem_bytes(hd) - 1024 - 40 == 192 * 1024


def test_the_wgmma_instructions_cover_every_head_dim():
    """The kernel's p.v product is one wgmma m64n{hd}k16 for each head_dim
    it takes, and S = q k^T one m64n64k16 (a kv tile's 64 keys)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    shapes = set(re.findall(r"wgmma\.mma_async\.sync\.aligned\.m64n(\d+)k16",
                            src))
    assert shapes == {str(hd) for hd in attn_ops.HEAD_DIMS}
    for hd in attn_ops.HEAD_DIMS:
        assert f"launch<{hd}>" in src


def test_hopper_helpers_live_in_one_header():
    """K3 and K10 include the shared PTX wrappers and the tensor-map
    encoder; neither defines its own copy.  They and the stage-major conv
    kernel opt in to shared memory through the header's once-a-device
    ``opt_in_smem``, and none calls ``cudaFuncSetAttribute`` itself."""
    for name in ("matmul_fused.cu", "flash_attention.cu", "conv_chain.cu"):
        src = (_build.CSRC / name).read_text()
        assert '#include "hopper_common.cuh"' in src
        for fn in ("mbar_wait(uint32_t", "wg_desc(uint32_t",
                   "EncodeTiled encode_tiled()", "smem_addr(const void",
                   "cudaFuncSetAttribute(", "opt_in_smem(K*"):
            assert fn not in src, (name, fn)
    common = (_build.CSRC / "hopper_common.cuh").read_text()
    for fn in ("mbar_wait(uint32_t", "wg_desc(uint32_t", "tma_load_4d(",
               "EncodeTiled encode_tiled()", "smem_addr(const void",
               "opt_in_smem(K*"):
        assert fn in common


@pytest.mark.parametrize("hd", attn_ops.HEAD_DIMS)
@pytest.mark.parametrize("sq", [16, 300, 512, 1500, 4500])
def test_k10_path_at_gemma2_shapes(sq, hd):
    """Every bf16 prefill of the served gemma2-2b (head_dim 256) and the
    other head_dims takes the tensor-core path; fp32 the CUDA-core one."""
    assert attn_ops.k10_path(torch.bfloat16, sq, sq, hd) == "wgmma"
    assert attn_ops.k10_path(torch.float32, sq, sq, hd) == "simt"


def test_k10_path_counters_start_at_zero_and_the_cpu_moves_none():
    fa = attn_ops.flash_attention
    assert set(fa.path_launches) == set(attn_ops.PATH_CODES) == {"simt",
                                                                 "wgmma"}
    before = (fa.launches, dict(fa.path_launches))
    q = torch.ones(1, 5, 2, 64, dtype=torch.bfloat16)
    fa(q, q[:, :, :1], q[:, :, :1])
    assert (fa.launches, fa.path_launches) == before


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 1, 63, 64, 65, 100, 4096])
def test_wgmma_kv_tile_range_matches_visible_pairs(causal, window):
    """The wgmma block's kv-tile range (128 query rows, 64-row kv tiles)
    equals the JAX package's static pair list at those tiles."""
    c = _wgmma_constants()
    bq, bk = c["FA_BQ"], c["FA_BK"]
    for sq in (1, 63, 64, 65, 127, 128, 129, 200, 1500, 4500):
        n_q, n_kv = -(-sq // bq), -(-sq // bk)
        pairs = set(jattn._visible_pairs(n_q, n_kv, bq, bk, causal, window,
                                         0))
        ours = set()
        for i in range(n_q):
            lo, hi = kv_tile_range(i, n_kv, causal, window, bq, bk)
            ours |= {(i, j) for j in range(lo, hi + 1)}
        assert ours == pairs, (sq, causal, window)


def _emulate_wgmma(q, k, v, *, causal, window, cap, scale, split=True):
    """The wgmma kernel's schedule in PyTorch, fp32 before the final cast:
    per 128-row query tile the kv tiles of ``kv_tile_range`` in order; per
    consumer warpgroup of 64 rows the tiles it can see, the masks only on
    tiles that cross skv, a diagonal or the window's edge (k and v rows
    past skv zero-filled, as TMA fills them), the online softmax with fp32
    m, l and p, and o += P_hi v + P_lo v with P_hi = bf16(p) and P_lo =
    bf16(p - P_hi) (``split=False``: P_hi v alone, a single rounding of
    p); rows past sq are never stored."""
    c = _wgmma_constants()
    bq, bk = c["FA_BQ"], c["FA_BK"]
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    n_kv = -(-skv // bk)
    pad = n_kv * bk - skv
    qf = q.float()
    kf = torch.nn.functional.pad(k.float().repeat_interleave(h // kvh, 2),
                                 (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float().repeat_interleave(h // kvh, 2),
                                 (0, 0, 0, 0, 0, pad))
    out = torch.zeros(b, sq, h, hd)
    for t in range(-(-sq // bq)):
        lo, hi = kv_tile_range(t, n_kv, causal, window, bq, bk)
        for r_lo in range(t * bq, (t + 1) * bq, 64):
            if r_lo >= sq:
                continue
            qb = qf[:, r_lo:r_lo + 64]
            rows = qb.shape[1]
            m = torch.full((b, h, rows), -1e30)
            l = torch.zeros(b, h, rows)
            acc = torch.zeros(b, h, rows, hd)
            for j in range(lo, hi + 1):
                k0 = j * bk
                seen = ((not causal or k0 <= r_lo + 63)
                        and (window <= 0 or k0 + bk - 1 > r_lo - window))
                if not seen:
                    continue
                s = torch.einsum("bqhd,bkhd->bhqk", qb,
                                 kf[:, k0:k0 + bk]) * scale
                if cap > 0:
                    s = cap * torch.tanh(s / cap)
                edge = (k0 + bk > skv or (causal and k0 + bk - 1 > r_lo)
                        or (window > 0 and k0 <= r_lo + 63 - window))
                if edge:
                    qp = r_lo + torch.arange(rows)[:, None]
                    kp = k0 + torch.arange(bk)[None, :]
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
                vt = vf[:, k0:k0 + bk].transpose(1, 2)
                p_hi = p.bfloat16().float()
                acc = acc * alpha[..., None] + p_hi @ vt
                if split:
                    acc = acc + (p - p_hi).bfloat16().float() @ vt
                m = m_new
            res = acc / torch.clamp_min(l, 1e-30)[..., None]
            out[:, r_lo:r_lo + rows] = res.transpose(1, 2)
    return out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("window", [0, 9])
@pytest.mark.parametrize("sq", [37, 130])
def test_wgmma_schedule_with_split_p_matches_jax(sq, window, cap, causal):
    """The wgmma schedule with p split in hi and lo bf16 halves, on bf16
    inputs (4 heads over 2 kv heads, head_dim 64), against JAX's
    ``chunked_attention`` and ``reference_attention`` within ``TOL``; in
    fp32 before the cast it is within 2^-16 * max(1, max|out|) of the
    plain version (p in fp32), which a single bf16 rounding of p misses."""
    arrs = _qkv(sq + window + int(cap), 1, sq, sq, 4, 2, 64)
    (q, k, v), (jq, jk, jv) = _both(arrs, "bfloat16")
    kw = dict(causal=causal, window=window)
    scale = 0.125
    split = _emulate_wgmma(q, k, v, cap=cap, scale=scale, **kw)
    ours = split.to(torch.bfloat16)
    jkw = dict(attn_softcap=cap, scale=scale, **kw)
    _close(ours, jattn.chunked_attention(jq, jk, jv, chunk_q=16,
                                         chunk_kv=16, **jkw), "bfloat16")
    _close(ours, jattn.reference_attention(jq, jk, jv, **jkw), "bfloat16")
    plain = flash_attention_ref(q.float(), k.float(), v.float(),
                                attn_softcap=cap, scale=scale, **kw)
    limit = 2.0 ** -16 * max(1.0, plain.abs().max().item())
    assert _err(split, plain) <= limit
    single = _emulate_wgmma(q, k, v, cap=cap, scale=scale, split=False, **kw)
    assert _err(single, plain) > limit


@pytest.mark.parametrize("sq,window", [(200, 0), (200, 70), (130, 64),
                                       (64, 1), (300, 150), (129, 0)])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_schedule_matches_plain_version(sq, window, causal):
    """Tile skipping per block and per warpgroup and the masks on edge
    tiles only give the plain version's result within the split's 2^-16
    (fp32 inputs rounded to bf16, as the path takes them)."""
    arrs = _qkv(sq + window, 1, sq, sq, 4, 2, 16)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrs)
    kw = dict(causal=causal, window=window, scale=0.25)
    got = _emulate_wgmma(q, k, v, cap=7.0, **kw)
    want = flash_attention_ref(q.float(), k.float(), v.float(),
                               attn_softcap=7.0, **kw)
    assert _err(got, want) <= 2.0 ** -16 * max(1.0, want.abs().max().item())


class _Entry:
    """A stand-in of the C entry ``flash_attention_fwd`` that records its
    arguments and whether each pointer it gets is the data of a tensor
    that is alive when it is called."""

    def __init__(self):
        self.tensors, self.args = [], None

    def __call__(self, *args):
        live = {t.data_ptr() for t in (r() for r in self.tensors)
                if t is not None}
        self.args = args
        self.live = [p in live for p in args[:4]]
        return 0


@pytest.mark.parametrize("path", [None, "simt", "wgmma"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_launch_passes_live_tensors_and_the_named_path(dtype, path,
                                                       monkeypatch):
    """``_launch`` hands the C entry q, k, v and an output that are alive
    when it is called (the output is the tensor it returns) and the path
    code of ``k10_path`` (or the path asked for, the CUDA-core kernel for
    either type), and steps that path's counter; the tensor-core path
    refuses fp32."""
    import weakref

    tdt = DTYPES[dtype][0]
    q, k, v = (torch.from_numpy(a).to(tdt)
               for a in _qkv(1, 1, 20, 20, 4, 2, 64))
    entry = _Entry()
    entry.tensors = [weakref.ref(t) for t in (q, k, v)]
    empty_like = torch.empty_like

    def recording(t):
        out = empty_like(t)
        entry.tensors.append(weakref.ref(out))
        return out

    fake = type("Lib", (), {"flash_attention_fwd": entry})()
    monkeypatch.setattr(attn_ops, "check_cuda", lambda *a: None)
    monkeypatch.setattr(attn_ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(attn_ops.torch, "empty_like", recording)
    monkeypatch.setattr(_build, "library", lambda: fake)
    fa = attn_ops.flash_attention
    monkeypatch.setattr(fa, "launches", 0)
    monkeypatch.setattr(fa, "path_launches",
                        dict.fromkeys(attn_ops.PATH_CODES, 0))
    chosen = attn_ops.k10_path(tdt, 20, 20, 64)
    if path == "wgmma" and chosen != "wgmma":
        with pytest.raises(ValueError, match="path"):
            attn_ops._launch(q, k, v, True, 0, 0.0, 0.125, path=path)
        assert entry.args is None and fa.launches == 0
        return
    out = attn_ops._launch(q, k, v, True, 9, 5.0, 0.125, path=path)
    want = path or chosen
    assert entry.live == [True] * 4
    assert entry.args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr())
    assert entry.args[4:15] == (1, 20, 20, 4, 2, 64, 1, 9, 0.125, 5.0,
                                int(dtype == "bfloat16"))
    assert entry.args[15] == attn_ops.PATH_CODES[want]
    assert out.shape == q.shape and out.dtype == q.dtype
    assert fa.launches == 1
    assert fa.path_launches == {**dict.fromkeys(attn_ops.PATH_CODES, 0),
                                want: 1}


def _fma32(a, b, c):
    """fmaf: a * b + c rounded once to float32 (ties to even)."""
    from fractions import Fraction

    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    x = np.float32(float(exact))  # at most one ulp off: pick the nearest
    best = x
    for y in (np.nextafter(x, np.float32(np.inf)),
              np.nextafter(x, np.float32(-np.inf))):
        d, e = abs(Fraction(float(y)) - exact), abs(Fraction(float(best))
                                                    - exact)
        if d < e or (d == e and int(y.view(np.int32)) % 2 == 0):
            best = y
    return best


@pytest.mark.parametrize("cap", [50.0, 30.0, 7.0, 5.0, 3.0])
def test_softcap_quotient_is_the_correctly_rounded_division(cap):
    """The wgmma kernel's s / cap (``div_rn``: s times the rounded
    reciprocal, then two fmaf remainder corrections) equals the IEEE
    float32 quotient that the plain version computes, for scores of the
    magnitudes attention gives and far beyond."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "tanhf(div_rn(x, cap, inv_cap))" in src
    rng = np.random.default_rng(int(cap))
    d = np.float32(cap)
    inv = np.float32(1.0) / d
    xs = np.concatenate([rng.standard_normal(300) * 30,
                         rng.uniform(-1e4, 1e4, 100)]).astype(np.float32)
    for x in xs:
        q = np.float32(x * inv)
        q = _fma32(_fma32(-q, d, x), inv, q)
        q = _fma32(_fma32(-q, d, x), inv, q)
        assert q == x / d, (x, q, x / d)


def test_launch_refuses_what_tma_cannot_describe(monkeypatch):
    """A bf16 q that does not start on a 16-byte boundary cannot be a TMA
    tensor map's base: the wgmma path refuses it before any launch."""
    monkeypatch.setattr(attn_ops, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("launched"))
    k = torch.zeros(1, 8, 1, 64, dtype=torch.bfloat16)
    q = torch.zeros(8 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 1, 64)
    assert q.data_ptr() % attn_ops.TMA_ALIGN
    with pytest.raises(ValueError, match="aligned"):
        attn_ops._launch(q, k, k, True, 0, 0.0, 0.125)

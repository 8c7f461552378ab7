"""The port's cross-attention pieces (``repro_torch.nn.attention``:
``attention_spec(cross, kv_dim)``, ``cross_kv``, ``cross_attention_cached``
and the context branch of ``attention_apply``; the cross block of
``repro_torch.models.common``) and K10's plain version at sq != skv,
non-causal, against the JAX package on the CPU.

The oracle is the JAX package's jnp code: its cross branch runs
``chunked_attention``, its cached branch ``decode_attention``; neither
reaches a Pallas kernel.  Weights come from the JAX init (the gates of a
cross block redrawn away from 0), inputs are numpy arrays from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as jcommon
from repro.nn import attention as jattn
from repro.nn import param as jparam
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.models import common as tcommon
from repro_torch.nn import attention as tattn
from repro_torch.nn.param import tree_map
from torch_cross_common import (AUDIO, VLM, both, cfgs, close, spec_rows,
                                to_jax)

#: relative to max(1, max|ref|).  fp32: the same fp32 sums in another
#: order.  bf16: one bf16 rounding of the output is 2^-7 of it, and the
#: two packages round the projections' outputs and p at other places:
#: 2^-5 (two ulps and the roundings of q and k before the scores).
TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -5}
#: the widths of the context stream: the model's own, and another
KV_DIMS = (None, 192)


def _params(spec_j, dtype, seed=0):
    """A spec's JAX init in ``dtype`` and the same tensors for the port."""
    jp = jparam.init_tree(spec_j, jax.random.PRNGKey(seed), dtype)
    tp = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, str(a.dtype))), jax.tree_util.tree_map(
            np.asarray, jp))
    return tree_map(to_jax, tp), tp


def _inputs(tcfg, dtype, b=2, s=7, t=11, kv_dim=None, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, tcfg.d_model)).astype(np.float32)
    ctx = rng.standard_normal((b, t, kv_dim or tcfg.d_model)).astype(
        np.float32)
    return both(x, dtype), both(ctx, dtype)


# -- the spec ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VLM, AUDIO])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kv_dim", KV_DIMS)
def test_attention_spec_matches_jax(arch, qk_norm, kv_dim):
    """``attention_spec(cfg, cross=True, kv_dim=...)``: JAX's keys, shapes,
    axes, init rules and dtypes; wk/wv read ``kv_dim or d_model``."""
    jcfg, tcfg = cfgs(arch, qk_norm=qk_norm)
    ours = tattn.attention_spec(tcfg, cross=True, kv_dim=kv_dim)
    assert spec_rows(ours) == spec_rows(
        jattn.attention_spec(jcfg, cross=True, kv_dim=kv_dim))
    assert ours["wk"]["w"].shape == (kv_dim or tcfg.d_model, tcfg.kv_dim)
    assert spec_rows(tattn.attention_spec(tcfg)) == spec_rows(
        jattn.attention_spec(jcfg))


@pytest.mark.parametrize("kv_dim", KV_DIMS)
def test_cross_block_spec_matches_jax(kv_dim):
    """``block_spec(cfg, cross=True, d_in=...)``: JAX's tree, with the
    fp32 gates of shape (1,) at init zeros."""
    jcfg, tcfg = cfgs(VLM)
    ours = tcommon.block_spec(tcfg, cross=True, d_in=kv_dim or 0)
    assert spec_rows(ours) == spec_rows(
        jcommon.block_spec(jcfg, cross=True, d_in=kv_dim or 0))
    for g in ("gate_attn", "gate_mlp"):
        assert (ours[g].shape, ours[g].init, ours[g].dtype) == (
            (1,), "zeros", "float32")
    assert "gate_attn" not in tcommon.block_spec(tcfg)


# -- the pieces ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kv_dim", KV_DIMS)
def test_cross_kv_matches_jax(dtype, qk_norm, kv_dim):
    """``cross_kv``: k (after ``k_norm`` under QK-norm) and v of a context
    of width ``kv_dim``, [b, t, kvh, hd]."""
    jcfg, tcfg = cfgs(VLM, dtype, qk_norm=qk_norm)
    jp, tp = _params(jattn.attention_spec(jcfg, cross=True, kv_dim=kv_dim),
                     dtype)
    _, (tctx, jctx) = _inputs(tcfg, dtype, kv_dim=kv_dim)
    tk, tv = tattn.cross_kv(tp, tctx, tcfg)
    jk, jv = jattn.cross_kv(jp, jctx, jcfg)
    assert tk.shape == (2, 11, tcfg.num_kv_heads, tcfg.head_dim)
    assert tk.dtype == getattr(torch, dtype)
    close(tk, jk, TOL[dtype])
    close(tv, jv, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("cache_dtype", ["bfloat16", "float32"])
def test_cross_attention_cached_matches_jax(dtype, qk_norm, cache_dtype):
    """``cross_attention_cached``: one query a request against the cached
    K/V, every slot visible (``decode_attention`` at t - 1), in the
    model's dtype against a bf16 or fp32 cache."""
    jcfg, tcfg = cfgs(VLM, dtype, qk_norm=qk_norm)
    jp, tp = _params(jattn.attention_spec(jcfg, cross=True), dtype)
    (tx, jx), _ = _inputs(tcfg, dtype, s=1)
    rng = np.random.default_rng(5)
    kv = [rng.standard_normal((2, 13, tcfg.num_kv_heads, tcfg.head_dim))
          .astype(np.float32) for _ in range(2)]
    (tk, jk), (tv, jv) = (both(a, cache_dtype) for a in kv)
    ours = tattn.cross_attention_cached(tp, tx, tk, tv, tcfg)
    ref = jattn.cross_attention_cached(jp, jx, jk, jv, jcfg)
    assert ours.shape == (2, 1, tcfg.d_model)
    assert ours.dtype == tx.dtype
    close(ours, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
@pytest.mark.parametrize("kv_dim", KV_DIMS)
def test_attention_apply_with_context_matches_jax(dtype, qk_norm, kv_dim):
    """The context branch of ``attention_apply``: k/v from the context, no
    RoPE (the positions and the mode do not matter), no causal mask, K10's
    plain version over every key; JAX's ``chunked_attention`` the
    oracle."""
    jcfg, tcfg = cfgs(VLM, dtype, qk_norm=qk_norm)
    jp, tp = _params(jattn.attention_spec(jcfg, cross=True, kv_dim=kv_dim),
                     dtype)
    (tx, jx), (tctx, jctx) = _inputs(tcfg, dtype, kv_dim=kv_dim)
    ref, cache = jattn.attention_apply(jp, jx, jcfg, context=jctx,
                                       mode="full")
    assert cache is None
    ours = tattn.attention_apply(tp, tx, tcfg, context=tctx)
    close(ours, ref, TOL[dtype])
    moved = tattn.attention_apply(tp, tx, tcfg, context=tctx, mode="decode",
                                  positions=torch.tensor([[5] * 7] * 2))
    assert torch.equal(moved, ours)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_context_branch_writes_the_cache_in_bf16(dtype):
    """With a cache the context branch writes its k/v whole, rounded to
    the cache's bf16, as JAX's ``cross_kv(...).astype(jnp.bfloat16)``; its
    output reads the unrounded k/v, as JAX's prefill does."""
    jcfg, tcfg = cfgs(VLM, dtype)
    jp, tp = _params(jattn.attention_spec(jcfg, cross=True), dtype)
    (tx, _), (tctx, jctx) = _inputs(tcfg, dtype)
    cache = {n: torch.full((2, 11, tcfg.num_kv_heads, tcfg.head_dim), 7.0,
                           dtype=torch.bfloat16) for n in ("k", "v")}
    out = tattn.attention_apply(tp, tx, tcfg, context=tctx, cache=cache)
    assert torch.equal(out, tattn.attention_apply(tp, tx, tcfg,
                                                  context=tctx))
    jk, jv = jattn.cross_kv(jp, jctx, jcfg)
    # fp32: k/v a few fp32 ulps apart round to the same bf16 value or
    # to neighbours, 2^-7 apart at most
    for ours, ref in ((cache["k"], jk), (cache["v"], jv)):
        close(ours, ref.astype(jnp.bfloat16),
              2.0 ** -7 if dtype == "float32" else TOL[dtype])
    tk, tv = tattn.cross_kv(tp, tctx, tcfg)
    assert torch.equal(cache["k"], tk.to(torch.bfloat16))
    assert torch.equal(cache["v"], tv.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True])
def test_cross_block_matches_jax(dtype, gated):
    """``block_apply(context=...)``: RoPE off, each residual scaled by its
    gate's tanh cast to the activation's dtype, against JAX's block; at
    JAX's init (gates 0) the block returns its input as it was."""
    jcfg, tcfg = cfgs(VLM, dtype)
    jp, tp = _params(jcommon.block_spec(jcfg, cross=True,
                                        d_in=jcfg.d_model), dtype)
    if gated:
        gen = torch.Generator().manual_seed(4)
        for g in ("gate_attn", "gate_mlp"):
            tp[g] = 1.0 + 0.25 * torch.randn((1,), generator=gen)
        jp = tree_map(to_jax, tp)
    (tx, jx), (tctx, jctx) = _inputs(tcfg, dtype)
    ref, _, _ = jcommon.block_apply(jp, jx, jcfg, mode="full", context=jctx)
    ours, aux = tcommon.block_apply(tp, tx, tcfg, mode="full", context=tctx)
    assert aux == {}
    close(ours, ref, TOL[dtype])
    if not gated:  # tanh(0) = 0: the cross path adds nothing
        assert torch.equal(ours, tx)


# -- K10's plain version at sq != skv ----------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv", [(1, 40), (7, 33), (40, 9)])
@pytest.mark.parametrize("group", [1, 4])
def test_k10_plain_non_causal_at_sq_ne_skv(dtype, sq, skv, group):
    """K10's plain version, non-causal, with sq != skv (a cross-attention:
    prompt rows against media keys), GQA ``group`` query heads a kv head,
    against JAX's ``chunked_attention`` over chunks that pad both sides."""
    rng = np.random.default_rng(sq * 100 + skv)
    kvh, hd = 2, 64
    q = rng.standard_normal((2, sq, kvh * group, hd)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, kvh, hd)).astype(np.float32)
            for _ in range(2))
    (tq, jq), (tk, jk), (tv, jv) = (both(a, dtype) for a in (q, k, v))
    ours = flash_attention_ref(tq, tk, tv, causal=False)
    ref = jattn.chunked_attention(jq, jk, jv, causal=False, chunk_q=16,
                                  chunk_kv=16)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -6
    close(ours, ref, tol)

"""The port's int8 KV cache (``repro_torch.nn.attention``: ``quantize_kv``,
``dequantize_kv``, ``decode_attention_quant``, ``cache_update_quant``, the
prefill's quantized write; ``models.common.kv_cache_param``) against the
JAX package's, on the CPU.  No config turns ``kv_quant`` on: the tests set
it with ``dataclasses.replace``, as ``repro/launch/variants.py`` does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.models import common as jcommon
from repro.models import registry as jregistry
from repro.nn import attention as jattn
from repro.serving import engine as jengine
from repro_torch.core import config as tconfig
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.models.common import CACHE_BATCH_AXIS, params_from_jax
from repro_torch.nn import attention as tattn
from repro_torch.nn.param import tree_leaves, tree_map
from repro_torch.serving.engine import Request, ServingEngine


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bits(x):
    """The raw bits of an int8 or fp16 array, torch or JAX."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16 if x.dtype == torch.float16
                      else x.dtype).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == np.float16 else a


def _kv(seed, shape, zero_rows=()):
    """A bf16-representable fp32 k/v whose listed (b, s) rows are zero."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x *= np.exp(np.random.default_rng(seed + 1).uniform(
        -3, 3, shape[:-1] + (1,))).astype(np.float32)
    for b, s in zero_rows:
        x[b, s] = 0.0
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_jax_bit_for_bit(dtype):
    """int8 values and fp16 scales equal JAX's bit for bit, all-zero rows
    (the 1e-8 floor, 0 in fp16) and rows of one tiny value included."""
    x = _kv(0, (2, 9, 3, 16), zero_rows=[(0, 0), (1, 4)])
    x[1, 2, 1] = 0.0
    x[1, 2, 1, 3] = 1e-9  # a scale below fp16's range: x / 0 clips
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tq, ts = tattn.quantize_kv(tx)
    jq, js = jattn.quantize_kv(jx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    assert np.array_equal(_bits(tq), _bits(jq))
    assert np.array_equal(_bits(ts), _bits(js))
    assert int(tq[1, 2, 1, 3]) == 127 and not tq[0, 0].any()


def test_quantize_ties_round_half_to_even():
    """x / scale exactly at k + 1/2 rounds to the even neighbour, as
    ``jnp.round``: the row's max 127 gives scale 1."""
    row = np.array([127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 0.0], np.float32)
    x = row.reshape(1, 1, 1, 8)
    tq, _ = tattn.quantize_kv(torch.from_numpy(x))
    jq, _ = jattn.quantize_kv(jnp.asarray(x))
    assert tq.flatten().tolist() == [127, 2, 4, -2, 0, 0, 2, 0]
    assert np.array_equal(tq.numpy(), np.asarray(jq))


def test_dequantize_kv_matches_jax():
    x = _kv(2, (2, 5, 2, 8))
    tq, ts = tattn.quantize_kv(torch.from_numpy(x))
    jq, js = jattn.quantize_kv(jnp.asarray(x))
    td = tattn.dequantize_kv(tq, ts)
    jd = jattn.dequantize_kv(jq, js)
    assert td.dtype == torch.bfloat16
    assert np.array_equal(_f32(td), _f32(jd))
    # the error bound the scale's rounding before the division gives
    err = np.abs(_f32(td) - x) - np.abs(x) * 2.0 ** -8
    assert (err <= _f32(ts)[..., None] / 2 + 1e-12).all()


@pytest.mark.parametrize("cap", [0.0, 5.0])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_quant_matches_jax(window, group, cap):
    """Window 0 on a 32-slot cache in blocks of 8 (four online-softmax
    steps) and a ring of 16 slots with positions past S, GQA and the
    softcap: within 1e-5 of JAX (fp32 sums in another order)."""
    b, kvh, hd = 3, 2, 16
    S = 16 if window else 32
    rng = np.random.default_rng(window + group)
    q = rng.standard_normal((b, 1, kvh * group, hd)).astype(np.float32)
    kc, vc = _kv(5, (b, S, kvh, hd)), _kv(7, (b, S, kvh, hd))
    pos = np.array([3, 17, 40] if window else [0, 9, 31], np.int32)
    kq, ks = jattn.quantize_kv(jnp.asarray(kc))
    vq, vs = jattn.quantize_kv(jnp.asarray(vc))
    kw = dict(window=window, attn_softcap=cap, block=8)
    ref = jattn.decode_attention_quant(jnp.asarray(q), kq, ks, vq, vs,
                                       jnp.asarray(pos), **kw)
    t = [torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)]
    ours = tattn.decode_attention_quant(torch.from_numpy(q), *t,
                                        torch.from_numpy(pos), **kw)
    assert ours.dtype == torch.float32 and ours.shape == (b, 1, kvh * group,
                                                         hd)
    assert np.abs(_f32(ours) - _f32(ref)).max() <= 1e-5


@pytest.mark.parametrize("window", [0, 6])
def test_cache_update_quant_matches_jax(window):
    b, S, kvh, hd = 3, 6, 2, 8
    rng = np.random.default_rng(window)
    cache_np = {"k": rng.integers(-127, 128, (b, S, kvh, hd)).astype(np.int8),
                "v": rng.integers(-127, 128, (b, S, kvh, hd)).astype(np.int8),
                "k_scale": rng.random((b, S, kvh)).astype(np.float16),
                "v_scale": rng.random((b, S, kvh)).astype(np.float16)}
    kn, vn = _kv(3, (b, 1, kvh, hd)), _kv(4, (b, 1, kvh, hd))
    pos = np.array([0, 5, 13], np.int32) if window else np.array([0, 2, 5])
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache_np.items()}
    out = tattn.cache_update_quant(tcache, torch.from_numpy(kn),
                                   torch.from_numpy(vn),
                                   torch.from_numpy(pos), window)
    assert out is tcache
    jc = jattn.cache_update_quant({k: jnp.asarray(v) for k, v in
                                   cache_np.items()}, jnp.asarray(kn),
                                  jnp.asarray(vn), jnp.asarray(pos), window)
    for name in cache_np:
        assert np.array_equal(_bits(tcache[name]), _bits(jc[name])), name


def _cfgs(arch="gemma2-2b"):
    j = dataclasses.replace(jconfig.get_arch(arch).reduced(), kv_quant=True,
                            dtype="float32", param_dtype="float32")
    t = dataclasses.replace(tconfig.get_arch(arch).reduced(), kv_quant=True,
                            dtype="float32", param_dtype="float32")
    return j, t


@pytest.mark.parametrize("stacked", [0, 3])
def test_kv_cache_param_matches_jax(stacked):
    jc, tc = _cfgs()
    j = jcommon.kv_cache_param(jc, 2, 40, stacked=stacked)
    t = tcommon.kv_cache_param(tc, 2, 40, stacked=stacked)
    assert sorted(t) == sorted(j) == ["k", "k_scale", "v", "v_scale"]
    for name in t:
        assert tuple(t[name]) == tuple(j[name]), name
    if stacked:
        assert all(p.shape[CACHE_BATCH_AXIS] == 2 for p in t.values())


_MODELS = {}


def _models():
    if not _MODELS:
        jcfg, tcfg = _cfgs()
        jm = jregistry.get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tregistry.get_model(tcfg)
        tm.load_tree(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg, device="cpu"))
        _MODELS["m"] = (jm, jp, tm)
    return _MODELS["m"]


def test_prefill_quant_write_and_decode_match_jax():
    """An 80-token prompt into a 96-row cache: the local layers' 64-slot
    ring takes the last 64 tokens rolled by 16, the global layers every
    token, each quantized; int8 values and fp16 scales equal JAX's but
    where a k or v differs in its last fp32 bits (at most one step of
    the int8 value or one fp16 ulp of the scale), then one decode step."""
    jm, jp, tm = _models()
    toks = np.random.default_rng(3).integers(0, tm.cfg.vocab_size, (2, 80))
    jc = jm.init_cache(2, 96)
    jl, jc, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                           mode="prefill", cache=jc)
    tc = tm.init_cache(2, 96)
    kvh, hd = tm.cfg.num_kv_heads, tm.cfg.head_dim
    assert tc["local"]["k"].shape == (tm.n_scan, 2, 64, kvh, hd)
    assert tc["local"]["k_scale"].dtype == torch.float16
    with torch.no_grad():
        tl, tc, _ = tm({"tokens": torch.from_numpy(toks)}, mode="prefill",
                       cache=tc)
    assert np.abs(_f32(tl) - _f32(jl)).max() <= 1e-4 * max(
        1.0, float(np.abs(_f32(jl)).max()))
    flat_t = {f"{u}/{n}": v for u in tc for n, v in tc[u].items()}
    flat_j = {f"{u}/{n}": v for u in jc for n, v in jc[u].items()}
    assert sorted(flat_t) == sorted(flat_j)
    for name, a in flat_t.items():
        a, b = _f32(a), _f32(flat_j[name])
        if name.endswith("scale"):
            assert np.all(np.abs(a - b) <= np.abs(b) * 2.0 ** -10), name
        else:
            assert np.abs(a - b).max() <= 1, name
            assert (a != b).mean() < 0.01, name
    nxt = np.array([[5], [9]])
    pos = np.array([80, 80], np.int32)
    jl2, _ = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
    with torch.no_grad():
        tl2, _ = tm.decode_step(torch.from_numpy(nxt), torch.from_numpy(pos),
                                tc)
    assert np.abs(_f32(tl2) - _f32(jl2)).max() <= 2e-3 * max(
        1.0, float(np.abs(_f32(jl2)).max()))


def test_serving_with_the_int8_cache_matches_jax():
    """More requests than slots on reduced fp32 gemma2 with ``kv_quant``:
    the port's engine gives the JAX engine's greedy token lists, and every
    slot's four cache leaves are zeroed before its prefill."""
    jm, jp, tm = _models()
    rng = np.random.default_rng(5)
    reqs = [Request(rid, rng.integers(0, tm.cfg.vocab_size,
                                      int(rng.integers(3, 20))).tolist(),
                    max_new_tokens=int(rng.integers(2, 9)))
            for rid in range(5)]

    def serve(cls, model, params, **kw):
        eng = cls(model, params, max_batch=2, max_len=64, **kw)
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        return eng, eng.run_until_drained()

    eng, ours = serve(ServingEngine, tm, None, device="cpu")
    _, theirs = serve(jengine.ServingEngine, jm, jp)
    assert sorted(ours) == list(range(5))
    assert ours == theirs
    leaves = tree_leaves(eng.cache)
    assert len(leaves) == 8 and {t.dtype for t in leaves} == {
        torch.int8, torch.float16}
    assert tree_map(lambda t: t.shape[CACHE_BATCH_AXIS], eng.cache) == {
        u: dict.fromkeys(("k", "k_scale", "v", "v_scale"), 2)
        for u in ("global", "local")}

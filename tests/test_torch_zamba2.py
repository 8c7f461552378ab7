"""The port's zamba2 (``repro_torch.models.zamba2``, the ``hybrid`` family)
against the JAX package's, on the CPU: its spec, weights, caches,
prefill and decode, serving and launcher, and the shapes at which it
runs K3 and K10.

The oracle is the JAX package's jnp code (the model, jitted, and its
serving engine); it reaches no Pallas kernel (the shared block runs
``chunked_attention``, the projections ``einsum``).  Weights come from the
JAX init, carried across by ``params_from_jax``, with the Mamba leaves
that the init rules leave at zeros or ones redrawn by
``repro_torch.nn.ssm.ssm_redraw`` and handed back to the JAX side.  Two
depth cuts of zamba2-1.2b's reduced config: ``reduced()`` itself (2
layers, the shared block after each, no tail) and 3 layers with the
shared block every 2 (one group of two, one invocation, a tail of one).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro.nn import attention as jattn
from repro.serving import engine as jengine
from repro_torch.core import config as tconfig
from repro_torch.kernels.attention.ref import flash_attention_ref
from repro_torch.kernels.matmul_fused.ops import k3_path, tma_ok
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as tregistry
from repro_torch.models.common import CACHE_BATCH_AXIS, params_from_jax
from repro_torch.models.zamba2 import Zamba2LM
from repro_torch.nn import attention as tattn
from repro_torch.nn import linear as tlinear
from repro_torch.nn.param import tree_leaves, tree_map
from repro_torch.nn.ssm import SSM_REDRAW, ssm_redraw
from repro_torch.serving.engine import Request, ServingEngine

ARCH = "zamba2-1.2b"
#: the two depth cuts: ``reduced()`` and one with a tail
CUTS = {"reduced": {}, "tail": {"num_layers": 3, "shared_attn_every": 2}}

#: relative to max(1, max|ref|), as tests/test_torch_lm.py.  float32: the
#: same fp32 arithmetic in another order — 1e-4 on the prefill logits and
#: on the fp32 conv rows and SSD states; the shared block's KV cache is
#: bf16 (the JAX default at every param dtype), where a k or v that
#: differs in its last fp32 bits may round to the neighbouring bf16 value
#: (2^-7 of that element), and the decode logits read it: 2e-3.  bfloat16
#: params: the activations are rounded to bf16 some ten times a block, at
#: places the two packages choose differently (silu's sigmoid, the
#: projections' activations, p in the attention) — 2^-4 on the logits and
#: every cache leaf, as tests/test_torch_rwkv.py holds its bf16 states.
TOL = {"float32": {"logits": 1e-4, "state": 1e-4, "kv": 2.0 ** -7,
                   "decode": 2e-3},
       "bfloat16": {"logits": 2.0 ** -4, "state": 2.0 ** -4,
                    "kv": 2.0 ** -4, "decode": 2.0 ** -4}}


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


def _cfgs(cut="reduced", dtype="float32"):
    kw = dict(CUTS[cut], dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(jconfig.get_arch(ARCH).reduced(), **kw),
            dataclasses.replace(tconfig.get_arch(ARCH).reduced(), **kw))


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def _spec_rows(spec, path=""):
    """(path, shape, axes, init, scale, dtype) of every Param of a spec
    tree, keys in sorted order."""
    if isinstance(spec, dict):
        return [r for k in sorted(spec)
                for r in _spec_rows(spec[k], f"{path}/{k}")]
    return [(path, tuple(spec.shape), tuple(spec.axes), spec.init,
             spec.scale, spec.dtype)]


_MODELS = {}


def _models(cut="reduced", dtype="float32"):
    """(JAX model, JAX params, port model, jitted JAX forward, jitted JAX
    decode step) with the same weights: the JAX init carried over by
    ``params_from_jax``, ``ssm_redraw``'s leaves and the layerscale
    redrawn, and the result handed back to the JAX side."""
    key = (cut, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(cut, dtype)
        jm = jregistry.get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               device="cpu")
        gen = torch.Generator().manual_seed(1)
        ssm_redraw(tree, gen)
        # the layerscale is ones at init too: spread it, so that an
        # invocation reading another's scale shows
        tree["layerscale"].copy_(1.0 + 0.5 * torch.randn(
            tree["layerscale"].shape, generator=gen))
        tm = tregistry.get_model(tcfg).load_tree(tree)
        fwd = jax.jit(lambda p, t, c: jm.forward(p, {"tokens": t},
                                                 mode="prefill", cache=c))
        dec = jax.jit(lambda p, t, pos, c: jm.decode_step(p, t, pos, c))
        _MODELS[key] = (jm, tree_map(_to_jax, tree), tm, fwd, dec)
    return _MODELS[key]


# -- the spec, the weights, the cache -------------------------------------------


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_spec_matches_jax(cut):
    """``param_spec`` and ``cache_spec``: JAX's keys, shapes, axes, init
    rules and dtypes; ``mamba_tail`` only with a tail."""
    jcfg, tcfg = _cfgs(cut)
    jm, tm = jregistry.get_model(jcfg), tregistry.get_model(tcfg)
    assert isinstance(tm, Zamba2LM)
    assert _spec_rows(tm.param_spec()) == _spec_rows(jm.param_spec())
    assert _spec_rows(tm.cache_spec(3, 40)) == _spec_rows(
        jm.cache_spec(3, 40))
    assert _spec_rows(tm.cache_spec(3, 40, window=16)) == _spec_rows(
        jm.cache_spec(3, 40, window=16))
    assert ("mamba_tail" in tm.param_spec()) == (cut == "tail")
    assert (tm.n_groups, tm.group, tm.n_tail) == (
        jm.n_groups, jm.group, jm.n_tail)
    assert len(tm.mamba) == tm.n_groups * tm.group
    assert len(tm.mamba_tail) == tm.n_tail
    assert dataclasses.asdict(tm.wide_cfg) == dataclasses.asdict(jm.wide_cfg)


def test_full_width_shape_and_count():
    """zamba2-1.2b at full width: JAX's parameter counts (1,279,542,144),
    36 Mamba blocks in 6 groups and a tail of 2, in_proj 2048 -> 8384,
    the shared block at width 4096 (32 heads over 32 of 128, d_ff 8192),
    and the cache of ``max_batch`` 4, ``max_len`` 8192."""
    cfg, jcfg = tconfig.get_arch(ARCH), jconfig.get_arch(ARCH)
    m = tregistry.get_model(cfg)
    counts = [tregistry.analytic_param_count(cfg, **kw) for kw in (
        {}, {"active_only": True}, {"non_embedding": True})]
    assert counts == [jregistry.analytic_param_count(jcfg, **kw) for kw in (
        {}, {"active_only": True}, {"non_embedding": True})]
    assert counts[0] == cfg.num_params() == 1_279_542_144
    assert (m.n_groups, m.group, m.n_tail) == (6, 6, 2)
    assert len(m.mamba) == 36 and len(m.mamba_tail) == 2
    assert all(p.device.type == "meta" for p in m.parameters())
    assert tuple(m.mamba[0]["ssm"]["in_proj"]["w"].shape) == (2048, 8384)
    wide = m.wide_cfg
    assert (wide.d_model, wide.num_heads, wide.num_kv_heads, wide.head_dim,
            wide.d_ff) == (4096, 32, 32, 128, 8192)
    spec = m.cache_spec(4, 8192)
    assert spec["mamba"]["conv"].shape == (36, 4, 3, 4224)
    assert spec["mamba"]["state"].shape == (36, 4, 64, 64, 64)
    assert spec["mamba_tail"]["state"].shape == (2, 4, 64, 64, 64)
    assert spec["shared_kv"]["k"].shape == (6, 4, 8192, 32, 128)
    assert CACHE_BATCH_AXIS == 1


def test_params_from_jax_is_bit_exact():
    """bf16 projections and the fp32 A_log, D, dt_bias, conv_b, norm
    scales and layerscale cross bit for bit, per layer and in the tail."""
    jcfg, tcfg = _cfgs("tail", "bfloat16")
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
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        assert tree["mamba"]["ssm"][name].dtype == torch.float32
    assert tree["layerscale"].dtype == torch.float32
    tm = tregistry.get_model(tcfg).load_tree(tree)
    assert np.array_equal(
        np.asarray(jp["mamba"]["ssm"]["in_proj"]["w"][1]).view(np.uint16),
        tm.mamba[1]["ssm"]["in_proj"]["w"].view(torch.int16).numpy()
        .view(np.uint16))
    assert tm.mamba_tail[0]["ssm"]["A_log"].data_ptr() == \
        tree["mamba_tail"]["ssm"]["A_log"].data_ptr()
    with pytest.raises(ValueError, match="keys"):
        tregistry.get_model(tcfg).load_tree(
            {k: v for k, v in tree.items() if k != "mamba_tail"})


def test_redraw_reaches_every_mamba_unit():
    """``ssm_redraw`` redraws its leaves in the stacked units and the tail,
    and the JAX side reads the same values."""
    jm, jp, tm, _, _ = _models("tail")
    for units, stack in ((tm.mamba, "mamba"), (tm.mamba_tail, "mamba_tail")):
        for i, unit in enumerate(units):
            for name in SSM_REDRAW:
                t = unit["ssm"][name]
                assert t.std() > 0, (stack, i, name)
                assert np.array_equal(np.asarray(jp[stack]["ssm"][name][i]),
                                      t.numpy())
    a = tm.mamba[0]["ssm"]["A_log"]
    assert not torch.equal(a, tm.mamba[1]["ssm"]["A_log"])


@pytest.mark.parametrize("cut", sorted(CUTS))
def test_init_cache_matches_jax(cut):
    """Every leaf of the port's cache has JAX's shape and dtype: fp32
    Mamba conv rows and SSD states, a bf16 shared KV cache; all zero."""
    jm, _, tm, _, _ = _models(cut)
    jc = jm.init_cache(2, 16)
    tc = tm.init_cache(2, 16)
    jl, tl = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
    assert len(jl) == len(tl) == 4 + 2 * (cut == "tail")
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert not b.any()
    assert tc["mamba"]["state"].dtype == torch.float32
    assert tc["mamba"]["conv"].dtype == torch.float32
    assert tc["shared_kv"]["k"].dtype == torch.bfloat16


# -- prefill and decode ------------------------------------------------------------


def _check_cache(ours, theirs, tol):
    """Every leaf against JAX's: the KV cache to ``tol["kv"]``, the Mamba
    conv rows and states to ``tol["state"]``."""
    theirs = jax.tree_util.tree_leaves(theirs)
    kinds = ["kv" if k == "shared_kv" else "state"
             for k in sorted(ours) for _ in tree_leaves(ours[k])]
    assert len(kinds) == len(theirs)
    for kind, a, b in zip(kinds, tree_leaves(ours), theirs):
        _close(a, b, tol[kind])


@pytest.mark.parametrize("cut,dtype", [("reduced", "float32"),
                                       ("reduced", "bfloat16"),
                                       ("tail", "float32")])
def test_prefill_and_decode_match_jax(cut, dtype):
    """Prompts of 45 tokens (chunks of 32, the second padded) prefilled
    into a cache: the logits at every position, the conv rows, SSD states
    and KV cache written; then three ``decode_step``s."""
    jm, jp, tm, fwd, dec = _models(cut, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(10)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 45))
    jl, jc, _ = fwd(jp, jnp.asarray(toks), jm.init_cache(2, 64))
    tc = tm.init_cache(2, 64)
    with torch.no_grad():
        tl, tc2, aux = tm({"tokens": torch.from_numpy(toks)}, mode="prefill",
                          cache=tc)
    assert tc2 is tc and tl.dtype == torch.float32
    assert tl.shape == (2, 45, 512)
    assert set(aux) == {"load_balance_loss", "router_z_loss"}
    assert all(float(v) == 0.0 for v in aux.values())
    _close(tl, jl, tol["logits"])
    _check_cache(tc, jc, tol)
    pos = np.array([45, 45], np.int32)
    for _ in range(3):
        nxt = rng.integers(0, tm.cfg.vocab_size, (2, 1))
        jl, jc = dec(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.from_numpy(nxt),
                                    torch.from_numpy(pos), tc)
        assert tl.shape == (2, 1, 512)
        _close(tl, jl, tol["decode"])
        _check_cache(tc, jc, tol)
        pos = pos + 1


def test_forward_without_cache_matches_jax():
    """``forward`` without a cache: the logits and zero aux, whatever the
    mode (the body always runs in full)."""
    jm, jp, tm, _, _ = _models()
    toks = np.random.default_rng(11).integers(0, 512, (1, 33))
    jl, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        for mode in ("train", "prefill"):
            tl, aux = tm({"tokens": torch.from_numpy(toks)}, mode=mode)
            _close(tl, jl, TOL["float32"]["logits"])


def test_smoke_memory_budget_of_zamba2():
    """The phase-10 budget from the full-width model on the meta device:
    2.56 GB of weights (bf16; A_log, D, dt_bias, conv_b, the norm scales
    and the layerscale fp32), the bf16 KV cache of its 6 shared-block
    invocations and the fp32 conv rows and SSD states of its 38 Mamba
    blocks at 4 slots of 8192 rows, the fp32 logits of 4500 tokens."""
    import importlib.util
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    model = tregistry.get_model(tconfig.get_arch(ARCH))
    budget = smoke.memory_budget(model)
    fp32 = sum(p.numel() for p in model.parameters()
               if p.dtype == torch.float32)
    assert fp32 == 38 * (4224 + 3 * 64 + 2048 + 4096) + 6 * 2048 + 2048 \
        + 2 * 4096
    assert budget["weights"] == (2 * (1_279_542_144 - fp32)
                                 + 4 * fp32) / 1e9
    assert budget["kv_cache"] == 2 * 2 * 6 * 4 * 8192 * 32 * 128 / 1e9
    assert budget["state_cache"] == 4 * 38 * 4 * (3 * 4224
                                                  + 64 * 64 * 64) / 1e9
    assert budget["logits"] == 4 * 4500 * 32000 / 1e9


def test_projections_and_attention_per_step(monkeypatch):
    """What the smoke's phase 10 counts on the card, on the CPU: a prefill
    calls K3's wrapper twice a Mamba block and eight times a shared-block
    invocation (q, k, v, o, gate, up, down, shared_out) and K10's once an
    invocation; a decode step calls K3's as often and K10's never."""
    _, _, tm, _, _ = _models("tail")
    calls = {"K3": 0, "K10": 0}

    def counted(kid, fn):
        def call(*args, **kw):
            calls[kid] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(tlinear, "matmul_fused",
                        counted("K3", tlinear.matmul_fused))
    monkeypatch.setattr(tattn, "flash_attention",
                        counted("K10", tattn.flash_attention))
    cfg = tm.cfg
    k3 = 2 * cfg.num_layers + 8 * tm.n_groups
    cache = tm.init_cache(1, 32)
    with torch.no_grad():
        tm({"tokens": torch.arange(5)[None]}, mode="prefill", cache=cache)
        assert calls == {"K3": k3, "K10": tm.n_groups}
        tm.decode_step(torch.tensor([[3]]), torch.tensor([5]), cache)
    assert calls == {"K3": 2 * k3, "K10": tm.n_groups}
    full = tregistry.get_model(tconfig.get_arch(ARCH))
    assert 2 * 38 + 8 * full.n_groups == 124


# -- serving and the launcher --------------------------------------------------


def _serve(engine_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, max_batch=2, max_len=64, **kw)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    return eng.run_until_drained()


def test_serving_matches_jax_greedy():
    """The tail config in fp32, three requests on two slots (the third
    reuses a slot whose SSD state and conv rows decoded filler tokens
    while idle), among them a 2-token prompt (fewer than the conv's 3
    rows of history) and one of 40 (two chunks): the port's engine gives
    the JAX engine's token lists."""
    jm, jp, tm, _, _ = _models("tail")
    rng = np.random.default_rng(13)
    reqs = [Request(rid, rng.integers(0, 512, n).tolist(), max_new_tokens=m)
            for rid, (n, m) in enumerate(((40, 3), (2, 6), (40, 4)))]
    ours = _serve(ServingEngine, tm, None, reqs, device="cpu")
    # the JAX engine over the JAX model with its forward jitted (one
    # compile a prompt length instead of eager scans; the engine jits the
    # decode step itself)
    jitted = types.SimpleNamespace(
        forward=jax.jit(jm.forward,
                        static_argnames=("mode", "window_override")),
        decode_step=jm.decode_step, init_cache=jm.init_cache)
    theirs = _serve(jengine.ServingEngine, jitted, jp, reqs)
    assert sorted(ours) == [0, 1, 2]
    assert ours == theirs


def test_prefill_resets_only_its_slot():
    """A prefill zeroes its slot's conv rows, states and k/v before
    writing the prompt's, and leaves the other slots' as they were."""
    _, _, tm, _, _ = _models("tail")
    eng = ServingEngine(tm, max_batch=3, max_len=32, device="cpu")
    eng._prefill_into_slot(0, Request(0, [1, 2, 3], max_new_tokens=2))
    first = [t.narrow(CACHE_BATCH_AXIS, 0, 1).clone()
             for t in tree_leaves(eng.cache)]
    eng._prefill_into_slot(1, Request(1, [4, 5, 6, 7], max_new_tokens=2))
    eng._decode_step()
    eng._prefill_into_slot(0, Request(2, [1, 2, 3], max_new_tokens=2))
    for f, t in zip(first, tree_leaves(eng.cache)):
        assert torch.equal(f, t.narrow(CACHE_BATCH_AXIS, 0, 1))
        assert t.narrow(CACHE_BATCH_AXIS, 1, 1).abs().sum() > 0


def test_launcher_serves_on_the_cpu(capsys):
    """``repro_torch.launch.serve.main`` on reduced zamba2 with ``--device
    cpu``: a token list for every request; the launcher still refuses the
    cross-attention families ("text-only", as the JAX launcher), whose
    models ``get_model`` now builds."""
    out = tserve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--max-len", "32"])
    assert sorted(out["done"]) == [0, 1, 2]
    assert all(len(t) == 4 for t in out["done"].values())
    assert f"[serve] {ARCH}: 3 requests, 12 tokens" in \
        capsys.readouterr().out
    for arch in ("llama-3.2-vision-11b", "seamless-m4t-large-v2"):
        with pytest.raises(SystemExit, match="text-only"):
            tserve.main(["--arch", arch, "--device", "cpu"])
        model = tregistry.get_model(tconfig.get_arch(arch))
        assert type(model).__name__ == ("VisionLM" if "vision" in arch
                                        else "EncDecLM")


# -- K3 and K10 at zamba2's shapes -------------------------------------------------


def test_k3_path_at_zamba2_shapes():
    """``in_proj`` (N = 8384 = 65 * 128 + 64, a partial last 128-wide tile)
    takes the wgmma path at a prefill's M and the weight stream at a
    decode step's, as do the other projections."""
    assert 8384 % 128 == 64 and 8384 % 64 == 0
    assert tma_ok(2048, 8384)
    assert k3_path(torch.bfloat16, 4500, 2048, 8384) == "wgmma"
    assert k3_path(torch.bfloat16, 4, 2048, 8384) == "stream"
    for kk, n in ((4096, 2048), (4096, 4096), (4096, 8192), (8192, 4096)):
        assert k3_path(torch.bfloat16, 1500, kk, n) == "wgmma"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k10_plain_at_one_query_head_a_kv_head(dtype):
    """K10's plain version with h == kvh (zamba2's 32 over 32; here 4 over
    4, head_dim 128, 40 tokens) against JAX's ``chunked_attention``."""
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal((1, 40, 4, 128)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = (jnp.asarray(a, dtype) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype))
                  for a in (q, k, v))
    ours = flash_attention_ref(tq, tk, tv, causal=True)
    ref = jattn.chunked_attention(jq, jk, jv, causal=True, chunk_q=16,
                                  chunk_kv=16)
    _close(ours, ref, 1e-5 if dtype == "float32" else 2.0 ** -7)

"""starcoder2-15b, qwen1.5-32b and grok-1-314b in the port against the JAX
package, on the CPU, reduced, with the JAX init's weights carried across
by ``params_from_jax``.

Each arch brings a piece the other files' models do not: starcoder2 a
LayerNorm with its bias, q/k/v biases, a plain gelu MLP on K3's bias
epilogue and a sliding window on a ring cache (64 rows reduced, which
the 80-token prompt runs past); qwen1.5 q/k/v biases with as many kv
heads as heads (reduced: 2 of 4; at full width 40 of 40); grok the
attention and logit softcaps and 8 gelu experts (reduced: 4), top 2.
internlm2 is held in ``tests/test_torch_lm.py`` and grok's routing in
``tests/test_torch_moe.py``.  The JAX side runs its jnp paths
(``use_pallas=False``), never Pallas (ROADMAP.md §3, R1); the
tolerances are ``tests/test_torch_lm.py``'s ``TOL``.

In bf16 the two packages round grok's activations at different places,
so a token whose k-th and (k+1)-th router probabilities lie closer than
``NEAR_TIE`` may take other experts on the two sides, and its hidden
state then differs by O(1).  Both sides' routing is recorded layer by
layer; such a token's logits and cache rows are left out of the
comparison, every other one is held to ``TOL``, and a token chosen
apart must be a near tie (in fp32, none may part).
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
from repro.serving import engine as jengine
from repro_torch.core import config as tconfig
from repro_torch.models import common as tcommon
from repro_torch.models import registry as tregistry
from repro_torch.models.common import params_from_jax
from repro_torch.nn.param import tree_leaves
from repro_torch.serving.engine import Request, ServingEngine
from test_torch_lm import TOL, _close

ARCHS = ["starcoder2-15b", "qwen1.5-32b", "grok-1-314b"]
#: the prefill's prompt and the cache's rows: past starcoder2's reduced
#: window of 64
PROMPT, CACHE = 80, 96
#: router probabilities closer than this (about one bf16 rounding of the
#: router's input) may rank apart on the two sides in bf16
NEAR_TIE = 2.0 ** -8
#: the most tokens of a prompt whose experts the two sides may choose
#: apart in bf16
MOST_PARTED = 1 / 16

_MODELS = {}


def _models(arch, dtype="float32"):
    """(JAX model, JAX params, port model) with the same weights."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg, tcfg = (dataclasses.replace(m.get_arch(arch).reduced(),
                                          dtype=dtype, param_dtype=dtype)
                      for m in (jconfig, tconfig))
        jm = jregistry.get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tregistry.get_model(tcfg)
        tm.load_tree(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg, device="cpu"))
        _MODELS[key] = (jm, jp, tm)
    return _MODELS[key]


def _record_routing(monkeypatch, k):
    """Both packages' MoE blocks wrapped so that each call appends its
    tokens' chosen experts (sorted) in flat token order: JAX's from its
    scan through ``jax.debug.callback``; the port's with each token's
    margin between its k-th and (k+1)-th router probability.  Returns
    the two logs."""
    jlog, tlog = [], []
    jreal, treal = jcommon.moe_apply, tcommon.moe_apply

    def jax_side(params, x, cfg, **kw):
        lg = jnp.einsum("td,de->te",
                        x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                        params["router"].astype(jnp.float32))
        _, e = jax.lax.top_k(jax.nn.softmax(lg, axis=-1), k)
        jax.debug.callback(
            lambda e: jlog.append(np.sort(np.asarray(e), -1)), e,
            ordered=True)
        return jreal(params, x, cfg, **kw)

    def port_side(params, x, cfg, **kw):
        top = torch.topk(torch.softmax(
            x.reshape(-1, x.shape[-1]).float() @ params["router"].float(),
            dim=-1), k + 1, dim=-1)
        tlog.append((np.sort(top.indices[:, :k].numpy(), -1),
                     (top.values[:, k - 1] - top.values[:, k]).numpy()))
        return treal(params, x, cfg, **kw)

    monkeypatch.setattr(jcommon, "moe_apply", jax_side)
    monkeypatch.setattr(tcommon, "moe_apply", port_side)
    return jlog, tlog


def _parted(jlog, tlog, tokens, dtype):
    """The tokens (flat order) whose experts the two sides chose apart in
    any layer of the calls logged, the logs then emptied: each a near
    tie in bf16, at most ``MOST_PARTED`` of them; none in fp32."""
    assert len(jlog) == len(tlog)
    parted = np.zeros(tokens, bool)
    for je, (te, margin) in zip(jlog, tlog):
        apart = (je != te).any(-1)
        assert not apart.any() or dtype == "bfloat16", np.nonzero(apart)
        assert (margin[apart] < NEAR_TIE).all(), margin[apart]
        parted |= apart
    assert parted.sum() <= MOST_PARTED * tokens
    jlog.clear()
    tlog.clear()
    return parted


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype, monkeypatch):
    """Prefill logits at every position of an 80-token prompt and the
    caches written, then one ``decode_step`` per request: for starcoder2
    past its 64-row ring, whose cache keeps the last 64 rows.  grok's
    tokens routed apart (bf16 near ties) are left out."""
    jm, jp, tm = _models(arch, dtype)
    cfg, tol = tm.cfg, TOL[dtype]
    logs = (_record_routing(monkeypatch, cfg.moe.num_experts_per_token)
            if cfg.moe else None)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, PROMPT))
    jc = jm.init_cache(2, CACHE)
    jl, jc, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                           mode="prefill", cache=jc)
    tc = tm.init_cache(2, CACHE)
    rows = [t.shape[2] for t in tree_leaves(tc)]
    assert rows == [cfg.sliding_window if cfg.sliding_window else CACHE
                    ] * len(rows)
    if cfg.sliding_window:
        assert cfg.sliding_window < PROMPT
    with torch.no_grad():
        tl, tc, _ = tm({"tokens": torch.from_numpy(toks)}, mode="prefill",
                       cache=tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, PROMPT,
                                                      cfg.padded_vocab)
    kept = np.ones((2, PROMPT), bool)
    if logs:
        kept = ~_parted(*logs, 2 * PROMPT, dtype).reshape(2, PROMPT)
    _close(tl[torch.from_numpy(kept)], np.asarray(jl, np.float32)[kept],
           tol["logits"])
    # a cache row holds the k/v of the position it is the ring's row for
    rows = tree_leaves(tc)[0].shape[2]
    row_kept = np.ones((2, rows), bool)
    for b, t in zip(*np.nonzero(~kept)):
        row_kept[b, t % rows] = False

    def caches_close():
        for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
            assert a.dtype == torch.bfloat16
            _close(a[:, torch.from_numpy(row_kept)],
                   np.asarray(b, np.float32)[:, row_kept], tol["cache"])

    caches_close()
    nxt = rng.integers(0, cfg.vocab_size, (2, 1))
    pos = np.array([PROMPT, PROMPT + 3], np.int32)
    jl2, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
    with torch.no_grad():
        tl2, tc = tm.decode_step(torch.from_numpy(nxt),
                                 torch.from_numpy(pos), tc)
    step_kept = ~_parted(*logs, 2, dtype) if logs else np.ones(2, bool)
    _close(tl2[torch.from_numpy(step_kept)],
           np.asarray(jl2, np.float32)[step_kept], tol["decode"])
    for b in np.nonzero(~step_kept)[0]:
        row_kept[b, pos[b] % rows] = False
    caches_close()


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax_greedy(arch):
    """Four requests on two slots, float32 params, one prompt of 70
    tokens (past starcoder2's window): the port's ``ServingEngine`` gives
    the JAX engine's greedy tokens."""
    jm, jp, tm = _models(arch)
    rng = np.random.default_rng(12)
    reqs = [Request(rid, rng.integers(0, tm.cfg.vocab_size, n).tolist(),
                    max_new_tokens=m)
            for rid, (n, m) in enumerate(((5, 4), (70, 6), (17, 3),
                                          (9, 5)))]
    done = []
    for eng in (ServingEngine(tm, max_batch=2, max_len=CACHE, device="cpu"),
                jengine.ServingEngine(jm, jp, max_batch=2, max_len=CACHE)):
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        done.append(eng.run_until_drained())
    assert sorted(done[0]) == [0, 1, 2, 3]
    assert [len(done[0][r.rid]) for r in reqs] == [r.max_new_tokens
                                                  for r in reqs]
    assert done[0] == done[1]


@pytest.mark.parametrize("arch", ARCHS + ["internlm2-20b"])
def test_full_width_cache_spec_matches_jax(arch):
    """At full width, 4 slots of 8192 rows (the smoke's phase 15c): the
    port's cache spec is JAX's leaf for leaf — starcoder2's ring of 4096
    rows, qwen1.5's 40 kv heads — with nothing allocated (meta)."""
    jm = jregistry.get_model(jconfig.get_arch(arch))
    tm = tregistry.get_model(tconfig.get_arch(arch))
    ours = tree_leaves(tm.cache_spec(4, 8192))
    theirs = jax.tree_util.tree_leaves(
        jm.cache_spec(4, 8192), is_leaf=lambda p: hasattr(p, "shape"))
    assert [(tuple(p.shape), str(p.dtype)) for p in ours] == [
        (tuple(p.shape), str(jnp.dtype(p.dtype))) for p in theirs]
    cfg = tm.cfg
    rows = min(8192, cfg.sliding_window) if cfg.sliding_window else 8192
    assert all(p.shape[2:] == (rows, cfg.num_kv_heads, cfg.head_dim)
               for p in ours)


# -- the smoke's phase 15 ---------------------------------------------------------


def _smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _served(smoke, arch):
    """The full-width model phase 15c serves, cut as ``DENSE_CUTS`` says,
    on the meta device."""
    cfg = tconfig.get_arch(arch)
    layers = smoke.DENSE_CUTS.get(arch, (cfg.num_layers,))[0]
    return tregistry.get_model(dataclasses.replace(cfg, num_layers=layers))


#: phase 15c at 4 slots of 8192 rows: GB of weights and of bf16 cache
#: (starcoder2's a ring of its 4096-row window), and the bounds in ms
#: (3.35 TB/s, 989 TFLOP/s): a decode step's weight read, a 4500-token
#: prefill's projections
DENSE_BUDGET = {"starcoder2-15b": (31.9, 1.34, 9.5, 140),
                "internlm2-20b": (39.7, 6.4, 11.9, 170),
                "qwen1.5-32b": (36.7, 21.5, 11.0, 153),
                "grok-1-314b": (42.6, 0.5, 12.7, 47)}


@pytest.mark.parametrize("arch", list(DENSE_BUDGET))
def test_smoke_budget_and_bounds_of_the_served_models(arch):
    """What phase 15c serves fits one 80-GB card with room: weights, cache
    and the 4500-token prompt's fp32 logits, with the depth cuts only
    for qwen1.5 (32 of 64 layers) and grok (4 of 64); its bounds are the
    weights' read and the projections' operations (grok's experts at 2
    of 8; at the prefill's capacity, 2250 rows an expert, about twice)."""
    smoke = _smoke()
    assert set(smoke.DENSE_CUTS) == {"qwen1.5-32b", "grok-1-314b"}
    model = _served(smoke, arch)
    weights, cache, decode_ms, prefill_ms = DENSE_BUDGET[arch]
    budget = smoke.memory_budget(model)
    assert budget["weights"] == pytest.approx(weights, rel=0.01)
    assert budget["kv_cache"] == pytest.approx(cache, rel=0.1)
    assert sum(budget.values()) < 70.0
    bounds = smoke.dense_bounds(model, smoke.card_peaks(
        "NVIDIA H100 80GB HBM3"))
    assert bounds["decode_weight_read"] == pytest.approx(decode_ms, rel=0.01)
    assert bounds["prefill_projections"] == pytest.approx(prefill_ms,
                                                          rel=0.05)
    if model.cfg.moe:
        assert bounds["prefill_at_capacity"] == pytest.approx(94, rel=0.05)


@pytest.mark.parametrize("arch", list(DENSE_BUDGET))
def test_smoke_k3_shapes_and_launches(arch, monkeypatch):
    """Phase 15's K3 shapes are the full-width block's projections (K, N,
    bias) and the counts 15c holds each prefill and decode step to are
    the model's: ``K3_DENSE_PER_LAYER`` K3 calls a layer in both, K10
    once a layer in a prefill and never in a decode step (reduced, on the
    CPU, through counting stand-ins of the wrappers)."""
    from repro_torch.nn import attention as tattn
    from repro_torch.nn import linear as tlinear
    from repro_torch.nn.param import Param

    smoke = _smoke()
    spec = _served(smoke, arch).param_spec()["layers"]
    linears = set()

    def walk(t):
        for v in t.values():
            if isinstance(v, dict) and isinstance(v.get("w"), Param):
                linears.add((*v["w"].shape[-2:], "b" in v))
            elif isinstance(v, dict):
                walk(v)

    walk(spec)
    assert linears == {(k, n, bias) for k, n, _, bias
                       in smoke.K3_DENSE_SHAPES[arch]}
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
    _, _, tm = _models(arch)
    n = tm.cfg.num_layers
    cache = tm.init_cache(1, 32)
    with torch.no_grad():
        tm({"tokens": torch.arange(5)[None]}, mode="prefill", cache=cache)
        assert calls == {"K3": smoke.K3_DENSE_PER_LAYER[arch] * n, "K10": n}
        tm.decode_step(torch.tensor([[3]]), torch.tensor([5]), cache)
    assert calls == {"K3": 2 * smoke.K3_DENSE_PER_LAYER[arch] * n, "K10": n}

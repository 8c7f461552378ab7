"""The port's llama-3.2-vision decoder (``repro_torch.models.vision_lm``,
the ``vlm`` family) against the JAX package's, on the CPU: its spec,
weights, caches, forward, prefill and decode, the redraw that makes the
cross path show, and the calls it makes to K3 and K10.

The oracle is the JAX package's jnp code (the model, jitted); it reaches
no Pallas kernel.  Weights come from the JAX init, carried across by
``params_from_jax`` and passed through ``vision_redraw`` (the gates drawn
away from 0, the doubly stacked self matrices at std 1/sqrt(d_in)), then
handed back to the JAX side.  The reduced config: one group of one self
layer and one cross layer, 16 media tokens of width 256.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro_torch.core import config as tconfig
from repro_torch.models import registry as tregistry
from repro_torch.models.common import CACHE_BATCH_AXIS, params_from_jax
from repro_torch.models.vision_lm import GATE_REDRAW, VisionLM, vision_redraw
from repro_torch.nn import attention as tattn
from repro_torch.nn import linear as tlinear
from repro_torch.nn.param import init_tree, tree_leaves, tree_map
from torch_cross_common import (VLM, both, cfgs, close, media, models,
                                prefill_and_decode, spec_rows)


def _cut(layers, interval):
    """The reduced config in both packages with ``layers`` layers, a
    cross layer every ``interval``."""
    return tuple(dataclasses.replace(c, cross_attn=dataclasses.replace(
        c.cross_attn, interval=interval))
        for c in cfgs(VLM, num_layers=layers))


def _jax_cache_as_ports(jc, n_groups, n_self):
    """JAX's cache (self [n_groups, n_self, b, ...]) in the port's layout
    (self [n_groups * n_self, b, ...]), leaves in the port's order."""
    out = []
    for k in ("cross", "self"):
        for n in ("k", "v"):
            a = np.asarray(jc[k][n], np.float32)
            if k == "self":
                a = a.reshape((n_groups * n_self,) + a.shape[2:])
            out.append(a)
    return out


def _check_cache(ours, theirs, tol, model):
    theirs = _jax_cache_as_ports(theirs, model.n_groups, model.n_self)
    leaves = tree_leaves(ours)
    assert len(leaves) == len(theirs) == 4
    for a, b in zip(leaves, theirs):
        assert a.dtype == torch.bfloat16
        close(a, b, tol)


# -- the spec, the weights, the cache -------------------------------------------


@pytest.mark.parametrize("layers,interval", [(2, 2), (6, 3)])
def test_spec_matches_jax(layers, interval):
    """``param_spec``: JAX's keys, shapes, axes, init rules and dtypes
    (self layers stacked twice, the cross layers' fp32 gates, the
    projector's fp32 bias); ``cache_spec``: JAX's leaves with the self
    cache's group axes merged."""
    jcfg, tcfg = _cut(layers, interval)
    jm, tm = jregistry.get_model(jcfg), tregistry.get_model(tcfg)
    assert isinstance(tm, VisionLM)
    assert (tm.n_groups, tm.n_self) == (jm.n_groups, jm.n_self)
    assert spec_rows(tm.param_spec()) == spec_rows(jm.param_spec())
    assert len(tm.self_layers) == tm.n_groups * tm.n_self
    assert len(tm.cross_layers) == tm.n_groups
    for window in (0, 16):
        jrows = spec_rows(jm.cache_spec(3, 40, window))
        trows = spec_rows(tm.cache_spec(3, 40, window))
        assert len(jrows) == len(trows) == 4
        for j, t in zip(jrows, trows):
            path, shape, axes, init, scale, dtype = j
            if path.startswith("/self"):
                shape = (shape[0] * shape[1],) + shape[2:]
                axes = axes[:1] + axes[2:]
            assert (path, shape, axes, init, scale, dtype) == t
            assert t[1][CACHE_BATCH_AXIS] == 3


def test_full_width_shape_and_count():
    """llama-3.2-vision-11b at full width: JAX's parameter counts
    (9,791,938,576; 8,741,265,424 without the embedding), 8 groups of 4
    self layers and a cross layer, the projector 4096 -> 4096 with a bias,
    and the caches of 4 slots of 8192 rows."""
    cfg, jcfg = tconfig.get_arch(VLM), jconfig.get_arch(VLM)
    counts = [tregistry.analytic_param_count(cfg, **kw) for kw in (
        {}, {"active_only": True}, {"non_embedding": True})]
    assert counts == [jregistry.analytic_param_count(jcfg, **kw) for kw in (
        {}, {"active_only": True}, {"non_embedding": True})]
    assert counts == [9_791_938_576, 9_791_938_576, 8_741_265_424]
    assert (cfg.num_params(), cfg.active_params()) == tuple(counts[:2])
    m = tregistry.get_model(cfg)
    assert (m.n_groups, m.n_self) == (8, 4)
    assert all(p.device.type == "meta" for p in m.parameters())
    assert tuple(m.projector["w"].shape) == (4096, 4096)
    assert m.projector["b"].dtype == torch.float32
    spec = m.param_spec()
    assert spec["layers"]["self"]["mlp"]["w_gate"]["w"].shape == (
        8, 4, 4096, 14336)
    cache = m.cache_spec(4, 8192)
    assert cache["self"]["k"].shape == (32, 4, 8192, 8, 128)
    assert cache["cross"]["k"].shape == (8, 4, 6400, 8, 128)
    assert cache["cross"]["v"].dtype == "bfloat16"


def test_params_from_jax_is_bit_exact():
    """bf16 matrices and the fp32 gates, norm scales and projector bias
    cross bit for bit; self layer (g, j) reads entry [g][j] of the doubly
    stacked leaves."""
    jcfg, tcfg = cfgs(VLM, "bfloat16", num_layers=4)
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
    assert (tm.n_groups, tm.n_self) == (2, 1)
    wq = np.asarray(jp["layers"]["self"]["attn"]["wq"]["w"])
    for g in range(2):
        assert np.array_equal(
            wq[g, 0].view(np.uint16),
            tm.self_layers[g]["attn"]["wq"]["w"].view(torch.int16).numpy()
            .view(np.uint16))
        assert tm.cross_layers[g]["gate_attn"].data_ptr() == \
            tree["layers"]["cross"]["gate_attn"][g].data_ptr()
    assert tm.projector["b"].dtype == torch.float32


def test_init_keeps_the_jax_fan_in_of_doubly_stacked_leaves():
    """The port's ``init_tree`` draws the self layers' [n_groups, n_self,
    d_in, d_out] matrices at std 1/sqrt(n_groups), as JAX's fan-in rule
    does (it reads ``shape[0]`` of a leaf that is not 3-D), and the cross
    layers' [n_groups, d_in, d_out] at 1/sqrt(d_in)."""
    _, tcfg = cfgs(VLM, num_layers=4)
    tree = init_tree(tregistry.get_model(tcfg).param_spec(),
                     torch.Generator().manual_seed(0), "float32")
    self_wq = tree["layers"]["self"]["mlp"]["w_up"]["w"]
    cross_wq = tree["layers"]["cross"]["mlp"]["w_up"]["w"]
    assert self_wq.shape == (2, 1, 256, 512)
    assert abs(self_wq.std().item() - 1 / math.sqrt(2)) < 0.01
    assert abs(cross_wq.std().item() - 1 / math.sqrt(256)) < 0.001
    assert not tree["layers"]["cross"]["gate_attn"].any()


def test_redraw_gates_and_self_scale():
    """``vision_redraw``: the gates from N(1, 0.25) (tanh(gate) away from
    0), the self matrices scaled to std 1/sqrt(d_in), every other leaf
    as it was; the JAX side reads the same values."""
    jm, jp, tm, _, _ = models(VLM)
    _, tcfg = cfgs(VLM)
    fresh = params_from_jax(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0))), tcfg, device="cpu")
    gates = torch.cat([u[g] for u in tm.cross_layers
                       for g in ("gate_attn", "gate_mlp")])
    assert (gates.abs() > 0).all() and (torch.tanh(gates).abs() > 0.2).all()
    assert GATE_REDRAW == (1.0, 0.25)
    w = tm.self_layers[0]["attn"]["wq"]["w"]
    ref = fresh["layers"]["self"]["attn"]["wq"]["w"][0, 0]
    assert torch.allclose(w, ref / math.sqrt(256), rtol=1e-6, atol=0)
    assert torch.equal(tm.cross_layers[0]["attn"]["wq"]["w"],
                       fresh["layers"]["cross"]["attn"]["wq"]["w"][0])
    assert torch.equal(tm.self_layers[0]["ln_attn"]["scale"],
                       fresh["layers"]["self"]["ln_attn"]["scale"][0, 0])
    assert np.array_equal(np.asarray(jp["layers"]["cross"]["gate_mlp"]),
                          tm.cross_layers[0]["gate_mlp"][None].numpy())


def test_init_cache_matches_jax():
    """Every cache leaf is bf16 and zero; the self cache is JAX's with the
    group axes merged, the cross cache JAX's [n_groups, b, t, kvh, hd]."""
    jm, _, tm, _, _ = models(VLM)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    theirs = _jax_cache_as_ports(jc, tm.n_groups, tm.n_self)
    for a, b in zip(tree_leaves(tc), theirs):
        assert tuple(a.shape) == b.shape
        assert a.dtype == torch.bfloat16 and not a.any()
    assert tc["cross"]["k"].shape == (1, 2, 16, 2, 64)


# -- forward, prefill and decode ---------------------------------------------------


def test_forward_without_cache_matches_jax():
    """``forward`` without a cache: the logits and zero aux, whatever the
    mode (every layer runs in full)."""
    jm, jp, tm, _, _ = models(VLM)
    toks = np.random.default_rng(11).integers(0, 512, (1, 13))
    tmed, jmed = both(media(tm.cfg, 1, 12), "float32")
    jl, _ = jax.jit(lambda p, t, m: jm.forward(
        p, {"tokens": t, "media_embeds": m}))(jp, jnp.asarray(toks), jmed)
    with torch.no_grad():
        for mode in ("train", "prefill"):
            tl, aux = tm({"tokens": torch.from_numpy(toks),
                          "media_embeds": tmed}, mode=mode)
            close(tl, jl, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A 9-token prompt and its 16 media tokens prefilled into a cache:
    the logits at every position, the self cache and the bf16 cross cache
    written; then three ``decode_step``s against both caches."""
    _, _, tm, _, _ = models(VLM, dtype)
    prefill_and_decode(VLM, dtype,
                       lambda ours, theirs, tol: _check_cache(
                           ours, theirs, tol, tm))


def test_media_moves_the_logits_only_through_the_gates():
    """With the redraw's gates a perturbed media input moves the logits
    (prefill and decode); at JAX's init (gates 0) it moves nothing."""
    rng = np.random.default_rng(14)
    toks = torch.from_numpy(rng.integers(0, 512, (1, 6)))
    out = {}
    for redraw in (True, False):
        tm = models(VLM, redraw=redraw)[2]
        m0 = torch.from_numpy(media(tm.cfg, 1, 15))
        runs = []
        for m in (m0, m0 + 0.5 * torch.randn(m0.shape, generator=torch
                                             .Generator().manual_seed(3))):
            cache = tm.init_cache(1, 16)
            with torch.no_grad():
                lg, _, _ = tm({"tokens": toks, "media_embeds": m},
                              mode="prefill", cache=cache)
                step, _ = tm.decode_step(torch.tensor([[7]]),
                                         torch.tensor([6]), cache)
            runs.append((lg, step))
        out[redraw] = [(a - b).abs().max().item()
                       for a, b in zip(*runs)]
    assert min(out[True]) > 1e-3, out
    assert out[False] == [0.0, 0.0], out


def test_projections_and_attention_per_step(monkeypatch):
    """What the smoke's phase 11 counts on the card, on the CPU: a prefill
    calls K3's wrapper once for the projector and 7 times a layer, K10's
    once a layer (the cross layers non-causal, against the media); a
    decode step calls K3's 7 times a self layer and 5 times a cross layer
    (q, o, gate, up, down), K10's never.  At full width: 281, 40; 264."""
    _, tcfg = _cut(6, 3)
    tm = tregistry.get_model(tcfg).init(torch.Generator().manual_seed(0))
    calls = {"K3": 0, "K10": 0, "causal": 0}

    def counted(kid, fn):
        def call(*args, **kw):
            calls[kid] += 1
            calls["causal"] += kid == "K10" and kw.get("causal", True)
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(tlinear, "matmul_fused",
                        counted("K3", tlinear.matmul_fused))
    monkeypatch.setattr(tattn, "flash_attention",
                        counted("K10", tattn.flash_attention))
    n_self, n_cross = tm.n_groups * tm.n_self, tm.n_groups
    assert (n_self, n_cross) == (4, 2)
    cache = tm.init_cache(1, 32)
    m = torch.from_numpy(media(tcfg, 1, 16))
    with torch.no_grad():
        tm({"tokens": torch.arange(5)[None], "media_embeds": m},
           mode="prefill", cache=cache)
        assert calls == {"K3": 1 + 7 * (n_self + n_cross),
                         "K10": n_self + n_cross, "causal": n_self}
        tm.decode_step(torch.tensor([[3]]), torch.tensor([5]), cache)
    assert calls["K3"] == (1 + 7 * (n_self + n_cross)
                           + 7 * n_self + 5 * n_cross)
    assert calls["K10"] == n_self + n_cross
    full = tregistry.get_model(tconfig.get_arch(VLM))
    fs, fc = full.n_groups * full.n_self, full.n_groups
    assert (1 + 7 * (fs + fc), fs + fc, 7 * fs + 5 * fc) == (281, 40, 264)


def test_cache_slot_views_every_leaf():
    """Every leaf has its batch on ``CACHE_BATCH_AXIS``: a slot's views
    of the self and cross caches are the rows of that request."""
    from repro_torch.models.common import cache_slot

    tm = models(VLM)[2]
    cache = tm.init_cache(3, 16)
    slot = cache_slot(cache, 1)
    for leaf, full in zip(tree_leaves(slot), tree_leaves(cache)):
        assert leaf.shape[CACHE_BATCH_AXIS] == 1
        leaf.fill_(1)
        assert full.narrow(CACHE_BATCH_AXIS, 1, 1).eq(1).all()
        assert not full.narrow(CACHE_BATCH_AXIS, 0, 1).any()
    assert tree_map(lambda t: t.shape, slot)["cross"]["k"] == (1, 1, 16, 2,
                                                               64)

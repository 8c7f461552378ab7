"""The port's encoder-decoder (``repro_torch.models.encdec``, the ``audio``
family: seamless-m4t-large-v2) against the JAX package's, on the CPU:
its spec, weights, caches, encoder, forward, prefill and decode, and the
calls it makes to K3 and K10.

The oracle is the JAX package's jnp code (the model, jitted); it reaches
no Pallas kernel.  Weights come from the JAX init, carried across by
``params_from_jax``.  The reduced config: two bidirectional encoder
layers over 16 frames of width 256, two decoder layers of self-attention,
cross-attention and a plain gelu MLP with biases, LayerNorm.
"""

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
from repro_torch.models.encdec import EncDecLM
from repro_torch.nn import attention as tattn
from repro_torch.nn import linear as tlinear
from repro_torch.nn.param import tree_leaves
from torch_cross_common import (AUDIO, TOL, both, cfgs, close, media,
                                models, prefill_and_decode, spec_rows)


def _check_cache(ours, theirs, tol):
    """Every leaf against JAX's, in the same layout: cross k, v, self k,
    v, all bf16."""
    theirs = jax.tree_util.tree_leaves(theirs)
    leaves = tree_leaves(ours)
    assert len(leaves) == len(theirs) == 4
    for a, b in zip(leaves, theirs):
        assert a.dtype == torch.bfloat16
        close(a, b, tol)


# -- the spec, the weights, the cache -------------------------------------------


@pytest.mark.parametrize("enc,dec", [(2, 2), (1, 3)])
def test_spec_matches_jax(enc, dec):
    """``param_spec`` and ``cache_spec``: JAX's keys, shapes, axes, init
    rules and dtypes (the frontend's and the MLP's fp32 biases, the
    LayerNorms' scales and biases), with and without a window."""
    jcfg, tcfg = cfgs(AUDIO, num_layers=dec, num_encoder_layers=enc)
    jm, tm = jregistry.get_model(jcfg), tregistry.get_model(tcfg)
    assert isinstance(tm, EncDecLM)
    assert spec_rows(tm.param_spec()) == spec_rows(jm.param_spec())
    for window in (0, 16):
        assert spec_rows(tm.cache_spec(3, 40, window)) == spec_rows(
            jm.cache_spec(3, 40, window))
    spec = tm.cache_spec(3, 40)
    assert spec["cross"]["k"].shape[CACHE_BATCH_AXIS] == 3
    assert (len(tm.encoder), len(tm.decoder)) == (enc, dec)


def test_full_width_shape_and_count():
    """seamless-m4t-large-v2 at full width: JAX's parameter counts
    (1,633,850,368; 1,109,038,080 without the embedding), 24 encoder and
    24 decoder layers, the frontend 1024 -> 1024 with a bias, the vocab
    padded to 256256, and the caches of 4 slots of 8192 rows."""
    cfg, jcfg = tconfig.get_arch(AUDIO), jconfig.get_arch(AUDIO)
    counts = [tregistry.analytic_param_count(cfg, **kw) for kw in (
        {}, {"active_only": True}, {"non_embedding": True})]
    assert counts == [jregistry.analytic_param_count(jcfg, **kw) for kw in (
        {}, {"active_only": True}, {"non_embedding": True})]
    assert counts == [1_633_850_368, 1_633_850_368, 1_109_038_080]
    assert (cfg.num_params(), cfg.active_params()) == tuple(counts[:2])
    m = tregistry.get_model(cfg)
    assert (len(m.encoder), len(m.decoder)) == (24, 24)
    assert all(p.device.type == "meta" for p in m.parameters())
    assert tuple(m.frontend["w"].shape) == (1024, 1024)
    assert cfg.padded_vocab == 256256
    assert m.decoder[0]["mlp"]["w_up"]["b"].dtype == torch.float32
    cache = m.cache_spec(4, 8192)
    assert cache["self"]["k"].shape == (24, 4, 8192, 16, 64)
    assert cache["cross"]["k"].shape == (24, 4, 4096, 16, 64)


def test_params_from_jax_is_bit_exact():
    """bf16 matrices and the fp32 biases and LayerNorm leaves cross bit
    for bit; encoder and decoder layer ``i`` read entry ``i``."""
    jcfg, tcfg = cfgs(AUDIO, "bfloat16")
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
    for i in range(2):
        assert tm.decoder[i]["cross"]["wk"]["w"].data_ptr() == \
            tree["decoder"]["cross"]["wk"]["w"][i].data_ptr()
        assert tm.encoder[i]["mlp"]["w_up"]["b"].data_ptr() == \
            tree["encoder"]["mlp"]["w_up"]["b"][i].data_ptr()
    with pytest.raises(ValueError, match="keys"):
        tregistry.get_model(tcfg).load_tree(
            {**tree, "frontend": {"w": tree["frontend"]["w"]}})


def test_init_cache_matches_jax():
    """Every leaf of the port's cache has JAX's shape and bf16 dtype, all
    zero."""
    jm, _, tm, _, _ = models(AUDIO)
    jc, tc = jm.init_cache(2, 16), tm.init_cache(2, 16)
    jl, tl = jax.tree_util.tree_leaves(jc), tree_leaves(tc)
    assert len(jl) == len(tl) == 4
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == "bfloat16" and b.dtype == torch.bfloat16
        assert not b.any()


# -- the encoder, forward, prefill and decode ---------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(dtype):
    """``encode``: the frontend, the bidirectional blocks with RoPE (K10
    non-causal) and the final LayerNorm, against JAX's ``encode``."""
    jm, jp, tm, _, _ = models(AUDIO, dtype)
    tfr, jfr = both(media(tm.cfg, 2, 7), dtype)
    ref = jax.jit(lambda p, f: jm.encode(p, f, "prefill"))(jp, jfr)
    with torch.no_grad():
        ours = tm.encode(tfr)
    assert ours.shape == (2, 16, tm.cfg.d_model)
    close(ours, ref, TOL[dtype]["logits"])


def test_encoder_is_bidirectional_and_uses_rope():
    """A change to the last frame moves the encoder's first row (no causal
    mask), and the same frames in another order give other rows than the
    rows reordered (RoPE on)."""
    tm = models(AUDIO)[2]
    fr = torch.from_numpy(media(tm.cfg, 1, 8))
    fr2 = fr.clone()
    fr2[:, -1] += 1.0
    with torch.no_grad():
        a, b = tm.encode(fr), tm.encode(fr2)
        rev = tm.encode(fr.flip(1)).flip(1)
    assert (a[:, 0] - b[:, 0]).abs().max() > 1e-4
    assert (a - rev).abs().max() > 1e-4


def test_forward_without_cache_matches_jax():
    """``forward`` without a cache: the logits and zero aux, whatever the
    mode."""
    jm, jp, tm, _, _ = models(AUDIO)
    toks = np.random.default_rng(11).integers(0, 512, (1, 13))
    tfr, jfr = both(media(tm.cfg, 1, 12), "float32")
    jl, _ = jax.jit(lambda p, t, f: jm.forward(
        p, {"tokens": t, "frames": f}))(jp, jnp.asarray(toks), jfr)
    with torch.no_grad():
        for mode in ("train", "prefill"):
            tl, aux = tm({"tokens": torch.from_numpy(toks), "frames": tfr},
                         mode=mode)
            close(tl, jl, TOL["float32"]["logits"])
            assert all(float(v) == 0.0 for v in aux.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(dtype):
    """A 9-token prompt and its 16 frames prefilled into a cache: the
    logits at every position, the self cache and the bf16 cross cache of
    every decoder layer written; then three ``decode_step``s against
    both."""
    prefill_and_decode(AUDIO, dtype, _check_cache)


def test_frames_move_the_logits():
    """A perturbed frames input moves the prefill's and a decode step's
    logits: the decoder reads the encoder through its cross-attention and
    its cross cache."""
    tm = models(AUDIO)[2]
    toks = torch.from_numpy(np.random.default_rng(14).integers(0, 512,
                                                               (1, 6)))
    f0 = torch.from_numpy(media(tm.cfg, 1, 15))
    runs = []
    for f in (f0, f0 + 0.5 * torch.randn(
            f0.shape, generator=torch.Generator().manual_seed(3))):
        cache = tm.init_cache(1, 16)
        with torch.no_grad():
            lg, _, _ = tm({"tokens": toks, "frames": f}, mode="prefill",
                          cache=cache)
            step, _ = tm.decode_step(torch.tensor([[7]]), torch.tensor([6]),
                                     cache)
        runs.append((lg, step))
    for a, b in zip(*runs):
        assert (a - b).abs().max() > 1e-3


def test_projections_and_attention_per_step(monkeypatch):
    """What the smoke's phase 11 counts on the card, on the CPU: a prefill
    calls K3's wrapper once for the frontend, 6 times an encoder layer and
    10 times a decoder layer, K10's once an encoder layer (non-causal) and
    twice a decoder layer (causal self, non-causal cross); a decode step
    calls K3's 8 times a decoder layer (self q, k, v, o, cross q, o, up,
    down) and K10's never.  At full width: 385, 72; 192."""
    _, tcfg = cfgs(AUDIO, num_layers=3, num_encoder_layers=2)
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
    ne, nd = 2, 3
    cache = tm.init_cache(1, 32)
    fr = torch.from_numpy(media(tcfg, 1, 16))
    with torch.no_grad():
        tm({"tokens": torch.arange(5)[None], "frames": fr}, mode="prefill",
           cache=cache)
        assert calls == {"K3": 1 + 6 * ne + 10 * nd, "K10": ne + 2 * nd,
                         "causal": nd}
        tm.decode_step(torch.tensor([[3]]), torch.tensor([5]), cache)
    assert calls["K3"] == 1 + 6 * ne + 10 * nd + 8 * nd
    assert calls["K10"] == ne + 2 * nd
    full = tconfig.get_arch(AUDIO)
    ne, nd = full.num_encoder_layers, full.num_layers
    assert (1 + 6 * ne + 10 * nd, ne + 2 * nd, 8 * nd) == (385, 72, 192)

"""The port's variants (``repro_torch.launch.variants``) on the CPU:
``head_pad`` keeps the logits — the JAX package's
``test_head_pad_preserves_semantics`` on the port, with JAX's weights
carried by ``params_from_jax`` — and the variants' plumbing."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro_torch.core import config as tconfig
from repro_torch.launch.variants import VARIANTS, apply_variants, head_pad
from repro_torch.models import registry as tregistry
from repro_torch.models.common import params_from_jax
from repro_torch.sharding.auto import rules_for

#: relative to max(1, max|logits|): the same fp32 arithmetic with zero
#: heads added (tests/test_torch_lm.py's fp32 logits limit)
TOL = 1e-4


def _cfgs(m):
    cfg = dataclasses.replace(m.get_arch("qwen1.5-32b").reduced(),
                              dtype="float32", param_dtype="float32",
                              num_heads=3, num_kv_heads=3)  # odd, like 40
    return cfg


def _graft(ps, pb, qd):
    """The small model's weights in the padded model's tree: the padded
    q/k/v columns and wo rows zero (the JAX package's test's graft)."""
    out = dict(pb)
    out["embed"], out["ln_f"] = ps["embed"], ps["ln_f"]
    out["layers"] = dict(pb["layers"])
    for k in ("ln_attn", "ln_mlp", "mlp"):
        out["layers"][k] = ps["layers"][k]
    attn, small = dict(pb["layers"]["attn"]), ps["layers"]["attn"]
    for name in ("wq", "wk", "wv"):
        entry = {"w": jnp.zeros_like(attn[name]["w"]).at[..., :qd].set(
            small[name]["w"])}
        if "b" in small[name]:
            entry["b"] = jnp.zeros_like(attn[name]["b"]).at[..., :qd].set(
                small[name]["b"])
        attn[name] = entry
    attn["wo"] = {"w": jnp.zeros_like(attn["wo"]["w"]).at[:, :qd, :].set(
        small["wo"]["w"])}
    out["layers"]["attn"] = attn
    return out


def test_head_pad_preserves_semantics():
    jcfg, tcfg = _cfgs(jconfig), _cfgs(tconfig)
    tcfg_p, _, note = head_pad(tcfg, rules_for(tcfg, tconfig.SINGLE_POD,
                                               None)[0], model_size=4)
    assert tcfg_p.num_heads == 4 and "head_pad" in note
    jcfg_p = dataclasses.replace(jcfg, num_heads=4, num_kv_heads=4)
    assert dataclasses.asdict(jcfg_p) == dataclasses.asdict(tcfg_p)
    jm, jm_p = jregistry.get_model(jcfg), jregistry.get_model(jcfg_p)
    jp = jm.init(jax.random.PRNGKey(0))
    jp_p = _graft(jp, jm_p.init(jax.random.PRNGKey(1)), jcfg.q_dim)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 12))

    def port(cfg, tree):
        m = tregistry.get_model(cfg).load_tree(params_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), cfg, device="cpu"))
        with torch.no_grad():
            return m.forward({"tokens": torch.from_numpy(toks)},
                             "prefill")[0].numpy()

    small, big = port(tcfg, jp), port(tcfg_p, jp_p)
    ref, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, mode="prefill")
    v = tcfg.vocab_size
    top = max(1.0, float(np.abs(np.asarray(ref)[..., :v]).max()))
    assert np.abs(big[..., :v] - small[..., :v]).max() <= TOL * top
    assert np.abs(big[..., :v] - np.asarray(ref)[..., :v]).max() <= TOL * top


def test_variant_chain_application():
    cfg = tconfig.get_arch("qwen1.5-32b")
    rules, _ = rules_for(cfg, tconfig.SINGLE_POD, None)
    cfg2, rules2, notes, mb = apply_variants(
        ("head_pad", "int8kv", "mb4"), cfg, rules, 16)
    assert cfg2.num_heads == 48 and cfg2.num_kv_heads == 48
    assert cfg2.kv_quant
    assert dict(rules2.table)["heads"] == "model"
    assert mb == 4
    assert len(notes) == 3


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_every_variant_registered_and_callable(name):
    cfg = tconfig.get_arch("internlm2-20b")
    rules, _ = rules_for(cfg, tconfig.SINGLE_POD, None)
    cfg2, rules2, note = VARIANTS[name](cfg, rules, 16)
    assert isinstance(note, str) and note
    if name == "seq_sp":
        assert dict(rules2.table)["seq_res"] == "model"

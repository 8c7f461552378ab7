"""The training phase of ``chip_smoke.py`` (phase 13) on the CPU: the
memory it reckons for each arch's train step (``train_memory_budget``),
the depth cuts it chooses from that reckoning (``train_cut``), and the
launches by role it expects from a config (``train_expect``) against the
K3 and K10 calls a CPU train step of each reduced arch makes.

The full-width models are built on the meta device: nothing is drawn.
No JAX here: the smoke's helpers are the port's own.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import pytest
import torch

from repro_torch.core.config import TrainConfig, get_arch
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.matmul_fused import ops as mm_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.models.registry import get_model
from repro_torch.nn.param import init_tree, tree_leaves
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import make_train_step

ALL_ARCHS = ["gemma2-2b", "rwkv6-1.6b", "zamba2-1.2b",
             "seamless-m4t-large-v2", "qwen3-moe-30b-a3b", "starcoder2-15b",
             "llama-3.2-vision-11b", "internlm2-20b", "qwen1.5-32b",
             "grok-1-314b"]


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's torch ops on one intra-op thread (small shapes, as
    tests/test_torch_train.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_memory_budget_parts_sum_to_the_total(arch):
    """At full width and depth (meta device): the parts sum to the
    total; the weights are the model's bytes, the grads the same, the
    moments 8 bytes a parameter, the logits five fp32 tensors of the
    rows x the padded vocab (seven with a softcap); the microbatches' fp32 accumulation only
    where there are microbatches."""
    model = get_model(get_arch(arch))
    for mb in (1, 2):
        b = SMOKE.train_memory_budget(model, 2, 2048, mb)
        parts = {k: v for k, v in b.items() if k != "total"}
        assert b["total"] == pytest.approx(sum(parts.values()), rel=1e-12)
        assert all(v >= 0 for v in parts.values())
        params = list(model.parameters())
        n = sum(p.numel() for p in params)
        assert b["weights"] == b["grads"] == sum(
            p.numel() * p.element_size() for p in params) / 1e9
        assert b["moments"] == 8 * n / 1e9
        assert b["grad_accumulation"] == (4 * n / 1e9 if mb > 1 else 0.0)
        tensors = 5 + 2 * bool(model.cfg.logit_softcap)
        assert b["logits"] == pytest.approx(
            tensors * 4 * (4096 // mb) * model.cfg.padded_vocab / 1e9,
            rel=1e-12)
        assert (b["media"] > 0) == (model.cfg.family in ("vlm", "audio"))


def test_grok_does_not_fit_one_card_at_one_layer():
    """grok-1-314b cut to one layer: its reckoning is past the card's 80
    GB (a layer holds about 4.9 G parameters, 59 GB at 12 bytes a
    parameter), so the smoke cannot train it; ``train_cut`` bottoms out
    at that one layer."""
    cfg = dataclasses.replace(get_arch("grok-1-314b"), num_layers=1)
    budget = SMOKE.train_memory_budget(get_model(cfg), 2, 2048)
    assert budget["total"] > 80.0
    layer = sum(math.prod(p.shape) for p in tree_leaves(
        get_model(cfg).param_spec()))
    assert 12 * layer / 1e9 > 59.0
    cut, reduced, b = SMOKE.train_cut("grok-1-314b")
    assert cut.num_layers == 1 and b["total"] > 80.0
    assert "grok-1-314b" not in SMOKE.TRAIN_ARCHS


@pytest.mark.parametrize("arch", ["gemma2-2b", "rwkv6-1.6b", "zamba2-1.2b",
                                  "seamless-m4t-large-v2"])
def test_small_archs_train_whole(arch):
    cfg, reduced, budget = SMOKE.train_cut(arch)
    assert reduced is None and cfg == get_arch(arch)
    assert budget["total"] <= SMOKE.TRAIN_MEMORY_LIMIT_GB


@pytest.mark.parametrize("arch,unit", [("qwen3-moe-30b-a3b", 1),
                                       ("starcoder2-15b", 1),
                                       ("llama-3.2-vision-11b", 5)])
def test_each_cut_is_the_most_units_that_fit(arch, unit):
    """The smoke's cut archs: the chosen depth reckons within the limit
    and one more unit (a layer; llama's group of 4 self and 1 cross
    layer) does not; width, heads, experts, vocab and the media as
    published; the cut printed with its reason."""
    full = get_arch(arch)
    cfg, reduced, budget = SMOKE.train_cut(arch)
    mb = SMOKE.TRAIN_MICROBATCHES.get(arch, 1)
    assert cfg == dataclasses.replace(full, num_layers=cfg.num_layers)
    assert cfg.num_layers % unit == 0 and cfg.num_layers < full.num_layers
    assert budget["total"] <= SMOKE.TRAIN_MEMORY_LIMIT_GB < 80.0
    more = dataclasses.replace(full, num_layers=cfg.num_layers + unit)
    assert SMOKE.train_memory_budget(get_model(more), SMOKE.TRAIN_BATCH,
                                     SMOKE.TRAIN_SEQ, mb)["total"] \
        > SMOKE.TRAIN_MEMORY_LIMIT_GB
    assert reduced["num_layers"] == [full.num_layers, cfg.num_layers]
    assert str(cfg.num_layers) in reduced["why"]


def _count_step(monkeypatch, cfg, mb):
    """One CPU train step of ``cfg`` with K3's calls counted by role and
    K10's and K11's (the plain versions' calls, as the wrappers count
    the card's launches) -> (counts inside the model's forward calls,
    counts of the whole step)."""
    counts = {"forward": 0, "z": 0, "dx": 0, "dw": 0, "K10": 0,
              "K10_ml": 0, "K11": 0}
    real_call, real_attn = mm_ops._call, attn_ops.flash_attention_ref
    real_wkv = wkv6_ops.wkv6_chunked_ref

    def call(x, w, b, act, role="forward"):
        counts[role] += 1
        return real_call(x, w, b, act, role)

    def attn(*a, **kw):
        counts["K10"] += 1
        counts["K10_ml"] += bool(kw.get("return_ml"))
        return real_attn(*a, **kw)

    def wkv(*a, **kw):
        counts["K11"] += not torch.is_grad_enabled()  # not the backward's
        return real_wkv(*a, **kw)

    monkeypatch.setattr(mm_ops, "_call", call)
    monkeypatch.setattr(attn_ops, "flash_attention_ref", attn)
    monkeypatch.setattr(wkv6_ops, "wkv6_chunked_ref", wkv)
    model = get_model(cfg)
    tree = init_tree(model.param_spec(), torch.Generator().manual_seed(0),
                     "float32")
    model.load_tree(tree)
    step = make_train_step(model, TrainConfig(1e-3, 2, 10), microbatches=mb)
    toks = torch.randint(0, cfg.vocab_size, (2, 17),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    batch.update(SMOKE._train_media(torch, cfg, 2,
                                    torch.Generator().manual_seed(2), "cpu",
                                    torch.float32))
    inside, entered = dict.fromkeys(counts, 0), {}
    model.register_forward_pre_hook(lambda *_: entered.update(counts))
    model.register_forward_hook(lambda *_: inside.update(
        {k: inside[k] + counts[k] - entered[k] for k in counts}))
    for k in counts:
        counts[k] = 0
    step(tree, adamw_init(tree), batch)
    return inside, counts


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_expect_counts_a_cpu_step(arch, monkeypatch):
    """``train_expect`` of each reduced arch (at two depths, a unit apart:
    gemma2's local/global pair, a VLM group; the smoke's microbatches)
    equals the K3 calls by
    role and the K10/K11 calls of one CPU train step: the forward's
    inside the model's forward calls, the remat recompute's and the
    backward's after."""
    base = dataclasses.replace(get_arch(arch).reduced(), dtype="float32",
                               param_dtype="float32")
    unit = (base.cross_attn.interval if base.family == "vlm"
            else max(1, base.local_global_interval))
    mb = SMOKE.TRAIN_MICROBATCHES.get(arch, 1)
    for layers in (base.num_layers, base.num_layers + unit):
        cfg = dataclasses.replace(base, num_layers=layers)
        inside, total = _count_step(monkeypatch, cfg, mb)
        got = {"K3_forward": inside["forward"],
               "K3_recompute": total["forward"] - inside["forward"],
               "K3_z": total["z"], "K3_dx": total["dx"],
               "K3_dw": total["dw"], "K10_forward": inside["K10"],
               "K10_backward": total["K10"] - inside["K10"],
               "K10_ml": total["K10_ml"], "K11_forward": inside["K11"],
               "K11_backward": total["K11"] - inside["K11"]}
        assert got == SMOKE.train_expect(cfg, mb), layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bits_fingerprint_tells_different_bits_apart(dtype):
    """The determinism check's fingerprints: a copy gives the same pair
    (at any chunk size, the same for both); one element one ulp away, two elements
    swapped, -0.0 for 0.0, or a NaN's other bit pattern, each another."""
    t = torch.randn(1000, generator=torch.Generator().manual_seed(3)).to(
        dtype)
    t[7] = 0.0
    fp = SMOKE.bits_fingerprint(torch, t)
    assert fp == SMOKE.bits_fingerprint(torch, t.clone())
    assert SMOKE.bits_fingerprint(torch, t, chunk=64) == \
        SMOKE.bits_fingerprint(torch, t.clone(), chunk=64)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dtype]
    variants = [t.clone() for _ in range(4)]
    variants[0].view(ints)[3] += 1
    variants[1][[10, 11]] = t[[11, 10]]
    variants[2][7] = -0.0
    variants[3][5] = float("nan")
    nan2 = variants[3].clone()
    nan2.view(ints)[5] ^= 1
    for v in variants + [nan2]:
        assert not torch.equal(v.view(ints), t.view(ints))
        assert SMOKE.bits_fingerprint(torch, v) != fp
    assert SMOKE.bits_fingerprint(torch, nan2) != \
        SMOKE.bits_fingerprint(torch, variants[3])

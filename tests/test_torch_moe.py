"""The port's MoE path (``repro_torch.nn.linear.act_fn``, ``nn.moe``, the
MoE blocks of ``models.transformer``, the registry's counts,
``serving.engine``, ``launch.serve``) and the sliced draw of large leaves
(``nn.param``) against the JAX package, on the CPU.

The JAX side is its jnp code (``repro.nn.moe`` has no Pallas kernel).
Inputs and small expert weights come from numpy seeds; the models' weights
from the JAX init, carried across by ``params_from_jax``.  Routing is
discrete, so every comparison of outputs also holds the routing: the same
experts chosen and, where a capacity bound drops pairs, the same pairs
dropped (a different drop order changes the output rows of the tokens
whose pairs it swaps).
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
from repro.nn import linear as jlinear
from repro.nn import moe as jmoe
from repro.serving import engine as jengine
from repro_torch.core import config as tconfig
from repro_torch.launch import serve as tserve
from repro_torch.models import registry as tregistry
from repro_torch.models.common import params_from_jax
from repro_torch.nn import linear as tlinear
from repro_torch.nn import moe as tmoe
from repro_torch.nn import param as tparam
from repro_torch.nn.param import Param, init_tree, tree_leaves
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ["qwen3-moe-30b-a3b", "grok-1-314b"]  # silu and gelu experts
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: ``moe_apply`` against JAX's, relative to max(1, max|ref|).  fp32: the
#: same sums in another order (1.2e-7 of the output seen): 1e-5.  bf16:
#: both sides gather the same rows and take bf16 products with fp32 sums,
#: but XLA computes grok's tanh-gelu on bf16 in fp32 where the port rounds
#: each step to bf16 as JAX's jnp expression reads (silu: equal bits seen;
#: gelu: 0.91 * 2^-7 seen): 2^-6.
MOE_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -6}
#: the aux: fp32 means of the same fp32 router (2.3e-10 seen)
AUX_TOL = 1e-6
#: the models, relative to max(1, max|ref|): as tests/test_torch_lm.py
#: (fp32: 1e-4 on the logits; the bf16 KV cache one rounding, 2^-7; the
#: decode logits read it, 2e-3)
MODEL_TOL = {"logits": 1e-4, "cache": 2.0 ** -7, "decode": 2e-3}


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(ours, ref, tol):
    """max |ours - ref| <= tol * max(1, max |ref|)."""
    a, b = _f32(ours), _f32(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _cfgs(arch, **moe):
    """(JAX, port) reduced configs of ``arch`` at d_model 64, with
    ``moe`` replacing fields of the MoE config."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.get_arch(arch).reduced()
        out.append(dataclasses.replace(
            cfg, d_model=64, moe=dataclasses.replace(cfg.moe, **moe)))
    return out


def _weights(cfg, seed=0, router=None):
    """Expert weights from numpy, fp32, scaled so every stage is O(1)."""
    rng = np.random.default_rng(seed)
    E, f, d = cfg.moe.num_experts, cfg.moe.d_ff_expert, cfg.d_model
    w = {"router": rng.standard_normal((d, E)) / math.sqrt(d),
         "we_gate": rng.standard_normal((E, d, f)) / math.sqrt(d),
         "we_up": rng.standard_normal((E, d, f)) / math.sqrt(d),
         "we_down": rng.standard_normal((E, f, d)) / math.sqrt(f)}
    if router is not None:
        w["router"] = router
    return {k: v.astype(np.float32) for k, v in w.items()}


def _both(w, dtype):
    """The weights as JAX arrays and as tensors: the router fp32, the
    experts in ``dtype`` with the same bits on both sides."""
    tdt, jdt = DTYPES[dtype]
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in w.items()}
    tp = {k: torch.from_numpy(np.array(_f32(v))).to(
        torch.float32 if k == "router" else tdt) for k, v in jp.items()}
    return jp, tp


def _x(shape, dtype, seed=1):
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


#: JAX's ``moe_apply`` compiled once a shape (op by op it compiles every
#: primitive of every call)
_jax_moe = jax.jit(jmoe.moe_apply, static_argnames=("cfg", "dp_size", "mode"))


def _check_moe(jcfg, tcfg, jp, tp, jx, tx, dtype, mode, dp):
    """Outputs and aux of both ``moe_apply``; returns the port's routing."""
    jo, ja = _jax_moe(jp, jx, jcfg, dp_size=dp, mode=mode)
    to, ta = tmoe.moe_apply(tp, tx, tcfg, dp_size=dp, mode=mode)
    assert to.dtype == tx.dtype and to.shape == tx.shape
    _close(to, jo, MOE_TOL[dtype])
    assert set(ta) == set(ja)
    # the fractions are counts over T·k (a count off by one moves one by
    # 1/24 here), divided by JAX as a product by the reciprocal
    for k in ta:
        _close(ta[k], ja[k], AUX_TOL)
    return tmoe.route(tp, tx, tcfg, dp_size=dp, mode=mode)


# -- act_fn ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("act", ["relu", "silu", "gelu", "none"])
def test_act_fn_matches_jax(act, dtype):
    """JAX's ``_ACTS`` with its dtype rules: silu through an fp32 sigmoid,
    gelu and relu in x's dtype.  fp32 within 1e-6; bf16 within one bf16
    step of the largest (2^-7: XLA evaluates gelu's bf16 expression in
    fp32, the port step by step in bf16)."""
    jx, tx = _x((4, 257), dtype)
    tx = tx * 4
    jx = jx * 4
    ours, ref = tlinear.act_fn(act)(tx), jlinear.act_fn(act)(jx)
    assert ours.dtype == tx.dtype
    _close(ours, ref, 1e-6 if dtype == "float32" else 2.0 ** -7)


# -- moe_apply ----------------------------------------------------------------


#: qwen3 at every group count; grok-1 (gelu experts, the same dispatch)
#: at two groups
MOE_CASES = [(a, dp) for a in ARCHS
             for dp in ((1, 2, 3) if a == ARCHS[0] else (2,))]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,dp", MOE_CASES)
def test_moe_apply_matches_jax(arch, dp, mode, dtype):
    """12 tokens in 1, 2 or 3 groups, 4 experts, top-2: the capacity JAX
    sets for the mode, outputs and aux within the stated tolerances."""
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_weights(tcfg), dtype)
    jx, tx = _x((2, 6, 64), dtype)
    r = _check_moe(jcfg, tcfg, jp, tp, jx, tx, dtype, mode, dp)
    T_l = 12 // dp
    k, E = tcfg.moe.num_experts_per_token, tcfg.moe.num_experts
    cf = {"train": tcfg.moe.capacity_factor,
          "prefill": tcfg.moe.eval_capacity_factor}.get(mode)
    want = T_l * k if cf is None else min(math.ceil(T_l * k * cf / E),
                                          T_l * k)
    assert (r.logits.shape[0], r.cap) == (dp, want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dp", [1, 2, 3])
def test_moe_apply_matches_jax_where_capacity_drops(dp, dtype):
    """``capacity_factor=0.5`` in ``train``: each group's experts take half
    their even share, so pairs drop in every group; the outputs still
    equal JAX's."""
    jcfg, tcfg = _cfgs(ARCHS[0], capacity_factor=0.5)
    jp, tp = _both(_weights(tcfg, seed=2), dtype)
    jx, tx = _x((2, 6, 64), dtype, seed=3)
    r = _check_moe(jcfg, tcfg, jp, tp, jx, tx, dtype, "train", dp)
    assert r.cap == math.ceil(12 // dp * 2 * 0.5 / 4)
    assert (~r.keep).any(dim=1).all()  # drops in every group


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_overflowing_expert_keeps_its_first_tokens(mode, dp):
    """A router that sends every token to expert 0 first, with a capacity
    under a group's tokens (``eval_capacity_factor`` 1 here): expert 0
    keeps the first ``cap`` tokens of each group in flat order and drops
    the rest, as JAX's stable sort does, and the outputs equal JAX's.
    Keeping any other ``cap`` tokens would give other output rows: the
    same tokens in reverse order within each group (so expert 0 keeps the
    last ones) differ from these outputs at the swapped tokens."""
    jcfg, tcfg = _cfgs(ARCHS[0], eval_capacity_factor=1.0)
    router = np.random.default_rng(4).standard_normal((64, 4)) / 8
    router[:, 0] = 1.0  # x > 0: expert 0's logit sum(x) leads by far
    jp, tp = _both(_weights(tcfg, seed=5, router=router), "float32")
    x = np.abs(np.random.default_rng(6).standard_normal((2, 6, 64)))
    jx, tx = jnp.asarray(x, jnp.float32), torch.from_numpy(x).float()
    r = _check_moe(jcfg, tcfg, jp, tp, jx, tx, "float32", mode, dp)
    T_l = 12 // dp
    assert bool((r.e_k[..., 0] == 0).all())
    assert r.cap < T_l  # expert 0 overflows
    # the sorted entries of expert 0 come first, in token order
    assert torch.equal(r.order[:, :T_l] // 2,
                       torch.arange(T_l).expand(dp, T_l))
    assert torch.equal(r.keep[:, :T_l],
                       (torch.arange(T_l) < r.cap).expand(dp, T_l))
    out, _ = tmoe.moe_apply(tp, tx, tcfg, dp_size=dp, mode=mode)
    rev = tx.reshape(dp, T_l, 64).flip(1).reshape(2, 6, 64)
    other, _ = tmoe.moe_apply(tp, rev, tcfg, dp_size=dp, mode=mode)
    other = other.reshape(dp, T_l, 64).flip(1).reshape(2, 6, 64)
    assert float((other - out).abs().max()) > 0.1 * float(out.abs().max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_reference_matches_jax(arch, dtype):
    jcfg, tcfg = _cfgs(arch)
    jp, tp = _both(_weights(tcfg), dtype)
    jx, tx = _x((2, 6, 64), dtype)
    ref = jax.jit(jmoe.moe_reference, static_argnames=("cfg",))(jp, jx,
                                                                cfg=jcfg)
    _close(tmoe.moe_reference(tp, tx, tcfg), ref, MOE_TOL[dtype])


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_without_drops_is_the_reference(arch, mode):
    """Without drops (4 experts, top-2: ``prefill``'s capacity is a whole
    group, ``decode``'s the worst case) the dispatch computes the dense
    mixing: fp32, within 1e-5."""
    _, tcfg = _cfgs(arch)
    _, tp = _both(_weights(tcfg), "float32")
    _, tx = _x((2, 6, 64), "float32")
    assert bool(tmoe.route(tp, tx, tcfg, mode=mode).keep.all())
    out, _ = tmoe.moe_apply(tp, tx, tcfg, mode=mode)
    _close(out, tmoe.moe_reference(tp, tx, tcfg), 1e-5)


# -- the models -----------------------------------------------------------------


_MODELS = {}


def _models(arch, dtype="float32"):
    """(JAX model, JAX params, port model) with the JAX init's weights."""
    key = (arch, dtype)
    if key not in _MODELS:
        cfgs = [dataclasses.replace(m.get_arch(arch).reduced(), dtype=dtype,
                                    param_dtype=dtype)
                for m in (jconfig, tconfig)]
        jm = jregistry.get_model(cfgs[0])
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tregistry.get_model(cfgs[1])
        tm.load_tree(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     cfgs[1], device="cpu"))
        _MODELS[key] = (jm, jp, tm)
    return _MODELS[key]


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, mode):
    """fp32 logits at every position and the aux losses summed over the
    layers; ``mode`` sets the capacity (12 tokens a row, 24 in the batch:
    ``train`` drops where an expert takes more than 15 of the 48 picks)."""
    jm, jp, tm = _models(arch)
    toks = np.random.default_rng(7).integers(0, 512, (2, 12))
    jl, ja = jm.forward(jp, {"tokens": jnp.asarray(toks)}, mode=mode)
    with torch.no_grad():
        tl, ta = tm({"tokens": torch.from_numpy(toks)}, mode=mode)
    _close(tl, jl, MODEL_TOL["logits"])
    assert set(ta) == set(ja) == {"load_balance_loss", "router_z_loss"}
    for k in ta:
        assert ta[k].dtype == torch.float32 and ta[k].shape == ()
        assert float(ta[k]) > 0
        _close(ta[k], ja[k], AUX_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """A 20-token prefill into the cache, then a decode step at two
    positions: logits and the bf16 caches."""
    jm, jp, tm = _models(arch)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, 512, (2, 20))
    jc = jm.init_cache(2, 32)
    jl, jc, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                           mode="prefill", cache=jc)
    tc = tm.init_cache(2, 32)
    with torch.no_grad():
        tl, tc, _ = tm({"tokens": torch.from_numpy(toks)}, mode="prefill",
                       cache=tc)
    _close(tl, jl, MODEL_TOL["logits"])
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(a, b, MODEL_TOL["cache"])
    nxt = rng.integers(0, 512, (2, 1))
    pos = np.array([20, 20], np.int32)
    jl2, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
    with torch.no_grad():
        tl2, tc = tm.decode_step(torch.from_numpy(nxt),
                                 torch.from_numpy(pos), tc)
    _close(tl2, jl2, MODEL_TOL["decode"])
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(a, b, MODEL_TOL["cache"])


def test_params_from_jax_carries_the_moe_leaves():
    """qwen3's router stays fp32 and its experts cross bit for bit in
    bf16."""
    jm, jp, tm = _models(ARCHS[0], "bfloat16")
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tm.cfg,
                           device="cpu")
    moe, jmoe_p = tree["layers"]["mlp"], jp["layers"]["mlp"]
    assert moe["router"].dtype == torch.float32
    assert np.array_equal(moe["router"].numpy(), np.asarray(jmoe_p["router"]))
    for name in ("we_gate", "we_up", "we_down"):
        assert moe[name].dtype == torch.bfloat16
        assert np.array_equal(moe[name].view(torch.int16).numpy(),
                              np.asarray(jmoe_p[name]).view(np.int16))


def test_serving_matches_jax_greedy():
    """Three requests on two slots: each prefill routes its own prompt, each
    decode step both slots at worst-case capacity; the port's engine gives
    the JAX engine's tokens."""
    jm, jp, tm = _models(ARCHS[0])
    rng = np.random.default_rng(9)
    reqs = [Request(rid, rng.integers(0, 512, n).tolist(), max_new_tokens=m)
            for rid, (n, m) in enumerate(((5, 4), (17, 3), (9, 5)))]
    done = []
    for eng in (ServingEngine(tm, max_batch=2, max_len=32, device="cpu"),
                jengine.ServingEngine(jm, jp, max_batch=2, max_len=32)):
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        done.append(eng.run_until_drained())
    assert sorted(done[0]) == [0, 1, 2]
    assert done[0] == done[1]


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_on_the_cpu(arch, capsys):
    """``repro_torch.launch.serve.main`` serves the reduced MoE models, as
    the JAX launcher does."""
    out = tserve.main(["--arch", arch, "--device", "cpu", "--requests", "3",
                       "--max-new", "4", "--max-len", "32"])
    assert sorted(out["done"]) == [0, 1, 2]
    assert all(len(t) == 4 for t in out["done"].values())
    assert f"[serve] {arch}: 3 requests, 12 tokens" in capsys.readouterr().out


# -- the sliced draw ------------------------------------------------------------


def test_draw_below_the_limit_is_one_draw():
    """A leaf at or under ``DRAW_LIMIT`` elements is one fp32 draw, scaled
    and cast, bit for bit as before the limit existed."""
    spec = {"a": Param((3, 40, 24), ("l", "x", "y"), init="fan_in"),
            "b": Param((50, 20), ("x", "y"), init="normal", scale=0.5,
                       dtype="float32")}
    t = init_tree(spec, torch.Generator().manual_seed(3), "bfloat16")
    g = torch.Generator().manual_seed(3)
    a = (40 ** -0.5 * torch.randn((3, 40, 24), generator=g)).to(torch.bfloat16)
    b = (0.5 * torch.randn((50, 20), generator=g)).float()
    assert torch.equal(t["a"], a) and torch.equal(t["b"], b)


@pytest.mark.parametrize("limit", [90, 30])
def test_draw_above_the_limit_goes_slice_by_slice(limit, monkeypatch):
    """Past the limit a leaf is drawn a leading slice at a time, and a
    slice past it a leading slice of its own at a time: the leaf's shape
    and type, each slice its own scaled draw, the init's std."""
    monkeypatch.setattr(tparam, "DRAW_LIMIT", limit)
    p = Param((4, 3, 5, 6), ("l", "e", "x", "y"), init="fan_in")
    t = init_tree({"w": p}, torch.Generator().manual_seed(0), "bfloat16")["w"]
    assert t.shape == (4, 3, 5, 6) and t.dtype == torch.bfloat16
    g = torch.Generator().manual_seed(0)
    std = 4 ** -0.5  # a 4-D leaf's fan-in is its leading axis (JAX's rule)
    for sl in t:
        if sl.numel() <= limit:
            want = torch.randn(sl.shape, generator=g).mul_(std)
        else:
            want = torch.stack([torch.randn(s.shape, generator=g).mul_(std)
                                for s in sl])
        assert torch.equal(sl, want.to(torch.bfloat16))
    monkeypatch.setattr(tparam, "DRAW_LIMIT", 2000)
    big = init_tree({"w": Param((64, 40, 50), ("l", "x", "y"),
                                init="fan_in")},
                    torch.Generator().manual_seed(1), "float32")["w"]
    assert abs(big.std().item() * 40 ** 0.5 - 1) < 0.02


@pytest.mark.parametrize("arch", ["gemma2-2b", "rwkv6-1.6b",
                                  "qwen3-moe-30b-a3b"])
def test_full_width_leaves_against_the_draw_limit(arch):
    """No leaf of the full-width models drawn whole so far crosses
    ``DRAW_LIMIT``; qwen3's three stacked expert leaves do, and their
    slices (one layer's experts) do not.  On the spec, nothing built."""
    spec = tregistry.get_model(tconfig.get_arch(arch)).param_spec()
    big = [p.shape for p in tree_leaves(spec)
           if math.prod(p.shape) > tparam.DRAW_LIMIT]
    if arch != "qwen3-moe-30b-a3b":
        assert big == []
        return
    assert big == [(48, 128, 768, 2048), (48, 128, 2048, 768),
                   (48, 128, 2048, 768)]
    assert all(math.prod(s[1:]) <= tparam.DRAW_LIMIT for s in big)


# -- the smoke's phase-9 helpers ------------------------------------------------


def _smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_routing_record_and_check():
    """``record_routing`` leaves the block's output as it was and records
    ``route``'s experts and kept pairs (in flat order); ``check_routing``
    passes equal sides and fails a side with one expert or one kept pair
    changed."""
    smoke = _smoke()
    _, _, tm = _models(ARCHS[0])
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, 512,
                                                                (1, 24)))
    with torch.no_grad():
        want, _ = tm({"tokens": toks}, mode="prefill")
        log = []
        with smoke.record_routing(torch, log):
            got, _ = tm({"tokens": toks}, mode="prefill")
            tm({"tokens": toks}, mode="prefill")
    assert torch.equal(got, want) and len(log) == 4
    assert [r["mode"] for r in log] == ["prefill"] * 4
    for r in log[:2]:
        r["device"] = "cuda"
    assert smoke.check_routing(log)["calls"] == 2
    for field in ("experts", "kept"):
        bad = [dict(r) for r in log]
        t = bad[3][field].clone()
        t.view(-1)[0] = (t.view(-1)[0] + 1) % 4 if field == "experts" \
            else ~t.view(-1)[0]
        bad[3][field] = t
        with pytest.raises(SystemExit):
            smoke.check_routing(bad)


def test_smoke_memory_budget_of_qwen3():
    """The phase-9 budget from the full-width model on the meta device:
    its weights (bf16; the routers and norm scales fp32, 12,793,856 of
    them), the bf16 KV cache of 4 slots of 8192 rows, the fp32 logits of
    4500 tokens."""
    smoke = _smoke()
    model = tregistry.get_model(tconfig.get_arch(ARCHS[0]))
    budget = smoke.memory_budget(model)
    fp32 = sum(math.prod(p.shape) for p in tree_leaves(model.param_spec())
               if p.dtype == "float32")
    assert fp32 == 48 * (2048 * 128 + 2 * 2048 + 2 * 128) + 2048
    assert budget["weights"] == (2 * (30_532_122_624 - fp32)
                                 + 4 * fp32) / 1e9
    assert budget["kv_cache"] == 2 * 2 * 48 * 4 * 8192 * 4 * 128 / 1e9
    assert budget["logits"] == 4 * 4500 * 151936 / 1e9

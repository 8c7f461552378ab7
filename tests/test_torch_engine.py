"""The port's engine slice on the CPU, against the JAX engine.

Same networks, same plans, same weights (drawn with numpy from a seed and
carried across by ``params_from_numpy``): the port's
``CNNEngine(net, device="cpu").forward`` must match JAX's
``CNNEngine(net).jit_forward()`` (its jnp path) to max abs <= 1e-4 on the
softmax output, with the same argmax.  Also: the plans, the deploy load
side, the device rule, the band geometry the CUDA conv kernels use, and
that the port imports nothing of JAX.
"""
import ast
import dataclasses
import functools
import json
import math
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as jdeploy
from repro.core import netdefs as jnetdefs
from repro.core.engine import CNNEngine as JEngine
from repro.core.methods import Method as JMethod
from repro.core.fusion import fusion_summary as jax_fusion_summary
from repro_torch.core import netdefs as tnetdefs
from repro_torch.core.deploy import load_model, params_from_numpy
from repro_torch.core.engine import CNNEngine
from repro_torch.core.fusion import fusion_summary
from repro_torch.core.methods import Method
from repro_torch.core.plan import infer_param_shapes
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.ref import pool_lrn_tail

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def narrow_alexnet(nd):
    """AlexNet's layers with channels ÷16, fc 64/64/10 and a 3×99×99
    input: the same three fused groups at a fraction of the work.  ``nd``
    is either package's netdefs module."""
    widths = {"fc6": 64, "fc7": 64, "fc8": 10}
    net = nd.alexnet()
    layers = tuple(
        dataclasses.replace(l, out_channels=widths.get(
            l.name, l.out_channels // 16)) if l.kind in ("conv", "fc") else l
        for l in net.layers)
    return nd.NetworkDef("alexnet_narrow", (3, 99, 99), 10, layers)


def _nets(nd):
    return {"lenet5": nd.lenet5(), "cifar10": nd.cifar10_quick(),
            "alexnet": nd.alexnet(), "alexnet_narrow": narrow_alexnet(nd)}


def he_params(shapes, seed):
    rng = np.random.default_rng(seed)
    params = {}
    for name, shp in shapes.items():
        conv = len(shp) == 4
        fan = int(np.prod(shp[1:])) if conv else shp[0]
        params[name] = {
            "w": (rng.standard_normal(shp) * np.sqrt(2.0 / fan)
                  ).astype(np.float32),
            "b": (0.05 * rng.standard_normal(shp[0] if conv else shp[1])
                  ).astype(np.float32)}
    return params


def _jax_tree(params):
    return {k: {kk: jnp.asarray(v) for kk, v in d.items()}
            for k, d in params.items()}


# -- the slice as a whole --------------------------------------------------------


@pytest.mark.parametrize("name,batch", [("lenet5", 2), ("cifar10", 2),
                                        ("alexnet_narrow", 2),
                                        ("alexnet", 1)])
def test_engine_forward_matches_jax(name, batch):
    jnet, tnet = _nets(jnetdefs)[name], _nets(tnetdefs)[name]
    params = he_params(infer_param_shapes(tnet), seed=len(name))
    x = np.random.default_rng(batch).standard_normal(
        (batch, *tnet.input_shape)).astype(np.float32)
    theirs = np.asarray(JEngine(jnet).jit_forward()(_jax_tree(params),
                                                     jnp.asarray(x)))
    eng = CNNEngine(tnet, device="cpu")
    ours = eng.forward(params_from_numpy(params, "cpu"), x).numpy()
    assert ours.shape == theirs.shape == (batch, tnet.num_classes)
    assert np.abs(ours - theirs).max() <= TOL
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))


@pytest.mark.parametrize("name", ["lenet5", "cifar10", "alexnet_narrow"])
@pytest.mark.parametrize("method", [m.value for m in Method])
@pytest.mark.parametrize("fuse", [True, False])
def test_method_ladder_forward_matches_jax(name, method, fuse):
    """Every rung of the method ladder, fused and unfused, against the JAX
    engine's jitted jnp forward at the same method and fuse setting: the
    port runs each method's own plain versions (K7, K8, K9 and K1–K3's on
    the card)."""
    tnet = _nets(tnetdefs)[name]
    params = he_params(infer_param_shapes(tnet), seed=len(name))
    x = np.random.default_rng(7).standard_normal(
        (2, *tnet.input_shape)).astype(np.float32)
    eng = CNNEngine(tnet, method=Method(method), fuse_pool=fuse,
                    device="cpu")
    ours = eng.forward(params_from_numpy(params, "cpu"), x).numpy()
    # seq_ref and basic_parallel never fuse: their fused and unfused plans
    # are one plan, with one JAX reference
    groups = tuple(fusion_summary(eng.plan()))
    theirs, jgroups = _jax_ladder_forward(name, method, fuse and bool(groups))
    assert ours.shape == theirs.shape == (2, tnet.num_classes)
    assert np.abs(ours - theirs).max() <= TOL
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))
    assert groups == jgroups


@functools.lru_cache(maxsize=None)
def _jax_ladder_forward(name, method, fuse):
    """The JAX engine's jitted forward for the ladder test, and its fused
    groups."""
    jnet, tnet = _nets(jnetdefs)[name], _nets(tnetdefs)[name]
    params = he_params(infer_param_shapes(tnet), seed=len(name))
    x = np.random.default_rng(7).standard_normal(
        (2, *tnet.input_shape)).astype(np.float32)
    jeng = JEngine(jnet, method=JMethod(method), fuse_pool=fuse)
    out = np.asarray(jeng.jit_forward()(_jax_tree(params), jnp.asarray(x)))
    return out, tuple(jax_fusion_summary(jeng.plan()))


#: the tuned deployment the smoke runs (K5, K4, K6) and each of its
#: knobs alone; the pool carry alone leaves conv1's group on K1, since
#: norm1 stays fused and K5 takes no LRN
TUNED = {"per_layer_fuse": {"norm1": False},
         "per_layer_pool_carry": {"conv1": True},
         "per_layer_lrn_oc_block": {"conv2": True},
         "per_layer_oc_block_final": {"conv5": 8}}
KNOB_SETS = {
    "tuned": (TUNED, ["K5", "K4", "K6"]),
    "pool_carry": ({"per_layer_pool_carry": {"conv1": True}},
                   ["K1", "K1", "K2"]),
    "pool_carry_norm1_unfused": ({"per_layer_fuse": {"norm1": False},
                                 "per_layer_pool_carry": {"conv1": True}},
                                ["K5", "K1", "K2"]),
    "lrn_oc_block": ({"per_layer_lrn_oc_block": {"conv2": True}},
                     ["K1", "K4", "K2"]),
    "oc_block_final": ({"per_layer_oc_block_final": {"conv5": 8}},
                       ["K1", "K1", "K6"]),
}


@pytest.mark.parametrize("knobs,name,batch",
                         [(k, "alexnet_narrow", 2) for k in sorted(KNOB_SETS)]
                         + [("tuned", "alexnet", 1)])
def test_cell_knobs_forward_matches_jax(knobs, name, batch):
    """AlexNet under each knob set (narrowed, batch 2; the tuned set also
    at full width, batch 1) against the JAX engine under the same knobs
    (its jitted jnp path): the groups resolve to the cells the set asks
    for, and the forward agrees to 1e-4 with the same argmax."""
    kn, cells = KNOB_SETS[knobs]
    jnet, tnet = _nets(jnetdefs)[name], _nets(tnetdefs)[name]
    params = he_params(infer_param_shapes(tnet), seed=11)
    x = np.random.default_rng(batch).standard_normal(
        (batch, *tnet.input_shape)).astype(np.float32)
    theirs = np.asarray(JEngine(jnet, **kn).jit_forward()(
        _jax_tree(params), jnp.asarray(x)))
    eng = CNNEngine(tnet, device="cpu", **kn)
    assert [r["cell"] for r in eng.fusion_report()] == cells
    ours = eng.forward(params_from_numpy(params, "cpu"), x).numpy()
    assert ours.shape == theirs.shape == (batch, tnet.num_classes)
    assert np.abs(ours - theirs).max() <= TOL
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))


def _report_keys(report):
    return [(r["group"], r["convs"], list(r["out_hw"])) for r in report]


@pytest.mark.parametrize("name", ["lenet5", "cifar10", "alexnet",
                                  "alexnet_narrow"])
@pytest.mark.parametrize("method", [m.value for m in Method])
@pytest.mark.parametrize("fuse", [True, False])
def test_fusion_report_matches_jax(name, method, fuse):
    jeng = JEngine(_nets(jnetdefs)[name], method=JMethod(method),
                   fuse_pool=fuse)
    teng = CNNEngine(_nets(tnetdefs)[name], method=Method(method),
                     fuse_pool=fuse, device="cpu")
    report = teng.fusion_report()
    assert _report_keys(report) == _report_keys(jeng.fusion_report())
    # default plans keep the first-generation cells
    want = {"basic_simd": {"K7", "K2"}}.get(method, {"K1", "K2"})
    assert {r["cell"] for r in report} <= want
    for r in report:
        assert r["rows_per_cell"] * r["n_tiles"] >= r["out_hw"][0]
        assert (r["rows_per_cell"] * (r["n_tiles"] - 1) < r["out_hw"][0])


@pytest.mark.parametrize("knobs", sorted(KNOB_SETS))
def test_tuned_fusion_report_matches_jax(knobs):
    kn, cells = KNOB_SETS[knobs]
    jrep = JEngine(jnetdefs.alexnet(), **kn).fusion_report()
    teng = CNNEngine(tnetdefs.alexnet(), device="cpu", **kn)
    report = teng.fusion_report()
    assert _report_keys(report) == _report_keys(jrep)
    assert [r["cell"] for r in report] == cells
    # K6 reads the knob as "block the final stage", no narrower than asked
    if "K6" in cells:
        assert report[-1]["oc_block"] >= 8


def test_unfused_forward_and_collect_match_jax():
    jnet, tnet = jnetdefs.cifar10_quick(), tnetdefs.cifar10_quick()
    params = he_params(infer_param_shapes(tnet), seed=3)
    x = np.random.default_rng(3).standard_normal(
        (2, *tnet.input_shape)).astype(np.float32)

    def jax_collect(p, x):
        acts = {}
        JEngine(jnet).forward(p, x, collect=acts)
        return acts

    j_acts = jax.jit(jax_collect)(_jax_tree(params), jnp.asarray(x))
    t_acts = {}
    CNNEngine(tnet, device="cpu").forward(params_from_numpy(params, "cpu"),
                                          x, collect=t_acts)
    assert set(t_acts) == set(j_acts)
    for k in j_acts:
        assert np.abs(t_acts[k].numpy() - np.asarray(j_acts[k])).max() <= TOL


@pytest.mark.parametrize("name", ["lenet5", "cifar10", "alexnet",
                                  "alexnet_narrow"])
@pytest.mark.parametrize("fuse", [True, False])
def test_plan_matches_jax(name, fuse):
    jplan = JEngine(_nets(jnetdefs)[name]).plan(fuse)
    tplan = CNNEngine(_nets(tnetdefs)[name], device="cpu").plan(fuse)
    assert fusion_summary(tplan) == jax_fusion_summary(jplan)

    def sig(plan):
        return [(s.kind, s.names, tuple(s.in_shape), tuple(s.out_shape),
                 s.method.value if s.method is not None else None, s.relu)
                for s in plan.steps]

    assert sig(tplan) == sig(jplan)


def test_netdefs_copy_matches_jax():
    for name in jnetdefs.NETWORKS:
        assert (dataclasses.asdict(tnetdefs.NETWORKS[name]())
                == dataclasses.asdict(jnetdefs.NETWORKS[name]()))


def test_knob_assignment_recompiles_the_plan():
    eng = CNNEngine(tnetdefs.alexnet(), device="cpu")
    p0 = eng.plan()
    assert eng.plan() is p0  # memoized
    eng.method = Method.ADVANCED_SIMD_8  # same value: keeps the plan
    assert eng.plan() is p0
    eng.per_layer_fuse["norm1"] = False
    assert ("conv1", "pool1") in fusion_summary(eng.plan())
    eng.per_layer_methods = {"conv5": Method.ADVANCED_SIMD_4}
    assert ("conv3", "conv4") in fusion_summary(eng.plan())
    eng.fuse_pool = False
    assert fusion_summary(eng.plan()) == []


def test_init_is_seeded_and_sized():
    eng = CNNEngine(tnetdefs.lenet5(), device="cpu")
    a = eng.init(torch.Generator().manual_seed(5))
    b = eng.init(torch.Generator().manual_seed(5))
    for name, shp in infer_param_shapes(eng.net).items():
        assert tuple(a[name]["w"].shape) == shp
        assert torch.equal(a[name]["w"], b[name]["w"])
    y = eng.forward(a, torch.zeros((1, 1, 28, 28)))
    assert torch.allclose(y.sum(-1), torch.ones(1))


# -- batch buckets (the serving path) ---------------------------------------------


def test_batch_bucket_rounding():
    assert [CNNEngine.batch_bucket(n) for n in range(1, 10)] == \
        [1, 2, 4, 4, 8, 8, 8, 8, 16]
    assert [CNNEngine.batch_bucket(n) for n in range(1, 10)] == \
        [JEngine.batch_bucket(n) for n in range(1, 10)]
    with pytest.raises(ValueError):
        CNNEngine.batch_bucket(0)


def test_bucketed_cache_compile_bound():
    """Batch sizes 1..max_batch cost at most log2(max_batch)+1 bucket
    entries, repeats add none, a knob change clears them, and the padded
    rows never leak into the sliced-back outputs."""
    max_batch = 8
    net = tnetdefs.lenet5()
    eng = CNNEngine(net, device="cpu")
    params = eng.init()
    xs = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (max_batch, *net.input_shape)).astype(np.float32))
    for n in range(1, max_batch + 1):
        assert eng.forward_batched(params, xs[:n]).shape == (
            n, net.num_classes)
    stats = eng.bucket_stats()
    assert stats["compiles"] <= max_batch.bit_length()  # log2(8)+1 = 4
    assert stats["buckets"] == [(True, 1), (True, 2), (True, 4), (True, 8)]
    for n in range(1, max_batch + 1):
        eng.forward_batched(params, xs[:n])
    assert eng.bucket_stats()["compiles"] == stats["compiles"]
    eng.forward_batched(params, xs[:3], fuse=False)
    assert eng.bucket_stats()["buckets"][0] == (False, 4)
    eng.method = Method.BASIC_SIMD      # a knob change drops the buckets
    assert eng.bucket_stats() == {"buckets": [], "compiles": 0}
    eng.method = Method.ADVANCED_SIMD_8
    a = eng.forward_batched(params, xs[:3])   # bucket 4, one zero pad row
    b = eng.forward_batched(params, xs[:4])   # bucket 4, no pad
    assert torch.equal(a, b[:3])
    eager = eng.forward(params, xs[:3])
    assert (a - eager).abs().max() < 1e-5


@pytest.mark.parametrize("method", [m.value for m in Method])
@pytest.mark.parametrize("fuse", [True, False])
def test_rows_are_bitwise_independent_of_batchmates(method, fuse):
    """At a fixed bucket, a frame's output row has the same bits whatever
    the other rows hold and whichever row it rides in: the CPU plain path
    (torch CPU GEMMs and convolutions at a fixed shape) as the kernels on
    the card.  Bisection survivors and pad rows rely on it."""
    net = tnetdefs.cifar10_quick()
    eng = CNNEngine(net, method=Method(method), fuse_pool=fuse,
                    device="cpu")
    params = eng.init()
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.standard_normal(
        (8, *net.input_shape)).astype(np.float32))
    base = eng.forward_batched(params, xs[:4])
    others = torch.from_numpy(rng.standard_normal(
        (3, *net.input_shape)).astype(np.float32))
    for pos in range(4):
        batch = torch.cat([others[:pos], xs[:1], others[pos:]])
        assert torch.equal(eng.forward_batched(params, batch)[pos], base[0])
    # zero pad rows are batchmates too: 3 real rows in bucket 4
    assert torch.equal(eng.forward_batched(params, xs[:3]), base[:3])


# -- verify and switch_verified ------------------------------------------------------


@pytest.mark.parametrize("name", ["lenet5", "cifar10", "alexnet"])
def test_verify_is_clean_on_every_rung(name):
    net = _nets(tnetdefs)[name]
    for method in Method:
        for fuse in (True, False):
            eng = CNNEngine(net, method=method, fuse_pool=fuse, device="cpu")
            assert eng.verify() == [], (method, fuse)


def test_verifier_catches_seeded_shape_faults():
    """Each V1xx rule fires on a plan corrupted to break it (the JAX
    verifier's mutation cases)."""
    from repro_torch.analysis.findings import RULES, Finding
    from repro_torch.analysis.verifier import verify_plan

    eng = CNNEngine(tnetdefs.alexnet(), fuse_pool=False, device="cpu")
    plan = eng.plan()
    conv1 = plan.steps[0]

    def rules(steps):
        return {f.rule for f in verify_plan(dataclasses.replace(
            plan, steps=tuple(steps))) if f.severity == "error"}

    bad_out = dataclasses.replace(conv1, out_shape=(96, 54, 55))
    assert rules([bad_out, *plan.steps[1:]]) >= {"V101", "V102"}
    bad_in = dataclasses.replace(plan.steps[1], in_shape=(95, 55, 55))
    assert "V102" in rules([conv1, bad_in, *plan.steps[2:]])
    bad_spec = dataclasses.replace(
        conv1, spec=dataclasses.replace(conv1.spec, kernel=(9, 9)),
        out_shape=(96, 55, 55))
    assert "V103" in rules([bad_spec, *plan.steps[1:]])
    fc = next(i for i, st in enumerate(plan.steps) if st.kind == "fc")
    steps = list(plan.steps)
    steps[fc] = dataclasses.replace(steps[fc], d_in=9215)
    assert rules(steps) == {"V103"}
    assert {r for r in RULES if r.startswith("V1")} == {"V101", "V102",
                                                        "V103"}
    with pytest.raises(ValueError, match="unknown rule"):
        Finding("error", "plan", "V204", "a TPU rule")


def test_switch_verified_applies_or_rolls_back(monkeypatch):
    eng = CNNEngine(tnetdefs.alexnet(), device="cpu")
    ok, findings = eng.switch_verified(method=Method.BASIC_SIMD,
                                       per_layer_fuse={"norm1": False})
    assert ok and findings == []
    assert eng.method == Method.BASIC_SIMD
    assert ("conv1", "pool1") in fusion_summary(eng.plan())
    from repro_torch.analysis.findings import Finding

    monkeypatch.setattr(CNNEngine, "verify",
                        lambda self, fuse=None, batches=None: [
        Finding("error", "plan", "V102", "injected")])
    ok, findings = eng.switch_verified(method=Method.ADVANCED_SIMD_4,
                                       fuse_pool=False,
                                       per_layer_fuse={})
    assert not ok and [f.rule for f in findings] == ["V102"]
    assert eng.method == Method.BASIC_SIMD and eng.fuse_pool is True
    assert dict(eng.per_layer_fuse) == {"norm1": False}   # rolled back
    assert set(CNNEngine.KNOBS) < set(JEngine.KNOBS)


# -- the device rule ---------------------------------------------------------------


def test_no_device_means_cuda_and_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CNNEngine(tnetdefs.lenet5())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy({})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert CNNEngine(tnetdefs.lenet5()).device.type == "cuda"


def test_unfused_pool_raises_off_cpu():
    # K9 is ported: an unfused plan's pool reaches the pool2d wrapper,
    # which refuses a tensor that lies on neither the CPU nor a GPU
    from repro_torch.core.plan import _pool

    spec = tnetdefs.lenet5().layers[1]
    with pytest.raises(ValueError, match="pool2d: unsupported device"):
        _pool(torch.empty((1, 2, 4, 4), device="meta"), spec)


# -- deploy: JAX writes, the port loads ---------------------------------------


def _saved(tmp_path, name="lenet5"):
    jnet = jnetdefs.NETWORKS[name]()
    params = he_params(infer_param_shapes(tnetdefs.NETWORKS[name]()), seed=9)
    jdeploy.save_model(tmp_path, jnet, _jax_tree(params), extra={"v": 1})
    return jnet, params


def test_load_model_reads_jax_artifact(tmp_path):
    jnet, params = _saved(tmp_path)
    net, tparams, extra = load_model(tmp_path, device="cpu")
    assert extra == {"v": 1}
    assert dataclasses.asdict(net) == dataclasses.asdict(jnet)
    x = np.random.default_rng(0).standard_normal(
        (2, *net.input_shape)).astype(np.float32)
    theirs = np.asarray(JEngine(jnet).jit_forward()(_jax_tree(params),
                                                     jnp.asarray(x)))
    ours = CNNEngine(net, device="cpu").forward(tparams, x).numpy()
    assert np.abs(ours - theirs).max() <= TOL


def test_load_model_rejects_tampering(tmp_path):
    _saved(tmp_path)
    mpath = tmp_path / "manifest.json"
    good = mpath.read_text()
    m = json.loads(good)
    m["weights_sha256"] = "0" * 64
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="checksum"):
        load_model(tmp_path, device="cpu")
    m = json.loads(good)
    m["tensors"]["conv1/w"]["dtype"] = "float16"
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="dtype"):
        load_model(tmp_path, device="cpu")
    m = json.loads(good)
    m["network"]["layers"][0]["out_channels"] = 21
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="geometry"):
        load_model(tmp_path, device="cpu")


# -- band geometry of the CUDA conv kernels ---------------------------------------


def _emulate_bands(x, ws, bs, strides, pads, relus, pool, blk):
    """What a band kernel (K1, K7: one stage) computes, band by band, in
    plain PyTorch, here over chains of stages too: each block runs every
    stage only on the rows ``band_rows`` gives it,
    reading rows outside the previous stage's valid output as zeros, then
    pools its final rows.  Must equal the whole-frame plain version."""
    stages = conv_ops.make_stages(tuple(x.shape[1:]), ws, strides, pads,
                                  relus)
    total, out_h, out_w = conv_ops.final_rows(stages, pool)
    out = torch.zeros((x.shape[0], stages[-1].OC, out_h, out_w))
    for t in range(math.ceil(total / blk)):
        rows = conv_ops.band_rows(stages, pool, blk, t)
        band, row0 = x, 0  # stage input rows held, global row of row 0
        for st, w, b, (a, bb) in zip(stages, ws, bs, rows):
            lo, hi = a * st.sy - st.py, (bb - 1) * st.sy - st.py + st.KH
            slab = torch.zeros((x.shape[0], st.C, hi - lo, st.W))
            for gy in range(max(lo, 0), min(hi, st.H)):
                # a row the stage reads inside its input must be held
                assert row0 <= gy < row0 + band.shape[2]
                slab[:, :, gy - lo] = band[:, :, gy - row0]
            band = conv_ops.conv2d_pool_fused_ref(
                slab, w, b, (st.sy, st.sx), (0, st.px), st.relu)
            assert band.shape[2] == bb - a
            row0 = a
        f0, f1 = t * blk, min((t + 1) * blk, total)
        if pool is not None:
            band = pool_lrn_tail(band, (pool.kh, pool.kw), (pool.sy, pool.sx),
                                 pool.kind)
        out[:, :, f0:f1] = band
    return out


@pytest.mark.parametrize("blk", [1, 2, 4])
@pytest.mark.parametrize("pooled", [True, False])
def test_band_rows_cover_what_each_stage_reads(blk, pooled):
    rng = np.random.default_rng(blk)
    x = torch.from_numpy(rng.standard_normal((1, 3, 13, 12)).astype(
        np.float32))
    specs = [(6, 3, 1, 1), (5, 5, 2, 2), (4, 3, 1, 1)]
    ws, bs, c = [], [], 3
    for oc, k, _, _ in specs:
        ws.append(torch.from_numpy(rng.standard_normal((oc, c, k, k))
                                   .astype(np.float32)))
        bs.append(torch.from_numpy(np.full(oc, 0.5, np.float32)))
        c = oc
    strides = [(s, s) for _, _, s, _ in specs]
    pads = [(p, p) for *_, p in specs]
    pool = conv_ops.Pool(2, 2, 1, 1, "max") if pooled else None
    ours = _emulate_bands(x, ws, bs, strides, pads, [True] * 3, pool, blk)
    ref = conv_ops.conv2d_chain_ref(
        x, ws, bs, strides, pads, [True] * 3,
        pool_kernel=(2, 2) if pooled else None, pool_stride=(1, 1))
    assert torch.allclose(ours, ref, atol=1e-4)


def test_alexnet_geometry_fits_the_card():
    pool = conv_ops.Pool(3, 3, 2, 2, "max")
    groups = [((3, 227, 227), [(96, 3, 11, 11)], [(4, 4)], [(0, 0)]),
              ((96, 27, 27), [(256, 96, 5, 5)], [(1, 1)], [(2, 2)])]
    for n in (1, 16):
        for in_chw, ws, s, p in groups:
            # K1's groups: one stage of the stage-major schedule, its
            # scratch in L2, its LRN tail's channels in shared memory
            st = conv_ops.make_stages(in_chw, ws, s, p, [True])
            plan = conv_ops.chain_plan(st, pool, n, 132)
            assert plan.grid == conv_ops.CH_MIN_BLOCKS * 132
            assert 4 * plan.scratch <= 50e6
            assert st[0].OC <= conv_ops.CH_SMEM // 4
            assert plan.barriers == (2 if plan.stages[0].whole else 3)
        chain = conv_ops.make_stages(
            (256, 13, 13), [(384, 256, 3, 3), (384, 384, 3, 3),
                            (256, 384, 3, 3)], [(1, 1)] * 3, [(1, 1)] * 3,
            [True] * 3)
        # the stage-major chain (K2): one cooperative grid of co-resident
        # blocks, every stage's items spread over it, scratch in L2
        for ocb in (None, conv_ops.k6_ocb(8)):
            plan = conv_ops.chain_plan(chain, pool, n, 132, ocb)
            assert plan.grid == conv_ops.CH_MIN_BLOCKS * 132
            assert 4 * plan.scratch <= 50e6  # scratch stays in L2
            assert min(sp.items for sp in plan.stages) >= 72
            assert plan.barriers == 7 and plan.tail_items == n * 36
        geo, lrn = conv_ops.pack_geo(n, chain, pool, False, None, 6)
        assert geo.shape == (14 + 13 * 3,) and lrn.shape == (3,)
        assert len(conv_ops.pack_chain_plan(plan)) == 2 + 3 * 3


# -- the port imports nothing of JAX ----------------------------------------------


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_chip_smoke_fails_without_a_gpu():
    """Here there is no CUDA device: the smoke must exit non-zero and
    print no result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)

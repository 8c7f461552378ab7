"""The port's plan verifier (``repro_torch.analysis.verifier``) on the CPU.

The bundled nets verify clean at every method and fuse setting;
``compile_plan`` verifies by default; each geometry rule fires alone on a
launch geometry broken by patching the launch function that computes it
(the verifier reads the wrappers' own geometry functions, so a patched
function is what a wrapper would launch); severities follow the pinned
knobs; findings are structured; deployment, the engine and the server
verify at their buckets; and the shape-flow findings equal the JAX
verifier's on the same netdefs.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.analysis import verifier as jverifier
from repro.core import netdefs as jnetdefs
from repro.core.methods import Method as JMethod
from repro.core.plan import compile_plan as jcompile_plan
from repro_torch.analysis import verifier
from repro_torch.analysis.findings import (RULES, Finding,
                                           PlanVerificationError,
                                           findings_json, findings_markdown)
from repro_torch.core import deploy, netdefs
from repro_torch.core.engine import CNNEngine
from repro_torch.core.methods import Method
from repro_torch.core.plan import compile_plan
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.pool2d import ops as pool_ops
from repro_torch.serving.cnn import CNNServer
from repro_torch.tools.verify_sweep import TUNED

NETS = ("alexnet", "cifar10", "lenet5")


@pytest.fixture
def fresh():
    """The verifier's and the wrappers' memos emptied before and after a
    test that patches a launch function."""
    verifier.clear_caches()
    yield
    verifier.clear_caches()


def rules_of(findings):
    return {f.rule for f in findings}


def _plan(name="alexnet", method=Method.ADVANCED_SIMD_8, fuse=True, **knobs):
    return compile_plan(netdefs.NETWORKS[name](), method=method, fuse=fuse,
                        verify=False, **knobs)


# -- the bundled grid --------------------------------------------------------


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("method", list(Method), ids=lambda m: m.value)
@pytest.mark.parametrize("name", NETS)
def test_bundled_nets_verify_clean(name, method, fuse):
    """Every bundled net, method and fuse setting verifies without a
    finding at batches 1-16 on 132 SMs, and every conv and pool step of a
    kernel method has a launch geometry."""
    plan = _plan(name, method, fuse)
    assert verifier.verify_plan(plan, batches=range(1, 17)) == []
    for step in plan.steps:
        got = verifier.step_launch_geometry(plan, step, 16, 132)
        kernel = step.kind in ("fused", "chain", "pool") or (
            step.kind == "conv" and method != Method.SEQ_REF)
        assert (got is not None) == kernel


def test_tuned_deployment_verifies_clean():
    plan = _plan(**TUNED)
    cells = {verifier.step_launch_geometry(plan, s, 1, 132)[0]
             for s in plan.steps if s.kind in ("fused", "chain")}
    assert cells == {"K4", "K5", "K6"}
    assert verifier.verify_plan(plan, batches=range(1, 17)) == []


def test_geometry_is_what_the_wrapper_launches():
    """``step_launch_geometry`` hands back the wrappers' memo entries: the
    same objects ``chain_launch``, ``k7_launch`` and ``k8_launch`` return
    for the shapes the wrappers pass."""
    plan = _plan()
    kid, launch = verifier.step_launch_geometry(plan, plan.steps[0], 4, 132)
    assert kid == "K1" and launch.fn == "chain_launch"
    assert launch.geometry is conv_ops.chain_launch(*launch.args)
    assert launch.args[:2] == (4, (3, 227, 227))
    simd = _plan(method=Method.BASIC_SIMD)
    kid, launch = verifier.step_launch_geometry(simd, simd.steps[0], 2, 132)
    # K7's channels are padded to K7_ALIGN, as the wrapper pads the tensors
    assert kid == "K7" and launch.args[1] == (4, 227, 227)
    assert launch.geometry is conv_ops.k7_launch(*launch.args)
    par = _plan(method=Method.BASIC_PARALLEL)
    kid, launch = verifier.step_launch_geometry(par, par.steps[0], 2, 132)
    assert kid == "K8" and launch.geometry is conv_ops.k8_launch(*launch.args)
    pool = next(s for s in par.steps if s.kind == "pool")
    kid, launch = verifier.step_launch_geometry(par, pool, 2, 132)
    assert kid == "K9" and launch.geometry[2] == pool_ops.pool_plan(
        2 * pool.in_shape[0], *launch.geometry[:2])


def test_compile_plan_verifies_by_default(fresh, monkeypatch):
    """A geometry that busts raises ``PlanVerificationError`` at compile
    time, before anything launches; ``verify=False`` skips the check."""
    net = netdefs.NETWORKS["alexnet"]()
    monkeypatch.setattr(conv_ops, "CH_MIN_BLOCKS", 4)
    with pytest.raises(PlanVerificationError) as err:
        compile_plan(net)
    assert rules_of(err.value.findings) == {"V304"}
    assert isinstance(err.value, ValueError)
    assert compile_plan(net, verify=False).steps


def test_kernel_larger_than_its_input_raises_at_compile():
    """A 5x5 kernel on a 4x4 input: the port's default check refuses the
    plan with V101 (the JAX package's compile stops with
    ZeroDivisionError in its band geometry)."""
    for mod, compile_ in ((netdefs, compile_plan), (jnetdefs, jcompile_plan)):
        net = mod.NetworkDef("t", (1, 4, 4), 2, (
            mod.LayerSpec("conv", "c1", out_channels=4, kernel=(5, 5)),
            mod.LayerSpec("pool", "p1", kernel=(2, 2), stride=(2, 2)),
            mod.LayerSpec("flatten", "f"),
            mod.LayerSpec("fc", "fc1", out_channels=2)))
        if mod is netdefs:
            with pytest.raises(PlanVerificationError) as err:
                compile_(net)
            assert rules_of(err.value.findings) == {"V101"}
        else:
            with pytest.raises(ZeroDivisionError):
                compile_(net)


# -- each rule alone, on a broken launch geometry ------------------------------


def _replace_stage(plan, s, **fields):
    stages = list(plan.stages)
    stages[s] = stages[s]._replace(**fields)
    return plan._replace(stages=tuple(stages))


def _broken(monkeypatch, case):
    """Patch one launch function; return the plan whose steps reach it."""
    if case == "V201-items":
        real = conv_ops.chain_plan
        monkeypatch.setattr(conv_ops, "chain_plan", lambda *a: _replace_stage(
            real(*a), 0, items=real(*a).stages[0].items - 1))
        return _plan()
    if case == "V201-pool-grid":
        real = pool_ops.pool_plan
        monkeypatch.setattr(pool_ops, "pool_plan", lambda *a: real(
            *a)._replace(blocks=real(*a).blocks - 1))
        return _plan(fuse=False)
    if case == "V203-halo":
        real = conv_ops.k8_halo_rows
        monkeypatch.setattr(conv_ops, "k8_halo_rows", lambda st: real(st) - 1)
        return _plan(method=Method.BASIC_PARALLEL)
    if case == "V203-band":
        real = conv_ops.band_rows

        def short(stages, pool, blk, t):
            rows = real(stages, pool, blk, t)
            return [(a, b - 1) for a, b in rows]
        monkeypatch.setattr(conv_ops, "band_rows", short)
        return _plan()
    if case == "V205-plan":
        real = conv_ops.pack_chain_plan

        def corrupt(plan):
            arr = real(plan).copy()
            arr[2] += 1  # stage 0's unit
            return arr
        monkeypatch.setattr(conv_ops, "pack_chain_plan", corrupt)
        return _plan()
    if case == "V205-geo":
        real = conv_ops.pack_geo

        def corrupt(*a):
            geo, lrn_f = real(*a)
            geo = geo.copy()
            geo[14 + 4] += 1  # stage 0's KH
            return geo, lrn_f
        monkeypatch.setattr(conv_ops, "pack_geo", corrupt)
        return _plan(method=Method.BASIC_SIMD)
    if case == "V301-k8":
        monkeypatch.setattr(conv_ops, "K8_STAGE_FLOATS", 10 ** 6)
        monkeypatch.setattr(conv_ops, "K7_SMEM_LIMIT", 10 ** 8)
        return _plan(method=Method.BASIC_PARALLEL)
    if case == "V301-lrn":
        monkeypatch.setattr(conv_ops, "CH_SMEM", 4 * 64)
        return _plan()
    if case == "V302-offsets":
        real = conv_ops.chain_plan
        monkeypatch.setattr(conv_ops, "chain_plan", lambda *a: real(
            *a)._replace(scratch=2 ** 31))
        return _plan()
    if case == "V302-limit":
        monkeypatch.setattr(conv_ops, "CH_SCRATCH_LIMIT", 1000)
        return _plan()
    if case == "V303-k7":
        monkeypatch.setattr(conv_ops, "K7_SMEM_LIMIT", 1000)
        return _plan(method=Method.BASIC_SIMD)
    if case == "V303-k6-lrn":
        plan = _plan("alexnet", fuse=True)
        steps = list(plan.steps)
        i = next(i for i, s in enumerate(steps) if s.kind == "fused"
                 and s.kwargs["lrn_n"] is not None)
        # a chain of one conv with conv1's LRN tail and a blocked final
        # stage: K6 with an LRN tail, which no device takes
        s = steps[i]
        steps[i] = dataclasses.replace(
            s, kind="chain", kwargs={
                **{k: v for k, v in s.kwargs.items()
                   if k not in ("pool_carry", "lrn_oc_block")},
                "oc_block_final": 8})
        return dataclasses.replace(plan, steps=tuple(steps))
    if case == "V304":
        monkeypatch.setattr(conv_ops, "CH_MIN_BLOCKS", 4)
        return _plan()
    raise KeyError(case)


CASES = ("V201-items", "V201-pool-grid", "V203-halo", "V203-band",
         "V205-plan", "V205-geo", "V301-k8", "V301-lrn", "V302-offsets",
         "V302-limit", "V303-k7", "V303-k6-lrn", "V304")


@pytest.mark.parametrize("case", CASES)
def test_each_rule_fires_alone(case, fresh, monkeypatch):
    plan = _broken(monkeypatch, case)
    findings = verifier.verify_plan(plan, batches=(1, 16))
    assert rules_of(findings) == {case[:4]}, [str(f) for f in findings]
    assert all(f.severity == "error" for f in findings)
    if case != "V303-k6-lrn":  # a hand-built step: compile never forms it
        with pytest.raises(PlanVerificationError):
            compile_plan(plan.net, method=plan.steps[0].method,
                         fuse=plan.fuse)


def test_chain_items_rule_on_every_batch(fresh, monkeypatch):
    """The coverage walk sees a gap at every batch of the stage-major
    schedule (the unit, and so the items, follow the batch)."""
    _broken(monkeypatch, "V201-items")
    findings = verifier.verify_plan(_plan(), batches=(1, 2, 5, 16))
    for n in (1, 2, 5, 16):
        assert any(f"batch {n}:" in f.detail for f in findings
                   if f.rule == "V201")


# -- severities ------------------------------------------------------------


def test_pinned_knobs_downgrade_budget_rules(fresh, monkeypatch):
    """A V3xx finding of a step whose cell a user pinned is a warning (the
    tuned plan's K4, K5 and K6 steps), of an auto step an error."""
    monkeypatch.setattr(conv_ops, "CH_SCRATCH_LIMIT", 1000)
    tuned = verifier.verify_plan(_plan(**TUNED), batches=(1,))
    assert rules_of(tuned) == {"V302"}
    assert {f.severity for f in tuned} == {"warning"}
    compile_plan(netdefs.NETWORKS["alexnet"](), **TUNED)  # warnings pass
    default = verifier.verify_plan(_plan(), batches=(1,))
    assert {f.severity for f in default} == {"error"}


def test_k6_with_lrn_is_an_error_though_pinned(fresh, monkeypatch):
    plan = _broken(monkeypatch, "V303-k6-lrn")
    findings = verifier.verify_plan(plan, batches=(1,))
    assert [(f.rule, f.severity) for f in findings] == [("V303", "error")]
    assert "LRN" in findings[0].detail


# -- structure -----------------------------------------------------------------


def test_findings_are_structured(fresh, monkeypatch):
    plan = _broken(monkeypatch, "V304")
    findings = verifier.verify_plan(plan, batches=(1, 16))
    assert findings and all(f.rule in RULES for f in findings)
    assert all(f.step.startswith("step") for f in findings)
    rows = json.loads(findings_json(findings))
    assert rows[0].keys() == {"severity", "step", "rule", "detail"}
    assert [Finding(**r) for r in rows] == findings
    md = findings_markdown(findings, title="t")
    assert md.startswith("### t") and md.count("| V304 |") == len(findings)
    assert "No findings." in findings_markdown([])
    with pytest.raises(ValueError):
        Finding("error", "x", "V999", "unknown rule")


def test_rules_cover_the_ported_taxonomy():
    assert {r for r in RULES if r.startswith("V")} == {
        "V101", "V102", "V103", "V201", "V203", "V205", "V301", "V302",
        "V303", "V304"}
    assert {r for r in RULES if r.startswith("R")} == {
        "R001", "R002", "R004", "R005", "R006", "R007", "R008"}


# -- deployment, the engine, the server ----------------------------------------


def _wide_net(lrn: bool):
    """One conv of 16001 channels (one more than the stage-major LRN tail
    holds) on a 4x4 frame: 32 KB of weights."""
    layers = [netdefs.LayerSpec("conv", "c1", out_channels=16001,
                                kernel=(1, 1), relu=True),
              netdefs.LayerSpec("pool", "p1", kernel=(2, 2), stride=(2, 2))]
    if lrn:
        layers.append(netdefs.LayerSpec("lrn", "n1", lrn_n=5))
    layers += [netdefs.LayerSpec("flatten", "f"),
               netdefs.LayerSpec("fc", "fc1", out_channels=2)]
    return netdefs.NetworkDef("wide", (1, 4, 4), 2, tuple(layers))


def test_load_model_refuses_a_tampered_geometry(tmp_path):
    """An artifact whose manifest was edited to add an LRN tail to a
    16001-channel group (no tensor changes, so the checksum holds) fails
    the load: its K1 launch's LRN tail busts the shared memory."""
    net = _wide_net(lrn=False)
    rng = np.random.default_rng(0)
    params = {"c1": {"w": torch.from_numpy(rng.standard_normal(
                  (16001, 1, 1, 1)).astype(np.float32)),
                     "b": torch.zeros(16001)},
              "fc1": {"w": torch.zeros((16001 * 4, 2)),
                      "b": torch.zeros(2)}}
    deploy.save_model(tmp_path, net, params)
    deploy.load_model(tmp_path, device="cpu")  # clean as written
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    lrn = dataclasses.asdict(netdefs.LayerSpec("lrn", "n1", lrn_n=5))
    lrn.update(kernel=list(lrn["kernel"]), stride=list(lrn["stride"]),
               padding=list(lrn["padding"]))
    manifest["network"]["layers"].insert(2, lrn)
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="plan verification failed.*V301"):
        deploy.load_model(tmp_path, device="cpu")


def test_engine_verifies_its_buckets(monkeypatch):
    seen = []
    real = verifier.verify_plan

    def spy(plan, *a, **kw):
        seen.append(kw)
        return real(plan, *a, **kw)

    monkeypatch.setattr(verifier, "verify_plan", spy)
    eng = CNNEngine(netdefs.NETWORKS["lenet5"](), device="cpu")
    assert eng.verify() == [] and eng.sms == 132
    assert seen[-1] == {"batches": (1, 2, 4, 8, 16), "sms": 132}
    assert eng.verify(batches=(3,)) == [] and seen[-1]["batches"] == (3,)
    ok, findings = eng.switch_verified(method=Method.BASIC_SIMD,
                                       batches=(1, 32))
    assert ok and findings == [] and seen[-1]["batches"] == (1, 32)
    CNNServer(eng, eng.init(), max_batch=20)
    assert seen[-1]["batches"] == (1, 2, 4, 8, 16, 32)


def test_engine_and_server_refuse_a_busting_plan(fresh, monkeypatch):
    net = _wide_net(lrn=True)
    eng = CNNEngine(net, device="cpu")
    assert rules_of(eng.verify()) == {"V301"}
    with pytest.raises(PlanVerificationError):
        eng.plan()
    with pytest.raises(PlanVerificationError):
        CNNServer(eng, {}, max_batch=4)
    # unfused, the conv runs per layer and the LRN standalone: clean
    ok, findings = eng.switch_verified(fuse_pool=False)
    assert ok and findings == []


# -- the shape flow equals the JAX verifier's -------------------------------------


def _v1(findings):
    return [(f.severity, f.step, f.rule, f.detail) for f in findings
            if f.rule.startswith("V1")]


def _break_shapes(plan, idx):
    steps = list(plan.steps)
    s = steps[idx]
    steps[idx] = dataclasses.replace(
        s, out_shape=tuple(d + 1 for d in s.out_shape))
    return dataclasses.replace(plan, steps=tuple(steps))


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("name", NETS)
def test_shape_flow_findings_equal_jax(name, fuse):
    """The V1xx findings of both verifiers agree on the bundled nets, and
    on the same plans with one step's output shape broken (every step in
    turn)."""
    ours = _plan(name, Method.ADVANCED_SIMD_8, fuse)
    theirs = jcompile_plan(jnetdefs.NETWORKS[name](),
                           method=JMethod.ADVANCED_SIMD_8, fuse=fuse,
                           use_pallas=False, verify=False)
    assert len(ours.steps) == len(theirs.steps)
    assert _v1(verifier.verify_plan(ours)) == _v1(
        jverifier.verify_plan(theirs)) == []
    for idx in range(len(ours.steps)):
        a = _v1(verifier.verify_plan(_break_shapes(ours, idx)))
        b = _v1(jverifier.verify_plan(_break_shapes(theirs, idx)))
        assert a == b and a

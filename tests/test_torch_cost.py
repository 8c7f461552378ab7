"""The port's cost model, cost-gated fusion, knob space and fit against the
JAX package's, on the CPU.

The port prices its plans as the JAX package prices its jnp path
(``use_pallas=False``: no band overfetch, no VMEM term), so with the same
coefficients ``repro_torch.core.cost.plan_cost`` of a port plan must equal
``repro.core.cost.plan_cost`` of the same knobs: FLOPs by bucket, bytes
and launches exactly, microseconds within 1e-9 relative.  The gate, the
fit, the Spearman metric, the ladder points of the committed
``BENCH_network.json`` and the knob grid are held against JAX's the same
way; the port's committed ``cuda`` model must refit bit for bit from the
rows it records.
"""
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch import overrides as torch_overrides

from repro.core import cost as jcost
from repro.core import netdefs as jnetdefs
from repro.core.fusion import fusion_summary as jfusion_summary
from repro.core.methods import Method as JMethod
from repro.core.plan import compile_plan as jcompile_plan
from repro.core.plan import knob_space as jknob_space
from repro_torch.analysis.verifier import PlanVerificationError
from repro_torch.core import cost as tcost
from repro_torch.core import netdefs as tnetdefs
from repro_torch.core.cost import (FLOP_KEYS, CostModel, fit_coefficients,
                                   fused_flop_key, fusion_cost_gate,
                                   plan_cost, spearman)
from repro_torch.core.fusion import FUSABLE_METHODS, fusion_summary
from repro_torch.core.methods import Method
from repro_torch.core.plan import compile_plan, knob_space
from repro_torch.tools import cost_fit, cost_validate

ROOT = Path(__file__).resolve().parents[1]
NETS = ("lenet5", "cifar10", "alexnet")
FUSABLE = sorted((m.value for m in FUSABLE_METHODS))


def _load_by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jcost_fit = _load_by_path("jax_cost_fit", "benchmarks/cost_fit.py")
jcost_validate = _load_by_path("jax_cost_validate", "tools/cost_validate.py")


def _cpu_models():
    path = ROOT / "COST_MODEL.json"
    return (jcost.CostModel.load(str(path), backend="cpu"),
            CostModel.load(str(path), backend="cpu"))


def _punitive(mod):
    """Both packages' punitive model: fused launches priced at 1e6 us a
    GFLOP, so every group is declined."""
    coeffs = {k: 1.0 for k in mod.FLOP_KEYS}
    for m in ("basic_simd", "advanced_simd_4", "advanced_simd_8"):
        coeffs[f"{m}:fused"] = 1e6
    return mod.CostModel(backend="t", us_per_gflop=coeffs, us_per_gb=1.0,
                         dispatch_us=1.0)


def _models(kind):
    if kind == "unit":
        return None, None
    if kind == "punitive":
        return _punitive(jcost), _punitive(tcost)
    return _cpu_models()


# -- plan_cost ----------------------------------------------------------------


@pytest.mark.parametrize("batch", [1, 8, 16])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("method", [m.value for m in Method])
@pytest.mark.parametrize("name", NETS)
def test_plan_cost_matches_jax(name, method, fuse, batch):
    jm, tm = _cpu_models()
    theirs = jcost.plan_cost(
        jcompile_plan(jnetdefs.NETWORKS[name](), method=JMethod(method),
                      fuse=fuse, use_pallas=False, verify=False), jm, batch)
    ours = plan_cost(compile_plan(tnetdefs.NETWORKS[name](),
                                  method=Method(method), fuse=fuse), tm,
                     batch)
    assert ours.flops_by_key == theirs.flops_by_key
    assert ours.hbm_bytes == theirs.hbm_bytes
    assert ours.dispatches == theirs.dispatches
    assert ours.us == pytest.approx(theirs.us, rel=1e-9)
    assert ([(s.label, s.kind, s.key, s.flops, s.hbm_bytes, s.dispatches)
             for s in ours.steps]
            == [(s.label, s.kind, s.key, s.flops, s.hbm_bytes, s.dispatches)
                for s in theirs.steps])
    for a, b in zip(ours.steps, theirs.steps):
        assert a.us == pytest.approx(b.us, rel=1e-9, abs=1e-12)


def test_plan_cost_of_the_cost_method_and_the_table():
    plan = compile_plan(tnetdefs.NETWORKS["alexnet"]())
    m = _cpu_models()[1]
    assert plan.cost(m, batch=4) == plan_cost(plan, m, batch=4)
    assert plan.cost() == plan_cost(plan)
    table = plan.cost(m, 4).table_markdown()
    assert table.startswith("### Plan cost (batch 4)")
    assert "VMEM" not in table and "conv3+conv4+conv5+pool5" in table


def test_fused_plan_streams_fewer_bytes_and_launches():
    net = tnetdefs.NETWORKS["alexnet"]()
    fused = plan_cost(compile_plan(net, fuse=True), batch=8)
    unfused = plan_cost(compile_plan(net, fuse=False), batch=8)
    assert fused.flops == unfused.flops
    assert fused.hbm_bytes < unfused.hbm_bytes
    assert fused.dispatches < unfused.dispatches
    assert fused_flop_key(Method.ADVANCED_SIMD_8) in fused.flops_by_key


# -- the model's functions ------------------------------------------------------


def test_flop_keys_and_unit_model_match_jax():
    assert FLOP_KEYS == jcost.FLOP_KEYS
    assert CostModel.unit().to_dict() == jcost.CostModel.unit().to_dict()
    assert CostModel.unit().predict({"fc": 1e9}, 1e9, 1) == pytest.approx(3.0)
    m = CostModel(backend="t", us_per_gflop={"other": 7.0}, us_per_gb=0.0,
                  dispatch_us=0.0)
    assert m.predict({"mystery": 1e9}, 0.0, 0) == pytest.approx(7.0)


def test_load_round_trips_and_falls_back_as_jax(tmp_path):
    m = CostModel(backend="cpu", us_per_gflop={k: 2.0 for k in FLOP_KEYS},
                  us_per_gb=3.0, dispatch_us=4.0)
    p = tmp_path / "COST_MODEL.json"
    p.write_text(json.dumps({"format_version": 1,
                             "backends": {"cpu": m.to_dict()}}))
    for backend in ("cpu", "tpu", "cuda"):
        ours = CostModel.load(str(p), backend=backend)
        theirs = jcost.CostModel.load(str(p), backend=backend)
        assert ours.to_dict() == theirs.to_dict()
        assert ours.backend == theirs.backend == "cpu"
        assert ours.fallback_from == theirs.fallback_from
    assert CostModel.load(str(p), backend="cuda").fallback_from == "cuda"
    borrowed = plan_cost(compile_plan(tnetdefs.NETWORKS["lenet5"]()),
                         CostModel.load(str(p), backend="cuda"), batch=2)
    assert borrowed.model_fallback_from == "cuda"
    assert "cross-backend fallback" in borrowed.table_markdown()


def test_load_raises_on_an_unreadable_file(tmp_path):
    with pytest.raises(OSError):
        CostModel.load(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(json.JSONDecodeError):
        CostModel.load(str(bad))


SPEARMAN_CASES = [
    ([1, 2, 3, 4], [10, 20, 30, 40]),
    ([1, 2, 3, 4], [40, 30, 20, 10]),
    ([1, 2, 3, 4], [1, 100, 1e4, 1e8]),
    ([1.0], [2.0]),
    ([1, 2, 3], [5, 5, 5]),
    ([1, 2, 2, 3], [1, 2, 2, 3]),
    ([3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]),
]


@pytest.mark.parametrize("xs,ys", SPEARMAN_CASES)
def test_spearman_matches_jax(xs, ys):
    assert spearman(xs, ys) == jcost.spearman(xs, ys)


def test_spearman_length_mismatch_raises():
    with pytest.raises(ValueError):
        spearman([1, 2], [1, 2, 3])


def _synthetic_rows():
    rows = []
    feats = [(1e9, 0.0, 1e9, 3), (0.0, 2e9, 2e9, 5), (3e9, 1e9, 0.5e9, 2),
             (2e9, 2e9, 4e9, 8), (5e9, 0.5e9, 1e9, 1), (0.5e9, 4e9, 3e9, 6)]
    for fa, fb, hbm, d in feats:
        us = 120.0 * fa * 1e-9 + 40.0 * fb * 1e-9 + 10.0 * hbm * 1e-9 + 2 * d
        rows.append({"flops_by_key": {"basic_simd": fa,
                                      "advanced_simd_8": fb},
                     "hbm_bytes": hbm, "dispatches": d, "us": us})
    # an inconsistent system plain lstsq solves with a negative coefficient
    inconsistent = [
        {"flops_by_key": {"basic_simd": 1e9, "advanced_simd_8": 1e9},
         "hbm_bytes": 1e9, "dispatches": 1, "us": 100.0},
        {"flops_by_key": {"basic_simd": 2e9, "advanced_simd_8": 2e9},
         "hbm_bytes": 2e9, "dispatches": 2, "us": 180.0},
        {"flops_by_key": {"basic_simd": 1e9, "advanced_simd_8": 3e9},
         "hbm_bytes": 1e9, "dispatches": 4, "us": 90.0},
    ]
    bench = json.loads((ROOT / "BENCH_network.json").read_text())
    ladder = [{**p, "flops_by_key": p["fit_flops_by_key"]}
              for p in cost_fit.ladder_points(bench)]
    return {"synthetic": rows, "inconsistent": inconsistent,
            "ladder": ladder}


@pytest.mark.parametrize("case", ["synthetic", "inconsistent", "ladder"])
def test_fit_coefficients_matches_jax(case):
    rows = _synthetic_rows()[case]
    ours = fit_coefficients(rows, backend="t")
    theirs = jcost.fit_coefficients(rows, backend="t")
    assert ours.to_dict() == theirs.to_dict()
    assert all(v >= 0 for v in ours.us_per_gflop.values())
    assert ours.us_per_gb >= 0 and ours.dispatch_us >= 0
    if case == "synthetic":
        assert ours.us_per_gflop["basic_simd"] == pytest.approx(120.0)
        assert ours.dispatch_us == pytest.approx(2.0)


# -- the gate -----------------------------------------------------------------


def _obf(plan):
    return [it.oc_block_final for it in plan if hasattr(it, "convs")]


@pytest.mark.parametrize("model", ["unit", "punitive", "cpu"])
@pytest.mark.parametrize("batch", [1, 8, 16])
@pytest.mark.parametrize("method", FUSABLE)
@pytest.mark.parametrize("name", NETS)
def test_cost_gate_matches_jax(name, method, batch, model):
    jm, tm = _models(model)
    theirs = jcompile_plan(
        jnetdefs.NETWORKS[name](), method=JMethod(method), fuse=True,
        use_pallas=False, verify=False,
        cost_gate=jcost.fusion_cost_gate(jm, batch=batch))
    ours = compile_plan(tnetdefs.NETWORKS[name](), method=Method(method),
                        fuse=True, cost_gate=fusion_cost_gate(tm, batch=batch))
    assert fusion_summary(ours) == jfusion_summary(theirs)
    assert _obf(ours) == _obf(theirs)
    assert [s.kind for s in ours.steps] == [s.kind for s in theirs.steps]
    if model == "punitive":
        assert fusion_summary(ours) == []


@pytest.mark.parametrize("batch", [1, 16])
@pytest.mark.parametrize("name", NETS)
def test_gate_decisions_match_jax_group_by_group(name, batch):
    """The gate callables themselves, on every group the ungated planner
    forms (and the same group with its LRN tail dropped)."""
    jm, tm = _cpu_models()
    jgate = jcost.fusion_cost_gate(jm, batch=batch)
    tgate = fusion_cost_gate(tm, batch=batch)
    jplan = jcompile_plan(jnetdefs.NETWORKS[name](), use_pallas=False,
                          verify=False)
    tplan = compile_plan(tnetdefs.NETWORKS[name]())
    jsteps = [s for s in jplan.steps if s.kind in ("fused", "chain")]
    tsteps = [s for s in tplan.steps if s.kind in ("fused", "chain")]
    assert len(jsteps) == len(tsteps) > 0
    for js, ts in zip(jsteps, tsteps):
        for m in FUSABLE:
            for drop_lrn in (False, True):
                jg = dataclasses.replace(js.group, lrn=None) if drop_lrn \
                    else js.group
                tg = dataclasses.replace(ts.group, lrn=None) if drop_lrn \
                    else ts.group
                assert (tgate(tg, Method(m), ts.in_shape)
                        == jgate(jg, JMethod(m), js.in_shape))


def test_no_gate_forms_todays_groups():
    for name in NETS:
        net = tnetdefs.NETWORKS[name]()
        for m in FUSABLE:
            assert (fusion_summary(compile_plan(net, method=Method(m)))
                    == fusion_summary(compile_plan(net, method=Method(m),
                                                   cost_gate=None)))


def test_chain_rung_blocks_the_final_stage_as_jax():
    """A gate that declines full-width chains but admits an oc-blocked
    one: both planners take the chain rung (``oc_block_final``) before
    they shorten the chain, and the port's chain then runs on K6."""
    def gate(group, method, in_shape):
        return len(group.convs) == 1 or group.oc_block_final is not None

    for m in FUSABLE:
        theirs = jcompile_plan(jnetdefs.NETWORKS["alexnet"](),
                               method=JMethod(m), use_pallas=False,
                               verify=False, cost_gate=gate)
        ours = compile_plan(tnetdefs.NETWORKS["alexnet"](), method=Method(m),
                            cost_gate=gate)
        assert fusion_summary(ours) == jfusion_summary(theirs)
        assert _obf(ours) == _obf(theirs) == [None, None,
                                              8 if m != "advanced_simd_4"
                                              else 4]
        assert ours.fusion_report()[-1]["cell"] == "K6"


def test_chain_shortens_when_every_rung_is_declined():
    """A gate that admits only groups of at most two convs: the chain
    loses conv5 and pool5 (which re-enter the scan), as in JAX."""
    def gate(group, method, in_shape):
        return len(group.convs) <= 2 and group.oc_block_final is None

    theirs = jcompile_plan(jnetdefs.NETWORKS["alexnet"](), use_pallas=False,
                           verify=False, cost_gate=gate)
    ours = compile_plan(tnetdefs.NETWORKS["alexnet"](), cost_gate=gate)
    assert fusion_summary(ours) == jfusion_summary(theirs)
    assert ("conv3", "conv4") in fusion_summary(ours)
    assert ("conv5", "pool5") in fusion_summary(ours)


# -- knob space, verify ----------------------------------------------------------


def _values(space):
    return {layer: {ax: [getattr(v, "value", v) for v in vals]
                    for ax, vals in axes.items()}
            for layer, axes in space.items()}


@pytest.mark.parametrize("name", NETS)
def test_knob_space_matches_jax(name):
    assert (_values(knob_space(tnetdefs.NETWORKS[name]()))
            == _values(jknob_space(jnetdefs.NETWORKS[name]())))


def _bad_net(nd):
    """A pool larger than the conv output before it: V101 on both sides."""
    return nd.NetworkDef("bad", (1, 4, 4), 2, (
        nd.LayerSpec("conv", "conv1", out_channels=2, kernel=(3, 3)),
        nd.LayerSpec("pool", "pool1", kernel=(3, 3), stride=(1, 1)),
        nd.LayerSpec("flatten", "flat"),
        nd.LayerSpec("fc", "fc1", out_channels=2)))


def test_compile_plan_verify_raises_as_jax():
    with pytest.raises(PlanVerificationError) as ours:
        compile_plan(_bad_net(tnetdefs), fuse=False, verify=True)
    from repro.analysis.findings import PlanVerificationError as JError

    with pytest.raises(JError):
        jcompile_plan(_bad_net(jnetdefs), fuse=False, verify=True)
    assert isinstance(ours.value, ValueError)
    assert {f.rule for f in ours.value.findings} == {"V101"}
    # the default verifies, as JAX's does; verify=False skips the check
    with pytest.raises(PlanVerificationError):
        compile_plan(_bad_net(tnetdefs), fuse=False)
    with pytest.raises(JError):
        jcompile_plan(_bad_net(jnetdefs), fuse=False)
    assert compile_plan(_bad_net(tnetdefs), fuse=False, verify=False).steps


# -- the fit's inputs and the committed model -----------------------------------


def test_ladder_points_match_jax_on_the_committed_bench():
    bench = json.loads((ROOT / "BENCH_network.json").read_text())
    ours = cost_fit.ladder_points(bench)
    theirs = jcost_fit.ladder_points(bench)
    assert len(ours) == len(theirs) == 24
    for a, b in zip(ours, theirs):
        assert a == b


def test_fit_model_matches_jax_on_the_committed_bench():
    bench = json.loads((ROOT / "BENCH_network.json").read_text())
    ours, ours_val = cost_fit.fit_model(bench)
    theirs, theirs_val = jcost_fit.fit_model(bench)
    assert ours.to_dict() == theirs.to_dict()
    assert ours_val == theirs_val
    assert ours.backend == theirs.backend == "cpu"
    assert cost_fit.split_points(cost_fit.ladder_points(bench)) == \
        jcost_fit.split_points(jcost_fit.ladder_points(bench))


def test_validate_matches_jax_on_the_committed_bench():
    bench = json.loads((ROOT / "BENCH_network.json").read_text())
    jm, tm = _cpu_models()
    ours = cost_validate.validate(bench, tm)
    theirs = jcost_validate.validate(bench, jm)
    assert ours["spearman"] == theirs["spearman"]
    assert ours["per_network"] == theirs["per_network"]
    assert [r["id"] for r in ours["rows"]] == [r["id"] for r in theirs["rows"]]
    for a, b in zip(ours["rows"], theirs["rows"]):
        assert a["predicted_us"] == pytest.approx(b["predicted_us"],
                                                  rel=1e-9)
    assert "PASS" in cost_validate.markdown(ours, 0.8, "cpu")


def test_cost_validate_exit_codes(tmp_path, capsys):
    bench = str(ROOT / "BENCH_network.json")
    model = str(ROOT / "COST_MODEL.json")
    assert cost_validate.main([bench, "--model", model]) == 0
    assert cost_validate.main([bench, "--model", model,
                               "--threshold", "1.01"]) == 1
    assert cost_validate.main([bench, "--model", model, "--threshold",
                               "1.01", "--warn-only"]) == 0
    assert cost_validate.main([str(tmp_path / "none.json")]) == 2
    assert cost_validate.main([bench, "--model",
                               str(tmp_path / "none.json")]) == 2
    assert cost_validate.main([bench, "--model", model, "--md"]) == 0
    assert "Cost-model accuracy gate" in capsys.readouterr().out


def test_cost_fit_main_fits_a_bench_file(tmp_path):
    out = tmp_path / "COST_MODEL.json"
    out.write_text(json.dumps({"format_version": 1, "backends": {
        "cuda": {"keep": True}}}))
    assert cost_fit.main([str(ROOT / "BENCH_network.json"),
                          "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert data["backends"]["cuda"] == {"keep": True}
    theirs = json.loads((ROOT / "COST_MODEL.json").read_text())
    assert (data["backends"]["cpu"]["validation"]
            == theirs["backends"]["cpu"]["validation"])
    assert cost_fit.main([str(tmp_path / "none.json")]) == 2
    assert cost_fit.main([]) == 2


def test_measure_ladder_writes_the_bench_schema():
    """Two tiny rows' worth on the CPU: every method, fused where it
    fuses, positive times, and points ``fit_model`` reads."""
    bench = cost_fit.measure_ladder(["lenet5"], batch=1, iters=1,
                                    device="cpu")
    assert bench["backend"] == "cpu" and bench["batch"] == 1
    rows = bench["networks"]["lenet5"]["rows"]
    assert [r["method"] for r in rows] == [m.value for m in Method]
    assert [("fused" in r) for r in rows] == [False, False, True, True, True]
    assert all(r[v]["us_per_call"] > 0 for r in rows
               for v in ("unfused", "fused") if v in r)
    assert len(cost_fit.ladder_points(bench)) == 8


def test_committed_cuda_model_refits_from_its_rows():
    data = json.loads(tcost.DEFAULT_MODEL_PATH.read_text())
    assert data["format_version"] == cost_fit.COST_MODEL_FORMAT_VERSION
    entry = data["backends"]["cuda"]
    model = CostModel.load()
    assert model.backend == "cuda" and model.fallback_from is None
    src = entry["fitted_from"]
    assert src["card"].startswith("NVIDIA") and src["card"].endswith(" W")
    assert src["batch"] == 16 and src["iters"] >= 5
    assert src["nets"] == sorted(NETS)
    ladder = src["ladder"]
    assert len(cost_fit.ladder_points(ladder)) == 24
    refit, validation = cost_fit.fit_model(
        ladder, entry["validation"]["holdout_every"])
    assert refit.to_dict() == model.to_dict()
    assert validation == entry["validation"]


def test_the_tools_import_no_jax():
    """The port's tools, loaded in a fresh interpreter, pull in neither
    JAX nor the JAX package."""
    code = ("import sys; import repro_torch.tools.autotune, "
            "repro_torch.tools.cost_fit, repro_torch.tools.cost_validate; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr


# -- the host term (the port's own resource) -------------------------------------


class _TorchCalls(torch_overrides.TorchFunctionMode):
    """Counts the torch calls that enqueue work: every call but views
    (``__getitem__``), attribute reads and casts that return their
    input."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = getattr(func, "__name__", "")
        if name not in ("__getitem__", "__get__") and not (
                name == "to" and args and out is args[0]):
            self.n += 1
        return out


@pytest.mark.parametrize("name", NETS)
def test_host_ops_of_a_plain_step_are_its_torch_calls(name):
    """``plain_host_ops`` of every plain step of ``SEQ_REF``'s plan (conv,
    fc, LRN, ReLU, softmax) equals the torch calls its executor makes,
    counted while it runs on the CPU; a kernel step counts one wrapper
    call, a flatten none."""
    from repro_torch.core import plan as tplan
    from repro_torch.core.engine import CNNEngine

    net = tnetdefs.NETWORKS[name]()
    params = CNNEngine(net, device="cpu").init(torch.Generator().manual_seed(0))
    for method in (Method.SEQ_REF, Method.ADVANCED_SIMD_8):
        plan = compile_plan(net, method=method, fuse=False)
        x = torch.randn((1, *net.input_shape),
                        generator=torch.Generator().manual_seed(1))
        for step in plan.steps:
            sc = tcost.step_resources(plan, step, 1)
            counter = _TorchCalls()
            with counter:
                x = tplan._EXECUTORS[step.kind](step, params, x)
            plain = step.kind in ("lrn", "relu", "softmax") or (
                method == Method.SEQ_REF and step.kind in ("conv", "fc"))
            if plain:
                assert sc.host_ops == counter.n, (step.names, step.kind)
            elif step.kind == "flatten":
                assert sc.host_ops == 0
            else:
                assert sc.host_ops == tcost.WRAPPER_HOST_OPS


def test_host_term_is_absent_from_the_cpu_model_and_fits_on_a_card():
    """The root ``cpu`` model and the unit model carry no host coefficient
    (``to_dict`` equals JAX's); the ladder points of a card's bench carry
    each plan's host operations and a CPU bench's do not; a fit on rows
    with them recovers their coefficient, non-negative, beside the
    others, and the coefficient round-trips through the file."""
    cpu = CostModel.load(str(ROOT / "COST_MODEL.json"), backend="cpu")
    assert cpu.host_op_us == 0.0 and "host_op_us" not in cpu.to_dict()
    assert CostModel.unit().host_op_us == 0.0
    bench = json.loads((ROOT / "BENCH_network.json").read_text())
    assert all("host_ops" not in p for p in cost_fit.ladder_points(bench))
    card = json.loads(tcost.DEFAULT_MODEL_PATH.read_text())["backends"][
        "cuda"]["fitted_from"]["ladder"]
    pts = cost_fit.ladder_points(card)
    for p in pts:
        net, method, variant = p["id"].split("/")
        plan = compile_plan(tnetdefs.NETWORKS[net](), method=Method(method),
                            fuse=variant == "fused")
        assert p["host_ops"] == plan_cost(plan, batch=16).host_ops > 0
    seq = {p["id"]: p["host_ops"] for p in pts}
    assert seq["alexnet/seq_ref/unfused"] > 10 * seq[
        "alexnet/advanced_simd_8/unfused"]
    rows = [{"flops_by_key": {"fc": 1e9 * (i + 1)}, "hbm_bytes": 0.0,
             "dispatches": 1 + i % 3, "host_ops": 5 + 7 * i,
             "us": 30.0 * (i + 1) + 4.0 * (1 + i % 3) + 25.0 * (5 + 7 * i)}
            for i in range(6)]
    m = fit_coefficients(rows, backend="t")
    assert m.host_op_us == pytest.approx(25.0)
    assert m.dispatch_us == pytest.approx(4.0)
    assert m.us_per_gflop["fc"] == pytest.approx(30.0)
    again = CostModel.from_dict(m.to_dict(), "t")
    assert again == m and again.predict({"fc": 1e9}, 0.0, 1, 2) == \
        pytest.approx(30.0 + 4.0 + 50.0)
    committed = CostModel.load()
    assert committed.host_op_us > 0

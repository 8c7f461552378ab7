"""The port's autotuner and the engine's timing helpers against the JAX
package's, on the CPU.

With the JAX package's ``cpu`` coefficients (the repo root's
``COST_MODEL.json``), ``repro_torch.tools.autotune.tune`` must choose the
knobs and make the decisions of JAX's ``tools/autotune.py`` on its jnp
path (``use_pallas=False``), write an artifact the JAX package reads, and
pass its own round-trip check.  The helpers ``heaviest_conv``,
``conv_layer_fn`` and ``time_forward`` are held against the JAX engine's
on LeNet-5 and the CIFAR-10 net at batch 2.  The smoke's launch
accounting (``plan_launches``) must name what its fixed tables name.
"""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as jdeploy
from repro.core import netdefs as jnetdefs
from repro.core.cost import CostModel as JCostModel
from repro.core.engine import CNNEngine as JEngine
from repro.core.methods import Method as JMethod
from repro_torch.core import deploy
from repro_torch.core import netdefs as tnetdefs
from repro_torch.core.cost import CostModel, plan_cost
from repro_torch.core.deploy import params_from_numpy
from repro_torch.core.engine import CNNEngine
from repro_torch.core.methods import Method
from repro_torch.core.plan import compile_plan, infer_param_shapes
from repro_torch.tools import autotune

ROOT = Path(__file__).resolve().parents[1]
NETS = ("lenet5", "cifar10", "alexnet")
TOL = 1e-5

_spec = importlib.util.spec_from_file_location("jax_autotune",
                                               ROOT / "tools" / "autotune.py")
jautotune = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jautotune)


def _models():
    path = str(ROOT / "COST_MODEL.json")
    return JCostModel.load(path, backend="cpu"), CostModel.load(path,
                                                                "cpu")


def _results(name, batch=8):
    jm, tm = _models()
    return (jautotune.tune(jnetdefs.NETWORKS[name](), jm, batch=batch,
                           use_pallas=False),
            autotune.tune(tnetdefs.NETWORKS[name](), tm, batch=batch))


def _manifest(knobs):
    return json.dumps(deploy.knobs_to_manifest(knobs), sort_keys=True)


# -- tune ------------------------------------------------------------------------


@pytest.mark.parametrize("name", NETS)
def test_tune_matches_jax(name):
    theirs, ours = _results(name)
    assert _manifest(ours["knobs"]) == json.dumps(
        jdeploy.knobs_to_manifest(theirs["knobs"]), sort_keys=True)
    assert ours["decisions"] == theirs["decisions"]
    assert ours["cost"].us == pytest.approx(theirs["cost"].us, rel=1e-9)
    assert ours["default_cost"].us == pytest.approx(
        theirs["default_cost"].us, rel=1e-9)
    assert ours["cost"].us <= ours["default_cost"].us
    for mv in ours["decisions"]:
        assert mv["us_after"] < mv["us_before"]


def test_default_knobs_are_jax_and_compile_to_the_default_plan():
    assert _manifest(autotune.default_knobs()) == json.dumps(
        jdeploy.knobs_to_manifest(jautotune.default_knobs()), sort_keys=True)
    net = tnetdefs.NETWORKS["alexnet"]()
    plan, _ = autotune.score(net, autotune.default_knobs(),
                             CostModel.unit(), 1)
    assert ([s.kind for s in plan.steps]
            == [s.kind for s in compile_plan(net).steps])


def test_score_rejects_a_plan_that_fails_verification():
    net = tnetdefs.NetworkDef("bad", (1, 4, 4), 2, (
        tnetdefs.LayerSpec("conv", "conv1", out_channels=2, kernel=(3, 3)),
        tnetdefs.LayerSpec("pool", "pool1", kernel=(3, 3), stride=(1, 1)),
        tnetdefs.LayerSpec("flatten", "flat"),
        tnetdefs.LayerSpec("fc", "fc1", out_channels=2)))
    assert autotune.score(net, {**autotune.default_knobs(), "fuse": False},
                          CostModel.unit(), 1) == (None, None)


@pytest.mark.parametrize("name", ["lenet5", "alexnet"])
def test_write_and_check_and_jax_reads_the_artifact(name, tmp_path):
    _, ours = _results(name)
    out = tmp_path / f"tuned-{name}"
    assert autotune.write_and_check(ours, _models()[1], str(out)) == 0
    assert deploy.load_tuned_knobs(out) == ours["knobs"]
    theirs = jdeploy.load_tuned_knobs(out)
    assert json.dumps(jdeploy.knobs_to_manifest(theirs), sort_keys=True) \
        == _manifest(ours["knobs"])
    manifest = json.loads((out / "manifest.json").read_text())
    assert manifest["extra"]["autotune"]["modelled_us"] == \
        round(ours["cost"].us, 1)
    # the tuned plan reloads and verifies clean, priced as searched
    knobs = deploy.plan_knobs(deploy.load_tuned_knobs(out))
    plan = compile_plan(tnetdefs.NETWORKS[name](), verify=True, **knobs)
    assert plan_cost(plan, _models()[1], 8).us == pytest.approx(
        ours["cost"].us)


def test_decision_table_renders():
    _, ours = _results("lenet5")
    table = autotune.decision_table(ours, _models()[1])
    assert table.startswith("### Autotune — lenet5")
    assert "| step | kind | method | fused into | pred us |" in table
    assert "default plan" in table and "accepted moves: 2" in table


def test_main_exit_codes(tmp_path, capsys):
    assert autotune.main(["--net", "resnet152"]) == 2
    assert "unknown network" in capsys.readouterr().err
    assert autotune.main(["--model", str(tmp_path / "none.json")]) == 2
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert autotune.main(["--model", str(bad)]) == 2
    model = str(ROOT / "COST_MODEL.json")
    rec = tmp_path / "rec.json"
    assert autotune.main(["--net", "lenet5", "--smoke", "--model", model,
                          "--backend", "cpu", "--json", str(rec),
                          "--out", str(tmp_path / "t")]) == 0
    record = json.loads(rec.read_text())
    assert record["tuned_plan"]["per_layer_methods"] == {
        "conv1": "advanced_simd_4", "conv2": "advanced_simd_4"}


# -- the engine's timing helpers ----------------------------------------------------


def _he(shapes, seed):
    rng = np.random.default_rng(seed)
    return {n: {"w": (rng.standard_normal(s) * np.sqrt(
                2.0 / (np.prod(s[1:]) if len(s) == 4 else s[0]))
                ).astype(np.float32),
                "b": (0.05 * rng.standard_normal(
                    s[0] if len(s) == 4 else s[1])).astype(np.float32)}
            for n, s in shapes.items()}


def _setup(name, batch=2):
    tnet = tnetdefs.NETWORKS[name]()
    params = _he(infer_param_shapes(tnet), seed=3)
    x = np.random.default_rng(4).standard_normal(
        (batch, *tnet.input_shape)).astype(np.float32)
    jparams = {k: {kk: jnp.asarray(v) for kk, v in d.items()}
               for k, d in params.items()}
    return (tnet, jnetdefs.NETWORKS[name](), params_from_numpy(params, "cpu"),
            jparams, x)


@pytest.mark.parametrize("name", ["lenet5", "cifar10"])
def test_heaviest_conv_matches_jax(name):
    tnet, jnet, params, jparams, x = _setup(name)
    ours_name, ours_in = CNNEngine(tnet, device="cpu").heaviest_conv(params,
                                                                     x)
    theirs_name, theirs_in = JEngine(jnet).heaviest_conv(jparams,
                                                         jnp.asarray(x))
    assert ours_name == theirs_name
    assert tuple(ours_in.shape) == tuple(theirs_in.shape)
    np.testing.assert_allclose(ours_in.numpy(), np.asarray(theirs_in),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("method", [m.value for m in Method])
@pytest.mark.parametrize("name", ["lenet5", "cifar10"])
def test_conv_layer_fn_matches_jax(name, method):
    tnet, jnet, params, jparams, _ = _setup(name)
    eng, jeng = CNNEngine(tnet, device="cpu"), JEngine(jnet)
    shapes = infer_param_shapes(tnet)
    rng = np.random.default_rng(5)
    h, w = tnet.input_shape[1:]
    for spec in tnet.layers:
        if spec.kind == "pool":
            h = (h - spec.kernel[0]) // spec.stride[0] + 1
            w = (w - spec.kernel[1]) // spec.stride[1] + 1
        if spec.kind != "conv":
            continue
        x = rng.standard_normal((2, shapes[spec.name][1], h, w)
                                ).astype(np.float32)
        ours = eng.conv_layer_fn(spec.name, Method(method),
                                 oh_block=4)(params, x)
        theirs = jeng.conv_layer_fn(spec.name, JMethod(method))(
            jparams, jnp.asarray(x))
        assert tuple(ours.shape) == tuple(theirs.shape)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=0, atol=1e-4)
        h, w = ours.shape[2], ours.shape[3]


def test_time_forward_and_the_cached_forward():
    tnet, _, params, _, x = _setup("lenet5")
    eng = CNNEngine(tnet, device="cpu")
    t = eng.time_forward(params, x, iters=2)
    assert isinstance(t, float) and t > 0
    fn = eng.forward_fn()
    assert eng.forward_fn() is fn and eng.forward_fn(True) is fn
    assert eng.forward_fn(False) is not fn
    assert torch.equal(fn(params, x), eng.forward(params, x))
    eng.method = Method.BASIC_SIMD  # a knob change drops the cached forward
    assert eng.forward_fn() is not fn


# -- the smoke's launch accounting (phase 5b) --------------------------------------


def test_plan_launches_name_the_smokes_tables():
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    kernels = chip_smoke.KERNELS + chip_smoke.CELLS
    for name, rungs in chip_smoke.EXPECTED_LAUNCHES.items():
        net = tnetdefs.NETWORKS[name]()
        for (method, fuse), want in rungs.items():
            got = chip_smoke.plan_launches(
                compile_plan(net, method=Method(method), fuse=fuse), kernels)
            assert tuple(got[k] for k in chip_smoke.KERNELS) == want
            assert all(got[k] == 0 for k in chip_smoke.CELLS)
    tuned = compile_plan(tnetdefs.NETWORKS["alexnet"](), **chip_smoke.TUNED)
    assert chip_smoke.plan_launches(tuned, kernels) == \
        chip_smoke.TUNED_LAUNCHES


def test_smoke_cpu_reference_runs_on_one_thread():
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    n = torch.get_num_threads()
    with chip_smoke.one_thread(torch):
        assert torch.get_num_threads() == 1
    assert torch.get_num_threads() == n

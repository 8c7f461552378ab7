"""The port's deployment path on the CPU, against the JAX package's.

``save_model`` → ``load_model`` / ``load_engine`` crosses between the two
packages in both directions: for the same net, weights (fp32 numpy),
``extra`` and tuned knobs both write a byte-identical ``manifest.json``
with the same ``weights_sha256``; an artifact written by either loads in
the other; the tuned engine's forward matches the JAX engine's under the
same knobs to max abs <= 1e-4 with the same argmax.  Also: what a load
refuses, and the TPU-only knobs.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import deploy as jdeploy
from repro.core import netdefs as jnetdefs
from repro.core.methods import Method as JMethod
from repro_torch.analysis.findings import Finding
from repro_torch.core import deploy as tdeploy
from repro_torch.core import netdefs as tnetdefs
from repro_torch.core.engine import CNNEngine
from repro_torch.core.methods import Method
from repro_torch.core.plan import infer_param_shapes

TOL = 1e-4
#: the tuned AlexNet deployment: K5 on conv1+pool1, K4 on
#: conv2+pool2+norm2, K6 on conv3-5+pool5
TUNED = {"per_layer_fuse": {"norm1": False},
         "per_layer_pool_carry": {"conv1": True},
         "per_layer_lrn_oc_block": {"conv2": True},
         "per_layer_oc_block_final": {"conv5": 8}}
TPU_KNOBS = {"use_pallas": True, "oh_block": 4,
             "per_layer_oh_blocks": {"conv2": 2}}


def narrow_alexnet(nd):
    """AlexNet with channels ÷16, fc 64/64/10, a 3×99×99 input (as in
    ``test_torch_engine.py``)."""
    widths = {"fc6": 64, "fc7": 64, "fc8": 10}
    net = nd.alexnet()
    layers = tuple(
        dataclasses.replace(l, out_channels=widths.get(
            l.name, l.out_channels // 16)) if l.kind in ("conv", "fc") else l
        for l in net.layers)
    return nd.NetworkDef("alexnet_narrow", (3, 99, 99), 10, layers)


def _params(net, seed=4):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shp in infer_param_shapes(net).items():
        conv = len(shp) == 4
        fan = int(np.prod(shp[1:])) if conv else shp[0]
        out[name] = {
            "w": (rng.standard_normal(shp) * np.sqrt(2.0 / fan)
                  ).astype(np.float32),
            "b": (0.05 * rng.standard_normal(shp[0] if conv else shp[1])
                  ).astype(np.float32)}
    return out


def _jax_tree(params):
    return {k: {kk: jnp.asarray(v) for kk, v in d.items()}
            for k, d in params.items()}


def _frames(net, batch=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (batch, *net.input_shape)).astype(np.float32)


def _jax_forward(path, x):
    eng, params, _ = jdeploy.load_engine(path)
    return np.asarray(eng.jit_forward()(params, jnp.asarray(x)))


def test_jax_tuned_artifact_runs_in_the_port(tmp_path):
    jnet, tnet = narrow_alexnet(jnetdefs), narrow_alexnet(tnetdefs)
    params = _params(tnet)
    jdeploy.save_model(tmp_path, jnet, _jax_tree(params), extra={"v": 2},
                       tuned=TUNED)
    eng, tparams, knobs = tdeploy.load_engine(tmp_path, device="cpu")
    assert knobs == TUNED
    assert [r["cell"] for r in eng.fusion_report()] == ["K5", "K4", "K6"]
    x = _frames(tnet)
    ours = eng.forward(tparams, x).numpy()
    theirs = _jax_forward(tmp_path, x)
    assert np.abs(ours - theirs).max() <= TOL
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))


def test_port_tuned_artifact_loads_in_jax(tmp_path):
    jnet, tnet = narrow_alexnet(jnetdefs), narrow_alexnet(tnetdefs)
    params = _params(tnet)
    tdeploy.save_model(tmp_path, tnet,
                       {k: {kk: torch.from_numpy(v) for kk, v in d.items()}
                        for k, d in params.items()},
                       extra={"v": 3}, tuned=TUNED)
    net, jparams, extra = jdeploy.load_model(tmp_path)
    assert extra == {"v": 3}
    assert dataclasses.asdict(net) == dataclasses.asdict(jnet)
    assert jdeploy.load_tuned_knobs(tmp_path) == TUNED
    x = _frames(tnet)
    theirs = _jax_forward(tmp_path, x)
    eng, tparams, _ = tdeploy.load_engine(tmp_path, device="cpu")
    ours = eng.forward(tparams, x).numpy()
    assert np.abs(ours - theirs).max() <= TOL
    np.testing.assert_array_equal(ours.argmax(-1), theirs.argmax(-1))


@pytest.mark.parametrize("tuned", ["none", "tuned", "methods"])
@pytest.mark.parametrize("name", ["lenet5", "alexnet_narrow"])
def test_manifests_are_byte_identical(tmp_path, tuned, name):
    jnet = (narrow_alexnet(jnetdefs) if name == "alexnet_narrow"
            else jnetdefs.NETWORKS[name]())
    tnet = (narrow_alexnet(tnetdefs) if name == "alexnet_narrow"
            else tnetdefs.NETWORKS[name]())
    params = _params(tnet, seed=len(name))
    knobs = {"none": (None, None),
             "tuned": (TUNED, TUNED),
             "methods": ({"method": JMethod.ADVANCED_SIMD_4, "fuse": False,
                          "per_layer_methods": {
                              "conv2": JMethod.BASIC_SIMD}, **TPU_KNOBS},
                         {"method": Method.ADVANCED_SIMD_4, "fuse": False,
                          "per_layer_methods": {
                              "conv2": Method.BASIC_SIMD}, **TPU_KNOBS})}
    jt, tt = knobs[tuned]
    jdeploy.save_model(tmp_path / "j", jnet, _jax_tree(params),
                       extra={"src": "x"}, tuned=jt)
    tdeploy.save_model(tmp_path / "t", tnet, params, extra={"src": "x"},
                       tuned=tt)
    jm = (tmp_path / "j" / "manifest.json").read_bytes()
    tm = (tmp_path / "t" / "manifest.json").read_bytes()
    assert jm == tm
    assert "tuned_plan" in json.loads(tm) or tuned == "none"
    with np.load(tmp_path / "t" / "weights.npz") as data:
        flat = {k: data[k] for k in data.files}
    assert tdeploy._digest(flat) == json.loads(jm)["weights_sha256"]


def test_save_model_takes_tensors_and_arrays_alike(tmp_path):
    net = tnetdefs.lenet5()
    params = _params(net)
    tdeploy.save_model(tmp_path / "a", net, params)
    tdeploy.save_model(tmp_path / "b", net,
                       {k: {kk: torch.from_numpy(v) for kk, v in d.items()}
                        for k, d in params.items()})
    assert ((tmp_path / "a" / "manifest.json").read_bytes()
            == (tmp_path / "b" / "manifest.json").read_bytes())


def test_unknown_knob_fails_save_and_load(tmp_path):
    net = tnetdefs.lenet5()
    with pytest.raises(ValueError, match="unknown tuned-plan knob"):
        tdeploy.save_model(tmp_path, net, _params(net),
                           tuned={"per_layer_carry": {"conv1": True}})
    tdeploy.save_model(tmp_path, net, _params(net), tuned={"fuse": True})
    mpath = tmp_path / "manifest.json"
    m = json.loads(mpath.read_text())
    m["tuned_plan"]["oc_blok"] = 4
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="unknown tuned-plan knob"):
        tdeploy.load_model(tmp_path, device="cpu")


def test_tuned_plan_failing_verification_fails_the_load(tmp_path,
                                                        monkeypatch):
    net = tnetdefs.lenet5()
    tdeploy.save_model(tmp_path, net, _params(net),
                       tuned={"method": Method.BASIC_SIMD})
    tdeploy.load_model(tmp_path, device="cpu")  # clean as written
    seen = []

    def verify(plan):
        seen.append(plan.steps[0].method)
        return [Finding("error", "step0:conv1+pool1", "V101", "injected")]

    monkeypatch.setattr(tdeploy, "verify_plan", verify)
    with pytest.raises(ValueError, match="plan verification failed.*V101"):
        tdeploy.load_model(tmp_path, device="cpu")
    with pytest.raises(ValueError, match="V101"):
        tdeploy.load_engine(tmp_path, device="cpu")
    # the plan verified is the tuned one, not the default
    assert seen and all(m == Method.BASIC_SIMD for m in seen)


def test_tpu_only_knobs_load_and_are_not_applied(tmp_path):
    net = tnetdefs.cifar10_quick()
    params = _params(net)
    tdeploy.save_model(tmp_path, net, params,
                       tuned={"fuse_relu": True, **TPU_KNOBS})
    eng, tparams, knobs = tdeploy.load_engine(tmp_path, device="cpu")
    assert knobs == {"fuse_relu": True, **TPU_KNOBS}
    for k in TPU_KNOBS:
        assert not hasattr(eng, k)
    x = _frames(net)
    plain = CNNEngine(net, device="cpu")
    assert torch.equal(eng.forward(tparams, x), plain.forward(tparams, x))


def test_fuse_knob_maps_onto_fuse_pool(tmp_path):
    net = tnetdefs.lenet5()
    tdeploy.save_model(tmp_path, net, _params(net),
                       tuned={"fuse": False, "method": Method.BASIC_SIMD})
    eng, _, knobs = tdeploy.load_engine(tmp_path, device="cpu")
    assert knobs == {"fuse": False, "method": Method.BASIC_SIMD}
    assert eng.fuse_pool is False and eng.method == Method.BASIC_SIMD
    assert eng.fusion_report() == []


def test_untuned_artifact_loads_the_default_engine(tmp_path):
    net = tnetdefs.lenet5()
    tdeploy.save_model(tmp_path, net, _params(net))
    assert tdeploy.load_tuned_knobs(tmp_path) is None
    eng, _, knobs = tdeploy.load_engine(tmp_path, device="cpu")
    assert knobs is None and eng.method == Method.ADVANCED_SIMD_8
    assert [r["cell"] for r in eng.fusion_report()] == ["K1", "K1"]


def test_load_engine_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    net = tnetdefs.lenet5()
    tdeploy.save_model(tmp_path, net, _params(net))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdeploy.load_engine(tmp_path)
    eng, params, _ = tdeploy.load_engine(tmp_path, device="cpu")
    assert eng.device.type == "cpu"
    assert all(t.device.type == "cpu" for d in params.values()
               for t in d.values())

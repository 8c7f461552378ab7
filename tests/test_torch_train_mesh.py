"""The port's train step on a mesh, on the CPU: reduced gemma2-2b (the tied,
vocab-sharded embedding used twice, the softcaps, local/global pairs) and
reduced qwen1.5-32b (q/k/v biases, an untied head) in fp32 on gloo ranks,
against the JAX package's jitted ``make_train_step`` on the same weights
and global batch.

The ranks (``tests/torch_train_ranks.py``) are processes of their own
that import torch and the port only, joined over a ``FileStore``; JAX
runs here.  Each rank carves its shards of JAX's weights and of its zero
moments, takes two steps through the dry run's ``_build_step`` on its
rows (data parallel over "data", tensor parallel over "model"; at 2 x 1
FSDP's "embed" forced onto the reduced rules, which never turn it on by
themselves; ``microbatches=2`` on the dp meshes), and writes its metrics,
its parameter shards and its ZeRO-1 moment shards after each step.
Held, step by step from the same state (the first from JAX's init, the
second from the ranks' whole state after the first, gathered by
``unshard``): the metrics within 1e-5 of JAX's, each shard against
``local_slice`` of JAX's leaf to ``tests/test_torch_train.py``'s
``_check_step`` limits, the
leaves replicated over "model" the same bits on the model ranks of a
data group, and the 1 x 1 mesh the unsharded port's bits.  Beside them:
each collective's adjoint on four gloo ranks, the vocab-parallel cross
entropy against JAX's, the moment specs against JAX's for every dense
arch, and the K3 fp32 store's backward.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro.sharding import auto as jauto
from repro.sharding import rules as jrules
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.core import config as tconfig
from repro_torch.kernels.matmul_fused.ops import matmul_fused
from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref
from repro_torch.models import registry as tregistry
from repro_torch.nn.param import tree_leaves
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.rules import local_slice, logical_to_spec
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parent.parent
ARCHS = ("gemma2-2b", "qwen1.5-32b")
#: (mesh, microbatches, FSDP forced)
MESHES = (((1, 2), 1, False), ((2, 1), 2, True), ((2, 2), 2, False))
B, S, STEPS = 4, 16, 2
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
#: the metrics against JAX's, relative to max(1, |JAX's|)
METRIC_TOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    """``tree``'s leaves keyed by their paths."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flat(tree):
    """``tree``'s leaves keyed by their paths, as fp32 numpy arrays."""
    return {k: np.asarray(v, np.float32) for k, v in _leaves(tree).items()}


def _jcfg(arch):
    return dataclasses.replace(jconfig.get_arch(arch).reduced(),
                               dtype="float32", param_dtype="float32")


def _tcfg(arch):
    return dataclasses.replace(tconfig.get_arch(arch).reduced(),
                               dtype="float32", param_dtype="float32")


_JAX = {}


def _jax_run(arch, microbatches, dp):
    """JAX's weights, batches, its jitted ``make_train_step``, and its
    first step's parameters, moments and metrics."""
    key = (arch, microbatches, dp)
    if key in _JAX:
        return _JAX[key]
    jm = jregistry.get_model(_jcfg(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(7)
    batches = {}
    for i in range(STEPS):
        toks = rng.integers(0, jm.cfg.vocab_size, (B, S + 1))
        batches[f"tokens{i}"] = toks[:, :-1]
        batches[f"labels{i}"] = toks[:, 1:]
    fn = jax.jit(jstep.make_train_step(jm, jconfig.TrainConfig(**TC),
                                       dp_size=dp,
                                       microbatches=microbatches))
    rec = (_flat(jax.tree_util.tree_map(np.asarray, jp)), batches, fn,
           _jax_step(fn, jp, jopt.adamw_init(jp), batches, 0))
    _JAX[key] = rec
    return rec


def _jax_step(fn, params, state, batches, i):
    p, st, m = fn(params, state, {k: jnp.asarray(batches[f"{k}{i}"])
                                  for k in ("tokens", "labels")})
    return {"params": _flat(p), "m": _flat(st["m"]), "v": _flat(st["v"]),
            "metrics": {k: float(v) for k, v in m.items()}}


def _from_ranks(fn, whole, batches, i):
    """JAX's step ``i`` from the ranks' whole state after step ``i - 1``
    (``unshard``'s): each step is held from the same state, since Adam's
    update divides by the moments and amplifies the earlier steps'
    rounding where a gradient is small."""
    to_j = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda x: jnp.asarray(x.numpy()), t)
    state = {"m": to_j(whole["m"]), "v": to_j(whole["v"]),
             "step": jnp.asarray(i, jnp.int32)}
    return _jax_step(fn, to_j(whole["params"]), state, batches, i)


def _spawn(tmp_path, case, world, files):
    """Run ``world`` ranks over a FileStore; their records."""
    work = tmp_path / "work"
    work.mkdir()
    (work / "case.json").write_text(json.dumps(case))
    for name, arrays in files.items():
        np.savez(work / name, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_train_ranks.py"),
         str(work), str(r), str(world)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _train_case(arch, mesh, microbatches, fsdp, **kw):
    return dict(mode="train", arch=arch, mesh=list(mesh),
                microbatches=microbatches, fsdp=fsdp, tcfg=TC, steps=STEPS,
                **kw)


def _rules(arch, mesh, fsdp):
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    rules, _ = rules_for(_tcfg(arch), mesh_cfg,
                         tconfig.ShapeConfig("train", S, B, "train"))
    return mesh_cfg, rules.replace(embed=("data",)) if fsdp else rules


def _specs(arch, mesh_cfg, rules):
    """Each leaf's (param spec, moment spec) under the port's rules, the
    moments' logical axes JAX's ``adamw_init_spec``'s."""
    jspec = jregistry.get_model(_jcfg(arch)).param_spec()
    fsdp = dict(rules.table).get("embed") is not None
    jm = jopt.adamw_init_spec(jspec, zero1=True, dp_size=mesh_cfg.dp_size,
                              fsdp=fsdp)["m"]
    ps = {k: logical_to_spec(v.axes, mesh_cfg.axes, rules)
          for k, v in _leaves(jspec).items()}
    ms = {k: logical_to_spec(v.axes, mesh_cfg.axes, rules)
          for k, v in _leaves(jm).items()}
    return ps, ms


def _close(ours, ref, tol):
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _check_rank(rec, refs, mesh_cfg, ps, ms):
    """Each step's metrics, moment shards and parameter shards against
    JAX's step from the same state, to ``_check_step``'s limits."""
    coords = rec["coords"]
    for i, (ours, ref) in enumerate(zip(rec["steps"], refs)):
        for k, v in ref["metrics"].items():
            assert abs(ours["metrics"][k] - v) <= METRIC_TOL * max(
                1.0, abs(v)), (i, k, ours["metrics"][k], v)
        lr = ref["metrics"]["lr"]
        params = _flat(ours["params"])
        for name in ("m", "v"):
            got = _flat(ours[name])
            for k, want in ref[name].items():
                _close(got[k], _slice(want, ms[k], mesh_cfg, coords), 1e-4)
        for k, want in ref["params"].items():
            a = params[k]
            b = _slice(want, ps[k], mesh_cfg, coords)
            mom = np.abs(_slice(ref["m"][k], ps[k], mesh_cfg, coords))
            tiny = mom <= 1e-3 * max(float(mom.max()), 1e-30)
            err = np.abs(a - b)
            assert (err[~tiny] <= 1e-6 * np.maximum(1.0, np.abs(b[~tiny]))
                    + 1e-3 * lr).all(), (i, k)
            assert (err[tiny] <= 2.02 * lr + 1e-6).all(), (i, k)
        assert ours["step"] == i + 1


def _slice(arr, spec, mesh_cfg, coords):
    return local_slice(torch.from_numpy(np.array(arr)), spec,
                       mesh_cfg, coords).numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh,microbatches,fsdp", MESHES,
                         ids=[f"{m[0]}x{m[1]}" for m, _, _ in MESHES])
def test_sharded_train_steps_match_jax(tmp_path, arch, mesh, microbatches,
                                       fsdp):
    mesh_cfg, rules = _rules(arch, mesh, fsdp)
    params, batches, fn, first = _jax_run(arch, microbatches,
                                          mesh_cfg.dp_size)
    recs = _spawn(tmp_path, _train_case(arch, mesh, microbatches, fsdp),
                  mesh_cfg.num_devices, {"params.npz": params,
                                         "batch.npz": batches})
    # every rank gathers the same whole state
    for rec in recs[1:]:
        for a, b in zip(tree_leaves(rec["whole"]),
                        tree_leaves(recs[0]["whole"])):
            assert torch.equal(a, b)
    refs = [first, _from_ranks(fn, recs[0]["whole"], batches, 1)]
    ps, ms = _specs(arch, mesh_cfg, rules)
    for rec in recs:
        _check_rank(rec, refs, mesh_cfg, ps, ms)
        counts = rec["counts"]
        layers = _tcfg(arch).num_layers
        if mesh_cfg.model_size > 1:
            # q/k/v and gate/up of every block, and the head, a microbatch
            assert counts["copy_to.bwd/model"]["calls"] == \
                microbatches * (2 * layers + 1)
        if fsdp:
            assert rec["fsdp"] == ("data",)
            assert counts["gather_over.bwd/data"]["calls"] > 0
        elif mesh_cfg.dp_size > 1:
            # no dense leaf has an unnamed axis for ZeRO-1 to cut (JAX's
            # specs): the data-replicated gradients are summed whole
            assert counts["sum_over/data"]["calls"] > 0
    # the leaves a model axis does not cut: the same bits on the model
    # ranks of one data group
    for a in recs:
        for b in recs:
            if a["coords"]["data"] != b["coords"]["data"] or a is b:
                continue
            for part, spec in (("params", ps), ("m", ms)):
                fa = _leaves(a["steps"][-1][part])
                fb = _leaves(b["steps"][-1][part])
                for k, sp in spec.items():
                    if "model" not in str(sp):
                        assert torch.equal(fa[k], fb[k]), (part, k)


def test_full_gemma2_rules_turn_fsdp_on_at_2x1():
    """The uncut gemma2-2b would hold 5.2 GB of parameters a device under
    model sharding alone at 2 x 1: ``rules_for`` shards "embed" over
    "data", the path the smoke's phase 17 runs."""
    cfg = tconfig.get_arch("gemma2-2b")
    mesh_cfg = tconfig.MeshConfig((2, 1), ("data", "model"))
    rules, notes = rules_for(cfg, mesh_cfg, tconfig.get_shape("train_4k"))
    assert rules.lookup("embed") == ("data",)
    assert any(n.startswith("FSDP") for n in notes)


def test_one_by_one_mesh_gives_the_unsharded_bits(tmp_path):
    params, batches, _, _ = _jax_run("gemma2-2b", 2, 2)
    rec, = _spawn(tmp_path, _train_case("gemma2-2b", (1, 1), 2, False,
                                        unsharded=True), 1,
                  {"params.npz": params, "batch.npz": batches})
    for ours, ref in zip(rec["steps"], rec["unsharded"]):
        assert ours["metrics"] == ref["metrics"]
        for part in ("params", "m", "v"):
            for a, b in zip(tree_leaves(ours[part]), tree_leaves(ref[part])):
                assert torch.equal(a, b)
    assert rec["counts"] == {}


# -- each collective's adjoint, and the vocab-parallel cross entropy ---------


def _ordered(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def test_collectives_and_their_adjoints_on_four_ranks(tmp_path):
    """On a 2 x 2 gloo mesh, each rank's output and gradient under the
    loss sum(y * r) (r its own cotangent): over "model" a cotangent is
    replicated, so ``sum_over``'s adjoint is the identity and
    ``gather_over``'s the rank's slice; over "data" ``sum_over``'s sums
    and ``gather_over``'s is the rank-ordered reduce-scatter;
    ``copy_to``'s sums and ``sum_scatter_over``'s gathers on both.  Sums
    in rank order, bit for bit.  The vocab-parallel CE and its gradient
    against JAX's ``cross_entropy`` on the whole logits."""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 5, 24)) * 4).astype(np.float32)
    logits[..., 21:] = -1e30  # the padding lies in the last slice
    labels = rng.integers(0, 21, (3, 5))
    recs = _spawn(tmp_path, {"mode": "collectives", "mesh": [2, 2],
                             "vocab": 21}, 4,
                  {"ce.npz": {"logits": logits, "labels": labels}})
    for axis, other in (("model", "data"), ("data", "model")):
        for rec in recs:
            group = sorted((r for r in recs
                            if r["coords"][other] == rec["coords"][other]),
                           key=lambda r: r["coords"][axis])
            i = rec["coords"][axis]
            n = len(group)

            def part(t, j, dim=1):
                size = t.shape[dim] // n
                return t.narrow(dim, j * size, size)

            xs = [g["copy_to/" + axis]["x"] for g in group]
            got = rec[f"copy_to/{axis}"]
            assert torch.equal(got["y"], got["x"])
            assert torch.equal(got["dx"], _ordered(
                [g[f"copy_to/{axis}"]["r"] for g in group]))
            got = rec[f"sum_over/{axis}"]
            xs = [g[f"sum_over/{axis}"]["x"] for g in group]
            rs = [g[f"sum_over/{axis}"]["r"] for g in group]
            assert torch.equal(got["y"], _ordered(xs))
            want = got["r"] if axis == "model" else _ordered(rs)
            assert torch.equal(got["dx"], want)
            got = rec[f"gather_over/{axis}"]
            xs = [g[f"gather_over/{axis}"]["x"] for g in group]
            rs = [g[f"gather_over/{axis}"]["r"] for g in group]
            assert torch.equal(got["y"], torch.cat(xs, 1))
            want = (part(got["r"], i) if axis == "model"
                    else part(_ordered(rs), i))
            assert torch.equal(got["dx"], want)
            got = rec[f"sum_scatter_over/{axis}"]
            xs = [g[f"sum_scatter_over/{axis}"]["x"] for g in group]
            rs = [g[f"sum_scatter_over/{axis}"]["r"] for g in group]
            assert torch.equal(got["y"], part(_ordered(xs), i))
            assert torch.equal(got["dx"], torch.cat(rs, 1))
    for rec in recs:
        group = [r for r in recs if r["coords"]["data"] ==
                 rec["coords"]["data"]]
        got = rec["max_over/model"]
        assert torch.equal(got["y"], torch.maximum(*[g["max_over/model"]["x"]
                                                     for g in group]))
    _check_zero1(recs)
    ce, grad = jax.value_and_grad(jstep.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), 21)
    grad = np.asarray(grad)
    for rec in recs:
        j = rec["coords"]["model"]
        assert float(rec["ce"]["ce"]) == pytest.approx(float(ce), rel=1e-6)
        np.testing.assert_allclose(rec["ce"]["dlogits"].numpy(),
                                   grad[..., j * 12:(j + 1) * 12],
                                   rtol=1e-5, atol=1e-7)


def _check_zero1(recs):
    """The ZeRO-1 updates of ``ZERO_SPEC`` against JAX's ``adamw_update``
    on the whole tree with the data ranks' gradients summed: "a" and "c"
    cut along their unnamed dimension (kind "scatter"), "b" summed whole;
    the shards of every rank, the moments the ZeRO-1 shards of JAX's."""
    import torch_train_ranks as ranks

    from repro_torch.core.config import MeshConfig
    from repro_torch.sharding.rules import DEFAULT_RULES

    mesh_cfg = MeshConfig((2, 2), ("data", "model"))
    assert recs[0]["zero1"]["kinds"] == ["scatter", "sum", "scatter"]
    whole, g0 = ranks.zero1_inputs({"data": 0})
    _, g1 = ranks.zero1_inputs({"data": 1})
    tc = jconfig.TrainConfig(learning_rate=1e-2, warmup_steps=1,
                             total_steps=10, weight_decay=0.5)
    jp = {k: jnp.asarray(v.numpy()) for k, v in whole.items()}
    js = jopt.adamw_init(jp)
    mspec = topt.adamw_init_spec(ranks.ZERO_SPEC, zero1=True, dp_size=2)["m"]
    for i, scale in enumerate((1.0, 0.5)):
        g = {k: jnp.asarray(((g0[k] * scale) + (g1[k] * scale)).numpy())
             for k in whole}
        jp, js, jm = jopt.adamw_update(g, js, jp, tc)
        for rec in recs:
            got = rec["zero1"]["steps"][i]
            assert got["metrics"]["grad_norm"] == pytest.approx(
                float(jm["grad_norm"]), rel=1e-6)
            for k, p in ranks.ZERO_SPEC.items():
                ps = logical_to_spec(p.axes, mesh_cfg.axes, DEFAULT_RULES)
                want = _slice(np.asarray(jp[k]), ps, mesh_cfg,
                              rec["coords"])
                np.testing.assert_allclose(got["params"][k].numpy(), want,
                                           rtol=1e-6, atol=1e-7)
                mspec_k = logical_to_spec(mspec[k].axes, mesh_cfg.axes,
                                          DEFAULT_RULES)
                np.testing.assert_allclose(
                    got["m"][k].numpy(),
                    _slice(np.asarray(js["m"][k]), mspec_k, mesh_cfg,
                           rec["coords"]), rtol=1e-6, atol=1e-7)


# -- the moment specs ---------------------------------------------------------


DENSE = [a for a in tconfig.list_archs()
         if tconfig.get_arch(a).family == "dense"]


@pytest.mark.parametrize("fsdp", (False, True), ids=("zero1", "fsdp"))
@pytest.mark.parametrize("mesh", ((2, 1), (2, 2), (16, 16)),
                         ids=("2x1", "2x2", "16x16"))
def test_moment_specs_equal_jax(mesh, fsdp):
    """``adamw_init_spec``'s moment specs under the rules, and
    ``shard_plan``'s local moment shapes, equal JAX's for every dense
    arch, with and without FSDP's "embed" (forced on or off)."""
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    jmesh = jconfig.MeshConfig(mesh, ("data", "model"))
    sizes = dict(zip(("data", "model"), mesh))
    for arch in DENSE:
        shape = tconfig.get_shape("train_4k")
        rules, _ = rules_for(tconfig.get_arch(arch), mesh_cfg, shape)
        jr, _ = jauto.rules_for(jconfig.get_arch(arch), jmesh,
                                jconfig.get_shape("train_4k"))
        over = {"embed": ("data",) if fsdp else None}
        rules, jr = rules.replace(**over), jr.replace(**over)
        tspec = tregistry.get_model(tconfig.get_arch(arch)).param_spec()
        jspec = jregistry.get_model(jconfig.get_arch(arch)).param_spec()
        ours = topt.adamw_init_spec(tspec, zero1=True, dp_size=mesh[0],
                                    fsdp=fsdp)
        ref = jopt.adamw_init_spec(jspec, zero1=True, dp_size=mesh[0],
                                   fsdp=fsdp)
        o, r = _leaves(ours["m"]), _leaves(ref["m"])
        assert list(o) == list(r)
        plan = topt.shard_plan(tspec, mesh_cfg, rules)
        for e, k in zip(plan, o):
            ts = logical_to_spec(o[k].axes, mesh_cfg.axes, rules)
            js = tuple(jrules.logical_to_spec(r[k].axes, jmesh.axes, jr))
            assert ts == js, (arch, k)
            want = tuple(
                d // int(np.prod([sizes[a] for a in
                                  ((ent,) if isinstance(ent, str) else
                                   (ent or ()))]))
                for d, ent in zip(r[k].shape, js))
            assert e.shape == want, (arch, k)
            if fsdp and "embed" in o[k].axes:
                assert e.kind == "own"


# -- K3's fp32 store under autograd -----------------------------------------


@pytest.mark.parametrize("act", ("none", "silu"))
def test_k3_fp32_store_backward_plain_version(act):
    """The fp32 store of bf16 operands under autograd on the CPU: dz is
    the fp32 cotangent cast to bf16, and dx, dw are the plain products on
    it.  Where the partial meets only the cast to bf16 (act "none"), that
    cotangent holds bf16 values and the cast is exact; silu's act' (at z
    recomputed in bf16, as for a bf16 store) rounds once, as a bf16
    store's dz."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((37, 96)).astype(np.float32)
                         ).to(torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy(rng.standard_normal((96, 72)).astype(np.float32)
                         / 10).to(torch.bfloat16).requires_grad_(True)
    r = torch.from_numpy(rng.standard_normal((37, 72)).astype(np.float32)
                         ).to(torch.bfloat16)
    y = matmul_fused(x, w, act=act, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    dy = {}
    y.register_hook(lambda g: dy.update(g=g))
    (y.to(torch.bfloat16).float() * r.float()).sum().backward()
    g = dy["g"]
    if act == "none":
        assert torch.equal(g.to(torch.bfloat16).float(), g)
        dz = g.to(torch.bfloat16)
    else:
        from repro_torch.kernels.matmul_fused.ops import act_grad
        z = matmul_fused_ref(x.detach(), w.detach(), None, "none")
        dz = (g * act_grad(act, z)).to(torch.bfloat16)
    assert torch.equal(x.grad, matmul_fused_ref(dz, w.detach().t()))
    assert torch.equal(w.grad, matmul_fused_ref(x.detach().t(), dz))


def test_remat_recompute_sees_the_forward_sharding():
    """A rematted unit's recompute runs under the forward's sharding
    context even where autograd runs the backward on another thread (its
    own, for CUDA tensors; here a thread of the test's, outside the
    context): without it the recompute would skip every collective and
    FSDP gather."""
    import threading

    from repro_torch.models.common import layer_call
    from repro_torch.sharding import ctx as shard_ctx
    from repro_torch.sharding.rules import DEFAULT_RULES

    sharding = shard_ctx.Sharding(None, tconfig.MeshConfig(
        (1, 1), ("data", "model")), DEFAULT_RULES, {"data": 0, "model": 0})
    seen = []

    def unit(x):
        seen.append(shard_ctx.current())
        return x * x  # saves x: the backward recomputes

    x = torch.ones(3, requires_grad=True)
    with shard_ctx.installed(sharding):
        y = layer_call(True)(unit, x)
    t = threading.Thread(target=lambda: y.sum().backward())
    t.start()
    t.join()
    assert seen == [sharding, sharding]
    assert torch.equal(x.grad, torch.full((3,), 2.0))

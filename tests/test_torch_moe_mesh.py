"""The port's MoE block on a mesh, on the CPU: reduced qwen3-moe (experts
cut over "model": 4 experts, top 2) and reduced grok-1 (each expert's
d_ff of 128 cut over "model") in fp32 on gloo ranks, against the JAX
package's jitted ``forward``, ``decode_step`` and ``make_train_step``
with ``dp_size`` the mesh's data size, on the same weights.

The ranks (``tests/torch_moe_ranks.py``) are processes of their own that
import torch and the port only; every mesh's ranks start at once, each
mesh's running all its cases one after another, while JAX runs here.
The weights are the port's init (``moe_redraw``'s experts), carried to
JAX as numpy.  The meshes and what each shows:

* 1 x 1: the unsharded port's bits, serving and a train step;
* 1 x 2: qwen3 at 2 experts a rank, grok at 64 ff columns a rank;
* 2 x 1: the batch cut over "data", one token group a rank, the aux
  losses' statistics summed over the data ranks; batch 1 replicated,
  every rank running both groups;
* 2 x 2: both, with a train step (qwen3's with FSDP's "embed" forced,
  which gathers the experts' "embed" axis unit by unit);
* 1 x 4: qwen3 at 1 expert a rank, its 2 kv heads whole beside 4 ranks
  (the cache cut by sequence).

Held: the logits within ``TOL`` x max(1, |logits|) of JAX's, the greedy
tokens equal, every MoE call's capacity JAX's (``_group_count`` of the
global tokens and the mesh's dp) and its chosen experts those of the
unsharded port grouped the same way (the rank's groups); the train
step's metrics (the aux losses among them) within ``TOL`` of JAX's, each
shard to ``tests/test_torch_train.py``'s ``_check_step`` limits of
``local_slice`` of JAX's leaf, the router's gradient the same bits on
the model ranks of a data group.  Beside them, the dry run's 16 MoE rows
at the JAX package's two production meshes, traced in a process a mesh
that starts with the ranks (in this file, so that ``--dist loadfile``
runs them on another worker than ``tests/test_torch_dryrun.py``).
"""
import dataclasses
import json
import math
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
from repro.nn.moe import _group_count
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.core import config as tconfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import registry as tregistry
from repro_torch.nn.moe import moe_redraw
from repro_torch.nn.param import init_tree
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.rules import local_slice, logical_to_spec
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parent.parent
#: relative to max(1, max|JAX's|): the same fp32 arithmetic, the partial
#: outputs, the experts' partials and the aux statistics summed over the
#: ranks in other orders
TOL = 1e-5
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
ARCHS = {"qwen": "qwen3-moe-30b-a3b", "grok": "grok-1-314b"}
#: serving: prompt tokens, cache rows, decode steps; training: rows, tokens
PROMPT, CACHE, STEPS = 12, 24, 2
TRAIN_B, TRAIN_S = 4, 8
#: mesh -> its cases: (name, kind, arch, batch or FSDP forced)
MESHES = {
    (1, 1): (("qwen", "serve", "qwen", 2), ("grok", "serve", "grok", 2),
             ("train_qwen", "train", "qwen", False)),
    (1, 2): (("qwen", "serve", "qwen", 2), ("grok", "serve", "grok", 2),
             ("train_qwen", "train", "qwen", False),
             ("train_grok", "train", "grok", False)),
    (2, 1): (("qwen", "serve", "qwen", 2), ("grok", "serve", "grok", 2),
             ("qwen_b1", "serve", "qwen", 1)),
    (2, 2): (("qwen", "serve", "qwen", 2), ("grok", "serve", "grok", 2),
             ("qwen_b1", "serve", "qwen", 1),
             ("train_qwen", "train", "qwen", True),
             ("train_grok", "train", "grok", False)),
    (1, 4): (("qwen", "serve", "qwen", 2),),
}
SERVE_CASES = [(m, c[0]) for m, cs in MESHES.items() for c in cs
               if c[1] == "serve"]
TRAIN_CASES = [(m, c[0]) for m, cs in MESHES.items() for c in cs
               if c[1] == "train" and m != (1, 1)]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    return tuple(dataclasses.replace(m.get_arch(ARCHS[arch]).reduced(),
                                     dtype="float32", param_dtype="float32")
                 for m in (jconfig, tconfig))


def _leaves(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _flat(tree):
    return {k: np.asarray(v, np.float32) for k, v in _leaves(tree).items()}


def _weights(arch):
    """The port's init of the reduced arch, its experts redrawn, as numpy
    keyed by path."""
    _, tcfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    tree = init_tree(tregistry.get_model(tcfg).param_spec(), gen,
                     tcfg.param_dtype)
    moe_redraw(tree, torch.Generator().manual_seed(1))
    return {k: v.numpy() for k, v in _leaves(tree).items()}


def _jtree(flat):
    out = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(v)
    return out


def _inputs():
    rng = np.random.default_rng(3)
    vocab = _cfgs("qwen")[0].vocab_size
    toks = rng.integers(0, vocab, (TRAIN_B, TRAIN_S + 1))
    return {"prompts_b2.npy": rng.integers(0, vocab, (2, PROMPT)),
            "prompts_b1.npy": rng.integers(0, vocab, (1, PROMPT)),
            "train.npz": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}


def _case(name, kind, arch, extra, mesh):
    case = dict(name=name, kind=kind, arch=ARCHS[arch],
                weights=f"{arch}.npz")
    if kind == "serve":
        case.update(inputs=f"prompts_b{extra}.npy", cache=CACHE,
                    steps=STEPS, unsharded=True)
    else:
        case.update(inputs="train.npz", tcfg=TC, fsdp=extra,
                    unsharded=mesh == (1, 1))
    return case


#: the dry run's rows of ``argv[3:]`` (archs) at every shape on mesh
#: ``argv[1]``, written as JSON to ``argv[2]``: one process a mesh, beside
#: the ranks
TRACE = """
import json, sys
import torch.distributed as dist
from repro_torch.core.config import SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import parse_mesh
mesh = parse_mesh(sys.argv[1])
recs = [dryrun.run_one(a, s, mesh) for a in sys.argv[3:] for s in SHAPES]
assert not dist.is_initialized()
open(sys.argv[2], "w").write(json.dumps(recs))
"""
MOE = ("qwen3-moe-30b-a3b", "grok-1-314b")
PRODUCTION = {"single_pod": "16x16", "multi_pod": "2x16x16"}


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")


def _popen(args):
    return subprocess.Popen([sys.executable, *args], env=_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _spawn(root):
    """Every mesh's ranks at once, and the dry run's production meshes:
    {mesh: (work, procs)}."""
    out = {}
    for name, mesh in PRODUCTION.items():
        out[name] = root / f"{name}.json", [_popen(
            ["-c", TRACE, mesh, str(root / f"{name}.json"), *MOE])]
    for mesh, cases in MESHES.items():
        work = root / f"mesh{mesh[0]}x{mesh[1]}"
        work.mkdir()
        (work / "cases.json").write_text(json.dumps({
            "mesh": list(mesh),
            "cases": [_case(*c, mesh) for c in cases]}))
        world = math.prod(mesh)
        out[mesh] = work, [_popen(
            [str(ROOT / "tests" / "torch_moe_ranks.py"), str(work), str(r),
             str(world)]) for r in range(world)]
    return out


def _collect(started):
    logs, recs = {}, {}
    try:
        for mesh, (_, procs) in started.items():
            logs[mesh] = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for _, procs in started.values():
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for mesh, (work, procs) in started.items():
        for p, log in zip(procs, logs[mesh]):
            assert p.returncode == 0, log
        if mesh in PRODUCTION:
            recs[mesh] = json.loads(work.read_text())
        else:
            recs[mesh] = [torch.load(work / f"rank{r}.pt",
                                     weights_only=False)
                          for r in range(len(procs))]
    return recs


def _jax_serve(arch, flat, toks, dp):
    """JAX's logits of the prefill and of each decode step, and its greedy
    tokens, its blocks grouped by ``dp``."""
    jcfg, _ = _cfgs(arch)
    jm = jregistry.get_model(jcfg)
    jp = _jtree(flat)
    b = toks.shape[0]
    pre = jax.jit(lambda p, t, c: jm.forward(p, {"tokens": t}, "prefill",
                                             cache=c, dp_size=dp))
    dec = jax.jit(lambda p, t, pos, c: jm.decode_step(p, t, pos, c,
                                                      dp_size=dp))
    cache = jax.tree_util.tree_map(lambda c: c.astype(jnp.float32),
                                   jm.init_cache(b, CACHE))
    logits, cache, _ = pre(jp, jnp.asarray(toks), cache)
    out = [np.asarray(logits)]
    nxt = np.asarray(logits[:, -1].argmax(-1))
    tokens = [nxt]
    for t in range(STEPS):
        pos = np.full((b,), PROMPT + t, np.int32)
        lg, cache = dec(jp, jnp.asarray(nxt[:, None]), jnp.asarray(pos),
                        cache)
        out.append(np.asarray(lg))
        nxt = np.asarray(lg[:, -1].argmax(-1))
        tokens.append(nxt)
    return {"logits": out, "tokens": np.stack(tokens, 1)}


def _jax_train(arch, flat, batch, dp):
    jcfg, _ = _cfgs(arch)
    jm = jregistry.get_model(jcfg)
    jp = _jtree(flat)
    fn = jax.jit(jstep.make_train_step(jm, jconfig.TrainConfig(**TC),
                                       dp_size=dp, microbatches=1))
    p, st, m = fn(jp, jopt.adamw_init(jp),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    return {"params": _flat(p), "m": _flat(st["m"]),
            "metrics": {k: float(v) for k, v in m.items()}}


_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every mesh's ranks' records, and JAX's references by (kind, arch,
    batch, dp), computed while the ranks run."""
    if _RUN:
        return _RUN["out"]
    root = tmp_path_factory.mktemp("moe_mesh")
    inputs = _inputs()
    weights = {a: _weights(a) for a in ARCHS}
    for a, flat in weights.items():
        np.savez(root / f"{a}.npz", **flat)
    for name, v in inputs.items():
        if isinstance(v, dict):
            np.savez(root / name, **v)
        else:
            np.save(root / name, v)
    started = _spawn(root)
    try:
        refs = {}
        for mesh, cases in MESHES.items():
            dp = mesh[0]
            for _, kind, arch, extra in cases:
                key = (kind, arch, extra if kind == "serve" else None, dp)
                if key in refs:
                    continue
                if kind == "serve":
                    refs[key] = _jax_serve(arch, weights[arch], inputs[
                        f"prompts_b{extra}.npy"], dp)
                else:
                    refs[key] = _jax_train(arch, weights[arch],
                                           inputs["train.npz"], dp)
    finally:
        recs = _collect(started)
    _RUN["out"] = refs, recs, inputs
    return _RUN["out"]


def _close(ours, ref, tol=TOL):
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _slice(arr, spec, mesh_cfg, coords):
    return local_slice(torch.from_numpy(np.array(arr)), spec, mesh_cfg,
                       coords).numpy()


def _meta(mesh, name):
    kind, arch, extra = next(c[1:] for c in MESHES[mesh] if c[0] == name)
    return kind, arch, extra


def _jax_capacity(cfg, mode, tokens, dp):
    """The JAX package's capacity of a call of ``tokens`` tokens grouped
    by ``dp`` (``repro.nn.moe.moe_apply``'s rule)."""
    moe = cfg.moe
    k = moe.num_experts_per_token
    t_l = tokens // _group_count(tokens, dp)
    if mode == "decode":
        return t_l * k
    cf = moe.capacity_factor if mode == "train" else moe.eval_capacity_factor
    return min(max(1, math.ceil(t_l * k * cf / moe.num_experts)), t_l * k)


@pytest.mark.parametrize("mesh,name", SERVE_CASES,
                         ids=[f"{m[0]}x{m[1]}-{n}" for m, n in SERVE_CASES])
def test_sharded_moe_serving_matches_jax(run, mesh, name):
    """Prefill and two decode steps: every rank's logits within ``TOL``
    of JAX's rows, its greedy tokens JAX's, each MoE call's capacity
    JAX's and its experts the unsharded port's for the rank's groups;
    the exchanges a layer: the picked rows (experts cut) or the fp32
    partials (expert d_ff cut) summed over "model"."""
    refs, recs, _ = run
    _, arch, batch = _meta(mesh, name)
    jcfg, tcfg = _cfgs(arch)
    dp = mesh[0]
    ref = refs[("serve", arch, batch, dp)]
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    rules, _ = rules_for(tcfg, mesh_cfg, tconfig.ShapeConfig(
        "decode", CACHE, batch, "decode"))
    bspec = logical_to_spec(("batch", None), mesh_cfg.axes, rules)
    layers = tcfg.num_layers
    cut = rules.lookup("batch") is not None and dp > 1
    for rank in recs[mesh]:
        coords, rec = rank["coords"], rank[name]
        for lg, want in zip(rec["logits"], ref["logits"]):
            _close(lg.numpy(), _slice(want, bspec + (None,), mesh_cfg,
                                      coords))
        np.testing.assert_array_equal(
            rec["tokens"].numpy(), _slice(ref["tokens"], bspec, mesh_cfg,
                                          coords))
        whole = rec["unsharded"]
        np.testing.assert_array_equal(whole["tokens"].numpy(),
                                      ref["tokens"])
        assert len(rec["routes"]) == len(whole["routes"]) == \
            layers * (1 + STEPS)
        for i, (got, want) in enumerate(zip(rec["routes"],
                                            whole["routes"])):
            tokens = batch * (PROMPT if i < layers else 1)
            assert got["mode"] == want["mode"]
            assert got["cap"] == want["cap"] == _jax_capacity(
                tcfg, got["mode"], tokens, dp), (i, got["cap"])
            groups = want["experts"]
            if cut:  # the rank's rows are its data index's groups
                n = groups.shape[0] // dp
                groups = groups[coords["data"] * n:(coords["data"] + 1) * n]
            assert torch.equal(got["experts"], groups), (i, got["margin"])
        counts = rec["counts"]
        if mesh[1] > 1:
            # each layer's MoE exchange over "model", besides attention's
            assert counts["sum_over/model"]["calls"] >= (1 + STEPS) * layers
    if mesh[1] > 1:
        want = ("model" if tcfg.moe.shard_mode == "expert" else None,
                None if tcfg.moe.shard_mode == "expert" else "model")
        assert (rules.lookup("experts"), rules.lookup("expert_ff")) == want


def test_one_by_one_mesh_gives_the_unsharded_bits(run):
    """The 1 x 1 mesh: the sharded path's logits, tokens and routing the
    unsharded port's bits, serving both archs, and a train step's metrics
    and new parameters and moments."""
    _, recs, _ = run
    rank, = recs[(1, 1)]
    for name in ("qwen", "grok"):
        rec = rank[name]
        for a, b in zip(rec["logits"], rec["unsharded"]["logits"]):
            assert torch.equal(a, b), name
        assert torch.equal(rec["tokens"], rec["unsharded"]["tokens"])
    rec = rank["train_qwen"]
    assert rec["metrics"] == rec["unsharded"]["metrics"]
    for part in ("params", "m"):
        ours, want = _leaves(rec[part]), _leaves(rec["unsharded"][part])
        for k in want:
            assert torch.equal(ours[k], want[k]), (part, k)


def test_replicated_batch_runs_every_group_on_every_rank(run):
    """Batch 1 over dp 2 (2 x 1 and 2 x 2): "batch" is whole, every rank
    holds the prompt and routes both of JAX's groups of 6 tokens at their
    capacity; the ranks' logits are the same bits."""
    _, recs, _ = run
    _, tcfg = _cfgs("qwen")
    for mesh in ((2, 1), (2, 2)):
        ranks = recs[mesh]
        first = ranks[0]["qwen_b1"]
        assert first["rules"]["batch"] is None
        prefill = first["routes"][0]
        assert prefill["experts"].shape[:2] == (2, PROMPT // 2)
        assert prefill["cap"] == _jax_capacity(tcfg, "prefill", PROMPT, 2)
        for rank in ranks[1:]:
            for a, b in zip(rank["qwen_b1"]["logits"], first["logits"]):
                assert torch.equal(a, b)


def _specs(arch, mesh_cfg, rules):
    tspec = tregistry.get_model(_cfgs(arch)[1]).param_spec()
    fsdp = dict(rules.table).get("embed") is not None
    mspec = topt.adamw_init_spec(tspec, zero1=True, dp_size=mesh_cfg.dp_size,
                                 fsdp=fsdp)["m"]
    return ({k: logical_to_spec(v.axes, mesh_cfg.axes, rules)
             for k, v in _leaves(tspec).items()},
            {k: logical_to_spec(v.axes, mesh_cfg.axes, rules)
             for k, v in _leaves(mspec).items()})


@pytest.mark.parametrize("mesh,name", TRAIN_CASES,
                         ids=[f"{m[0]}x{m[1]}-{n}" for m, n in TRAIN_CASES])
def test_sharded_moe_train_step_matches_jax(run, mesh, name):
    """One step: the metrics (CE, both aux losses, the grad norm) within
    ``TOL`` of JAX's at ``dp_size`` the mesh's dp, each moment and
    parameter shard to ``_check_step``'s limits of ``local_slice`` of
    JAX's leaf, the router's gradient the same bits on the model ranks of
    a data group."""
    refs, recs, _ = run
    _, arch, fsdp = _meta(mesh, name)
    _, tcfg = _cfgs(arch)
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    ref = refs[("train", arch, None, mesh[0])]
    rules, _ = rules_for(tcfg, mesh_cfg, tconfig.ShapeConfig(
        "train", TRAIN_S, TRAIN_B, "train"))
    if fsdp:
        rules = rules.replace(embed=("data",))
    ps, ms = _specs(arch, mesh_cfg, rules)
    lr = ref["metrics"]["lr"]
    for rank in recs[mesh]:
        coords, rec = rank["coords"], rank[name]
        assert rec["embed"] == rules.lookup("embed")
        for k, v in ref["metrics"].items():
            assert abs(rec["metrics"][k] - v) <= TOL * max(1.0, abs(v)), \
                (k, rec["metrics"][k], v)
        params, mom = _leaves(rec["params"]), _leaves(rec["m"])
        for k, want in ref["params"].items():
            _close(mom[k].numpy(), _slice(ref["m"][k], ms[k], mesh_cfg,
                                          coords), 1e-4)
            a, b = params[k].numpy(), _slice(want, ps[k], mesh_cfg, coords)
            m = np.abs(_slice(ref["m"][k], ps[k], mesh_cfg, coords))
            tiny = m <= 1e-3 * max(float(m.max()), 1e-30)
            err = np.abs(a - b)
            assert (err[~tiny] <= 1e-6 * np.maximum(1.0, np.abs(b[~tiny]))
                    + 1e-3 * lr).all(), k
            assert (err[tiny] <= 2.02 * lr + 1e-6).all(), k
        if fsdp:  # the experts' "embed" axis gathered unit by unit
            assert rec["counts"]["gather_over/data"]["calls"] > 0
        for other in recs[mesh]:
            if other["coords"]["data"] == coords["data"]:
                assert torch.equal(other[name]["router_grad"],
                                   rec["router_grad"])


def test_aux_losses_are_the_whole_batchs(run):
    """The 2 x 2 train step's groups route apart (their expert fractions
    differ), so the mean of per-group load-balance products parts from
    JAX's product of means by far more than ``TOL``; the ranks give JAX's
    (``test_sharded_moe_train_step_matches_jax``) and their global expert
    fraction is the mean of the groups'."""
    refs, recs, inputs = run
    jcfg, tcfg = _cfgs("qwen")
    ref = refs[("train", "qwen", None, 2)]
    batch = inputs["train.npz"]
    jm = jregistry.get_model(jcfg)
    jp = _jtree(_weights("qwen"))
    half = TRAIN_B // 2
    per_group = []
    for g in range(2):
        rows = {k: jnp.asarray(v[g * half:(g + 1) * half])
                for k, v in batch.items()}
        _, aux = jax.jit(lambda p, b: jm.forward(p, b, "train",
                                                 dp_size=1))(jp, rows)
        per_group.append(float(aux["load_balance_loss"]))
    want = ref["metrics"]["load_balance_loss"]
    assert abs(np.mean(per_group) - want) > 100 * TOL * max(1.0, abs(want))
    for rank in recs[(2, 2)]:
        got = rank["train_qwen"]["metrics"]["load_balance_loss"]
        assert abs(got - want) <= TOL * max(1.0, abs(want))
    # the routing's picks differ between the groups
    routes = recs[(2, 2)][0]["train_qwen"]["routes"]
    other = next(r for r in recs[(2, 2)]
                 if r["coords"]["data"] != recs[(2, 2)][0]["coords"]["data"])
    assert not torch.equal(
        torch.bincount(routes[0]["experts"].reshape(-1), minlength=4),
        torch.bincount(other["train_qwen"]["routes"][0]["experts"]
                       .reshape(-1), minlength=4))


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mesh_name", tuple(PRODUCTION))
def test_every_moe_row_traced_at_the_production_meshes(run, mesh_name, arch):
    """The JAX package's meshes, 16 x 16 and 2 x 16 x 16 (``dryrun.run_one``
    in a process of its own a mesh, beside the ranks): every shape of both
    MoE archs traced at full depth with its collectives: qwen3's 128
    experts cut 16 ways (the picked rows summed over "model" once a
    layer), grok's expert d_ff of 32768 cut into 2048 columns (the fp32
    partials summed); FSDP on for both; grok's ``train_4k`` on bf16
    moments and accumulation (over 100 B parameters)."""
    _, recs, _ = run
    mesh = parse_mesh(PRODUCTION[mesh_name])
    cfg = tconfig.get_arch(arch)
    rows = {r["shape"]: r for r in recs[mesh_name] if r["arch"] == arch}
    assert sorted(rows) == sorted(tconfig.SHAPES)
    for shape, rec in rows.items():
        assert rec["mesh"] == "x".join(map(str, mesh.shape))
        assert rec["traced"], (shape, rec.get("why_not_traced"))
        assert rec["fits"], (shape, rec["per_device_bytes"])
        assert any(n.startswith("FSDP") for n in rec["sharding_notes"])
        coll = rec["collectives"]
        layers = cfg.num_layers
        if shape == "train_4k":
            assert coll["sum_over/model"]["calls"] >= \
                rec["microbatches"] * layers
            want = "bfloat16" if arch == "grok-1-314b" else "float32"
            assert dryrun.train_settings(cfg, tconfig.get_shape(shape),
                                         mesh)["moment_dtype"] == want
        else:
            assert coll["sum_over/model"]["calls"] >= layers


@pytest.mark.parametrize("arch,mesh,variant,rule", [
    ("qwen3-moe-30b-a3b", (16, 16), "", None),
    ("grok-1-314b", (2, 4), "", None),
    ("qwen3-moe-30b-a3b", (1, 4), "seq_sp", "'seq_res'"),
    ("rwkv6-1.6b", (1, 64), "", "'ssm_inner'"),
    ("seamless-m4t-large-v2", (2, 2), "", "'media'")])
def test_check_executed_takes_moe_and_names_the_rest(arch, mesh, variant,
                                                     rule):
    """``check_executed`` takes both MoE shard modes on a mesh of any data
    and model size, at ``rules_for``'s rules; it still raises, naming the
    rule, for "media", seq_sp's "seq_res" and a mesh that cuts an ssm
    family's "ssm_inner" unlike its "heads" (rwkv6's 32 heads whole on 64
    ranks, its inner dimension cut)."""
    from repro_torch.launch.variants import apply_variants
    from repro_torch.models.transformer import check_executed

    cfg = tconfig.get_arch(arch)
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    rules, _ = rules_for(cfg, mesh_cfg, tconfig.get_shape("train_4k"))
    if variant:
        _, rules, _, _ = apply_variants((variant,), cfg, rules,
                                        mesh_cfg.model_size)
    if rule is None:
        check_executed(cfg, mesh_cfg, rules)
        axis = "experts" if cfg.moe.shard_mode == "expert" else "expert_ff"
        assert rules.lookup(axis) == "model"
        return
    with pytest.raises(NotImplementedError, match=rule):
        check_executed(cfg, mesh_cfg, rules)

"""The port's ssm and hybrid families on a mesh, on the CPU: reduced
rwkv6-1.6b (4 WKV heads of 64, its "ssm_inner" projections cut over
"model") and reduced zamba2-1.2b (8 SSD heads of 64 and ``in_proj``'s
1064 columns cut over "model", the shared block's 4 attention heads over
2 kv heads) in fp32 on gloo ranks, against the JAX package's jitted
``forward``, ``decode_step`` and ``make_train_step`` with ``dp_size`` the
mesh's data size, on the same weights.

The ranks (``tests/torch_ssm_ranks.py``) are processes of their own that
import torch and the port only; every mesh's ranks start at once, each
mesh's running all its cases one after another, while JAX's references
run here (zamba2's) and in a process beside (rwkv6's).
The weights are the port's init with ``rwkv_redraw``'s and
``ssm_redraw``'s leaves, carried to JAX as numpy.  The meshes and what
each shows:

* 1 x 1: the unsharded port's bits, serving and a train step;
* 1 x 2: 2 WKV heads, 4 SSD heads and 2 attention heads a rank; zamba2's
  ``in_proj`` cut at 532 columns, inside x (its z segment is 512 wide);
* 2 x 1: the batch cut over "data"; batch 1 replicated, every rank running
  the same row, zamba2's shared KV cache cut by sequence over "data";
* 2 x 2: both;
* 1 x 4: one WKV head, 2 SSD heads and one attention head a rank, the
  shared block's 2 kv heads whole beside 4 ranks (its cache cut by
  sequence over "model").

Held: the logits within ``TOL`` x max(1, |logits|) of JAX's, the greedy
tokens equal, every cache leaf (rwkv6's ``state`` and ``last``, zamba2's
``conv`` and ``state``, the shared KV) within ``TOL`` of ``local_slice``
of JAX's; the train step's metrics within ``TOL`` of JAX's, each shard to
``tests/test_torch_train.py``'s ``_check_step`` limits of ``local_slice``
of JAX's leaf (zamba2's ``in_proj`` B and C columns and ``A_log``, ``D``,
``dt_bias`` among them: every rank's heads feed their gradients); each
rank gives K11, the SSD scan and K10 its own heads alone.  Beside them,
the dry run's 16 ssm and hybrid rows at the JAX package's two production
meshes, traced in a process a mesh that starts with the ranks.
"""
import dataclasses
import json
import math
import os
import pickle
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
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.core import config as tconfig
from repro_torch.launch.dryrun import _build_step
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import registry as tregistry
from repro_torch.models.transformer import check_executed
from repro_torch.nn.param import init_tree, tree_leaves
from repro_torch.nn.rwkv import rwkv_redraw
from repro_torch.nn.ssm import ssm_redraw
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.rules import (local_shape, local_slice,
                                        logical_to_spec)
from repro_torch.train import optimizer as topt

ROOT = Path(__file__).resolve().parent.parent
#: relative to max(1, max|JAX's|): the same fp32 arithmetic, the
#: row-parallel partials, the norm's sums of squares and the softmax's
#: exchange summed over the ranks in other orders
TOL = 1e-5
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)
ARCHS = {"rwkv": "rwkv6-1.6b", "zamba": "zamba2-1.2b"}
#: serving: prompt tokens (past one chunk of 32: the carried state),
#: cache rows, decode steps; training: rows, tokens
PROMPT, CACHE, STEPS = 40, 48, 2
TRAIN_B, TRAIN_S = 4, 40
#: mesh -> its cases: (name, kind, arch, batch)
MESHES = {
    (1, 1): (("rwkv", "serve", "rwkv", 2), ("zamba", "serve", "zamba", 2),
             ("train_rwkv", "train", "rwkv", None),
             ("train_zamba", "train", "zamba", None)),
    (1, 2): (("rwkv", "serve", "rwkv", 2), ("zamba", "serve", "zamba", 2),
             ("train_rwkv", "train", "rwkv", None),
             ("train_zamba", "train", "zamba", None)),
    (2, 1): (("rwkv", "serve", "rwkv", 2), ("zamba", "serve", "zamba", 2),
             ("rwkv_b1", "serve", "rwkv", 1),
             ("zamba_b1", "serve", "zamba", 1),
             ("train_rwkv", "train", "rwkv", None),
             ("train_zamba", "train", "zamba", None)),
    (2, 2): (("rwkv", "serve", "rwkv", 2), ("zamba", "serve", "zamba", 2),
             ("zamba_b1", "serve", "zamba", 1),
             ("train_rwkv", "train", "rwkv", None),
             ("train_zamba", "train", "zamba", None)),
    (1, 4): (("rwkv", "serve", "rwkv", 2), ("zamba", "serve", "zamba", 2),
             ("train_rwkv", "train", "rwkv", None),
             ("train_zamba", "train", "zamba", None)),
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


#: rwkv6's train case redraws ``w0`` from N(-3, 0.5) after
#: ``rwkv_redraw`` (whose N(-0.5, 1) puts exp(w0) up to about 4.5): JAX's
#: chunked WKV exponentiates ``cw_prev_i - cw_j`` above the diagonal too
#: and selects it away after, so at 31 rows of such decays its exp
#: overflows and its gradient is NaN (the port's forms mask first, F6)
TRAIN_W0 = (-3.0, 0.5)


def _weights(arch, train=False):
    """The port's init of the reduced arch, the leaves its init leaves at
    zeros or ones redrawn, as numpy keyed by path (``train``: rwkv6's
    decays at ``TRAIN_W0``)."""
    _, tcfg = _cfgs(arch)
    tree = init_tree(tregistry.get_model(tcfg).param_spec(),
                     torch.Generator().manual_seed(0), tcfg.param_dtype)
    redraw = rwkv_redraw if arch == "rwkv" else ssm_redraw
    redraw(tree, torch.Generator().manual_seed(1))
    if train and arch == "rwkv":
        w0 = tree["layers"]["time"]["w0"]
        w0.copy_(TRAIN_W0[0] + TRAIN_W0[1] * torch.randn(
            w0.shape, generator=torch.Generator().manual_seed(2)))
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
    rng = np.random.default_rng(5)
    vocab = _cfgs("rwkv")[0].vocab_size
    toks = rng.integers(0, vocab, (TRAIN_B, TRAIN_S + 1))
    return {"prompts_b2.npy": rng.integers(0, vocab, (2, PROMPT)),
            "prompts_b1.npy": rng.integers(0, vocab, (1, PROMPT)),
            "train.npz": {"tokens": toks[:, :-1], "labels": toks[:, 1:]}}


def _case(name, kind, arch, batch, mesh):
    case = dict(name=name, kind=kind, arch=ARCHS[arch],
                weights=f"{arch}_{kind}.npz", unsharded=mesh == (1, 1))
    if kind == "serve":
        case.update(inputs=f"prompts_b{batch}.npy", cache=CACHE,
                    steps=STEPS)
    else:
        case.update(inputs="train.npz", tcfg=TC)
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
PRODUCTION = {"single_pod": "16x16", "multi_pod": "2x16x16"}
#: JAX's references of rwkv6, computed in a process of their own beside
#: this one's zamba2 references (``argv[1]``: the work directory),
#: pickled to ``argv[2]``
REFS = """
import pickle, sys
from pathlib import Path
sys.path.insert(0, %r)
import test_torch_ssm_mesh as T
root = Path(sys.argv[1])
pickle.dump(T._references(root, "rwkv"), open(sys.argv[2], "wb"))
""" % str(ROOT / "tests")


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")


def _popen(args):
    return subprocess.Popen([sys.executable, *args], env=_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _spawn(root):
    """Every mesh's ranks at once, the dry run's production meshes and
    JAX's rwkv6 references: {mesh, "refs": (work or file, procs)}."""
    out = {"refs": (root / "refs_rwkv.pkl", [_popen(
        ["-c", REFS, str(root), str(root / "refs_rwkv.pkl")])])}
    for name, mesh in PRODUCTION.items():
        out[name] = root / f"{name}.json", [_popen(
            ["-c", TRACE, mesh, str(root / f"{name}.json"),
             *ARCHS.values()])]
    for mesh, cases in MESHES.items():
        work = root / f"mesh{mesh[0]}x{mesh[1]}"
        work.mkdir()
        (work / "cases.json").write_text(json.dumps({
            "mesh": list(mesh),
            "cases": [_case(*c, mesh) for c in cases]}))
        world = math.prod(mesh)
        out[mesh] = work, [_popen(
            [str(ROOT / "tests" / "torch_ssm_ranks.py"), str(work), str(r),
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
        if mesh == "refs":
            with open(work, "rb") as f:
                recs[mesh] = pickle.load(f)
        elif mesh in PRODUCTION:
            recs[mesh] = json.loads(work.read_text())
        else:
            recs[mesh] = [torch.load(work / f"rank{r}.pt",
                                     weights_only=False)
                          for r in range(len(procs))]
    return recs


def _jax_serve(arch, flat, toks, dp):
    """JAX's logits of the prefill and of each decode step, its greedy
    tokens and its final cache."""
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
    return {"logits": out, "tokens": np.stack(tokens, 1),
            "cache": _flat(cache)}


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


def _references(root, arch_key):
    """JAX's references of ``arch_key``'s cases, by (kind, arch, batch,
    dp: the mesh's data size), from the weights and inputs in ``root``."""
    refs = {}
    for mesh, cases in MESHES.items():
        dp = mesh[0]
        for _, kind, arch, batch in cases:
            key = (kind, arch, batch, dp)
            if arch != arch_key or key in refs:
                continue
            with np.load(root / f"{arch}_{kind}.npz") as npz:
                flat = {k: npz[k] for k in npz.files}
            if kind == "serve":
                refs[key] = _jax_serve(arch, flat, np.load(
                    root / f"prompts_b{batch}.npy"), dp)
            else:
                with np.load(root / "train.npz") as npz:
                    batch_ = {k: npz[k] for k in npz.files}
                refs[key] = _jax_train(arch, flat, batch_, dp)
    return refs


_RUN = {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every mesh's ranks' records, and JAX's references by (kind, arch,
    batch, dp): zamba2's computed here while the ranks, the dry run and
    the process of rwkv6's references run."""
    if _RUN:
        return _RUN["out"]
    root = tmp_path_factory.mktemp("ssm_mesh")
    inputs = _inputs()
    for a in ARCHS:
        for kind in ("serve", "train"):
            np.savez(root / f"{a}_{kind}.npz", **_weights(a, kind == "train"))
    for name, v in inputs.items():
        if isinstance(v, dict):
            np.savez(root / name, **v)
        else:
            np.save(root / name, v)
    started = _spawn(root)
    try:
        refs = _references(root, "zamba")
    finally:
        recs = _collect(started)
    refs.update(recs.pop("refs"))
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
    return next(c[1:] for c in MESHES[mesh] if c[0] == name)


def _serve_rules(tcfg, mesh_cfg, batch):
    return rules_for(tcfg, mesh_cfg, tconfig.ShapeConfig(
        "decode", CACHE, batch, "decode"))[0]


@pytest.mark.parametrize("mesh,name", SERVE_CASES,
                         ids=[f"{m[0]}x{m[1]}-{n}" for m, n in SERVE_CASES])
def test_sharded_ssm_serving_matches_jax(run, mesh, name):
    """Prefill and two decode steps: every rank's logits within ``TOL``
    of JAX's rows, its greedy tokens JAX's, each of its cache leaves
    (cut by the leaf's logical axes) ``local_slice`` of JAX's within
    ``TOL``."""
    refs, recs, _ = run
    _, arch, batch = _meta(mesh, name)
    _, tcfg = _cfgs(arch)
    ref = refs[("serve", arch, batch, mesh[0])]
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    rules = _serve_rules(tcfg, mesh_cfg, batch)
    bspec = logical_to_spec(("batch", None), mesh_cfg.axes, rules)
    cspec = {k: logical_to_spec(p.axes, mesh_cfg.axes, rules)
             for k, p in _leaves(tregistry.get_model(tcfg).cache_spec(
                 batch, CACHE)).items()}
    assert sorted(cspec) == sorted(ref["cache"])
    for rank in recs[mesh]:
        coords, rec = rank["coords"], rank[name]
        for lg, want in zip(rec["logits"], ref["logits"]):
            _close(lg.numpy(), _slice(want, bspec + (None,), mesh_cfg,
                                      coords))
        np.testing.assert_array_equal(
            rec["tokens"].numpy(), _slice(ref["tokens"], bspec, mesh_cfg,
                                          coords))
        ours = _leaves(rec["cache"])
        assert sorted(ours) == sorted(cspec)
        for k, spec in cspec.items():
            _close(ours[k].numpy(), _slice(ref["cache"][k], spec, mesh_cfg,
                                           coords))
    if mesh[1] > 1:
        assert recs[mesh][0][name]["rules"]["ssm_inner"] == "model"


def test_one_by_one_mesh_gives_the_unsharded_bits(run):
    """The 1 x 1 mesh: the sharded path's logits, tokens and cache the
    unsharded port's bits, serving both archs, and a train step's metrics
    and new parameters and moments."""
    _, recs, _ = run
    rank, = recs[(1, 1)]
    for name in ("rwkv", "zamba"):
        rec = rank[name]
        for a, b in zip(rec["logits"], rec["unsharded"]["logits"]):
            assert torch.equal(a, b), name
        assert torch.equal(rec["tokens"], rec["unsharded"]["tokens"])
        ours, want = _leaves(rec["cache"]), _leaves(rec["unsharded"]["cache"])
        for k in want:
            assert torch.equal(ours[k], want[k]), (name, k)
    for name in ("train_rwkv", "train_zamba"):
        rec = rank[name]
        assert rec["metrics"] == rec["unsharded"]["metrics"], name
        for part in ("params", "m"):
            ours, want = _leaves(rec[part]), _leaves(rec["unsharded"][part])
            for k in want:
                assert torch.equal(ours[k], want[k]), (name, part, k)


def _specs(arch, mesh_cfg, rules):
    tspec = tregistry.get_model(_cfgs(arch)[1]).param_spec()
    mspec = topt.adamw_init_spec(tspec, zero1=True, dp_size=mesh_cfg.dp_size,
                                 fsdp=False)["m"]
    return ({k: logical_to_spec(v.axes, mesh_cfg.axes, rules)
             for k, v in _leaves(tspec).items()},
            {k: logical_to_spec(v.axes, mesh_cfg.axes, rules)
             for k, v in _leaves(mspec).items()})


@pytest.mark.parametrize("mesh,name", TRAIN_CASES,
                         ids=[f"{m[0]}x{m[1]}-{n}" for m, n in TRAIN_CASES])
def test_sharded_ssm_train_step_matches_jax(run, mesh, name):
    """One step: the metrics (CE, the grad norm) within ``TOL`` of JAX's,
    each moment and parameter shard to ``_check_step``'s limits of
    ``local_slice`` of JAX's leaf: zamba2's gathered ``in_proj`` and conv
    (their B and C columns fed by every rank's heads) and the whole
    ``A_log``, ``D``, ``dt_bias`` and norm scales among them."""
    refs, recs, _ = run
    _, arch, _ = _meta(mesh, name)
    _, tcfg = _cfgs(arch)
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    ref = refs[("train", arch, None, mesh[0])]
    rules, _ = rules_for(tcfg, mesh_cfg, tconfig.ShapeConfig(
        "train", TRAIN_S, TRAIN_B, "train"))
    ps, ms = _specs(arch, mesh_cfg, rules)
    lr = ref["metrics"]["lr"]
    for rank in recs[mesh]:
        coords, rec = rank["coords"], rank[name]
        for k, v in ref["metrics"].items():
            assert abs(rec["metrics"][k] - v) <= TOL * max(1.0, abs(v)), \
                (k, rec["metrics"][k], v)
        params, mom = _leaves(rec["params"]), _leaves(rec["m"])
        assert sorted(params) == sorted(ref["params"])
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


def test_a_rank_runs_its_own_heads(run):
    """Every rank gives K11 (its wrapper and the per-step WKV) h / M heads
    of rwkv6's 4, the SSD scan h / M of zamba2's 8 and K10 H / M of the
    shared block's 4 attention heads, serving and training; zamba2's
    Mamba blocks gather ``in_proj``'s, ``conv_w``'s and ``conv_b``'s
    columns (and the conv state, with a cache) over "model" once a block
    a call, and sum their norm's squares, and the train step's backward
    sums the gathers' parts (``gather_over.bwd``) once a gather."""
    _, recs, _ = run
    layers = _cfgs("zamba")[1].num_layers
    for mesh, cases in MESHES.items():
        M = mesh[1]
        for rank in recs[mesh]:
            for name, kind, arch, _ in cases:
                heads = rank[name]["heads"]
                if arch == "rwkv":
                    assert heads == {"K11": [4 // M], "ssd": [], "K10": []}
                else:
                    assert heads == {"K11": [], "ssd": [8 // M],
                                     "K10": [4 // M]}, (mesh, name)
                counts = rank[name]["counts"]
                if arch != "zamba" or M == 1:
                    continue
                calls = 1 + STEPS if kind == "serve" else 2  # + recompute
                per_block = 4 if kind == "serve" else 3
                assert counts["gather_over/model"]["calls"] >= \
                    calls * per_block * layers
                if kind == "train":
                    assert counts["gather_over.bwd/model"]["calls"] == \
                        3 * layers


@pytest.mark.parametrize("arch", tuple(ARCHS.values()))
@pytest.mark.parametrize("mesh_name", tuple(PRODUCTION))
def test_every_ssm_row_traced_at_the_production_meshes(run, mesh_name,
                                                       arch):
    """The JAX package's meshes, 16 x 16 and 2 x 16 x 16 (``dryrun.run_one``
    in a process of its own a mesh, beside the ranks): every shape of
    rwkv6 and zamba2 traced at full depth, within 80 GB: rwkv6's 32 heads
    and zamba2's 64 SSD heads cut 16 ways (2 and 4 a rank), the
    row-parallel ``wo``/``wv``/``out_proj`` summed over "model" once a
    layer, zamba2's ``in_proj`` gathered over "model" once a Mamba
    block (4 gathers a block with a cache)."""
    _, recs, _ = run
    mesh = parse_mesh(PRODUCTION[mesh_name])
    cfg = tconfig.get_arch(arch)
    rows = {r["shape"]: r for r in recs[mesh_name] if r["arch"] == arch}
    assert sorted(rows) == sorted(tconfig.SHAPES)
    for shape, rec in rows.items():
        assert rec["mesh"] == "x".join(map(str, mesh.shape))
        assert rec["traced"], (shape, rec.get("why_not_traced"))
        assert rec["fits"], (shape, rec["per_device_bytes"])
        assert not any(n.startswith("FSDP") for n in rec["sharding_notes"])
        coll = rec["collectives"]
        k = rec.get("microbatches", 1)
        layers = cfg.num_layers
        if arch == "rwkv6-1.6b":  # wo and the channel mix's wv
            assert coll["sum_over/model"]["calls"] >= 2 * layers * k
        else:
            per_block = 3 if shape == "train_4k" else 4
            assert coll["gather_over/model"]["calls"] >= \
                per_block * layers * k


def test_production_caches_are_cut_by_their_logical_axes():
    """``init_cache`` of the ranks' models at 16 x 16 on meta tensors:
    rwkv6's ``time.state`` cut by "heads" (2 of 32 a rank), its ``last``
    rows whole; zamba2's conv rows cut by "ssm_inner" (264 of 4224
    channels), its SSD state by "heads" (4 of 64), its shared KV by kv
    heads over "model"; at ``long_500k`` batch 1 whole and zamba2's KV
    sequence over "data"."""
    mesh_cfg = parse_mesh("16x16")
    for arch in ARCHS.values():
        cfg = tconfig.get_arch(arch)
        for shape_name in ("decode_32k", "long_500k"):
            shape = tconfig.get_shape(shape_name)
            rules, _ = rules_for(cfg, mesh_cfg, shape)
            model = tregistry.get_model(cfg, mesh_cfg, rules)
            window = model.effective_window(shape)
            cache = model.init_cache(shape.global_batch, shape.seq_len,
                                     window, device="meta")
            spec = model.cache_spec(shape.global_batch, shape.seq_len, window)
            for got, p in zip(tree_leaves(cache), tree_leaves(spec)):
                assert tuple(got.shape) == local_shape(
                    p.shape, logical_to_spec(p.axes, mesh_cfg.axes, rules),
                    mesh_cfg)
            b = shape.global_batch // (16 if shape_name == "decode_32k"
                                       else 1)
            if arch == "rwkv6-1.6b":
                assert tuple(cache["time"]["state"].shape) == \
                    (24, b, 2, 64, 64)
                assert tuple(cache["time"]["last"].shape) == (24, b, 2048)
            else:
                assert tuple(cache["mamba"]["conv"].shape) == (36, b, 3, 264)
                assert tuple(cache["mamba"]["state"].shape) == \
                    (36, b, 4, 64, 64)
                rows = shape.seq_len if shape_name == "decode_32k" else \
                    window // 16
                assert tuple(cache["shared_kv"]["k"].shape) == \
                    (6, b, rows, 2, 128)


@pytest.mark.parametrize("rule,arch,mesh", [
    ("fsdp", "rwkv6-1.6b", (2, 2)),
    ("heads", "zamba2-1.2b", (1, 64))])
def test_ssm_refusals_name_their_rule(rule, arch, mesh):
    """The two rules the executed path refuses for these families, each
    named: FSDP's "embed" (``rules_for`` never sets it for them; forced
    here) and a mesh where "heads" and "ssm_inner" cut differently (64
    ways: zamba2's 32 attention heads are whole, its inner dimension
    cut)."""
    cfg = tconfig.get_arch(arch)
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    shape = tconfig.get_shape("train_4k")
    rules, _ = rules_for(cfg, mesh_cfg, shape)
    assert rules.lookup("embed") is None
    if rule == "fsdp":
        rules = rules.replace(embed=("data",))
    with pytest.raises(NotImplementedError, match=f"'{rule}'" if rule ==
                       "heads" else "FSDP's 'embed'"):
        check_executed(cfg, mesh_cfg, rules)
    with pytest.raises(NotImplementedError):
        _build_step(cfg, shape, mesh_cfg, rules)

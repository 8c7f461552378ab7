"""One rank of the port's sharded train step on the CPU, for
``tests/test_torch_train_mesh.py``: imports torch and the port only.

Run as ``python tests/torch_train_ranks.py WORK RANK WORLD``.
``WORK/case.json`` names what to run:

* ``"mode": "train"``: the config, the mesh, the microbatches, the train
  config, whether FSDP's "embed" is forced onto the rules, and the steps;
  ``WORK/params.npz`` holds the whole parameter tree (keys ``a/b/c``) and
  ``WORK/batch.npz`` each step's tokens and labels.  The rank carves its
  shards of the weights (``shard_params``) and of JAX's zero moments
  (``shard_opt_state``), takes the steps through the dry run's
  ``_build_step`` on its rows, and writes each step's metrics, its
  parameter and moment shards, the collectives of the first step, and
  the whole state after the first step (``unshard``).
  With ``"unsharded": true`` it also takes the steps with the unsharded
  port on the same weights and rows.
* ``"mode": "collectives"``: each collective of ``sharding.collectives``
  forward and backward on seeded per-rank inputs, two ZeRO-1 AdamW
  updates of a small tree (``ZERO_SPEC``), and the vocab-parallel cross
  entropy with its gradient; the outputs and gradients are written.

Every rank joins a gloo group over ``WORK/store``, on one intra-op thread.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.config import (MeshConfig, ShapeConfig, TrainConfig,
                                     get_arch)
from repro_torch.launch.dryrun import _build_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import (shard_opt_state, shard_params,
                                           unshard)
from repro_torch.nn.param import Param, tree_leaves, tree_map
from repro_torch.sharding import collectives as coll
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.ctx import activation_sharding
from repro_torch.sharding.rules import (DEFAULT_RULES, local_slice,
                                        logical_to_spec)
from repro_torch.train.optimizer import (adamw_init, adamw_init_spec,
                                         adamw_update, reduce_grads,
                                         shard_plan)
from repro_torch.train.step import cross_entropy, make_train_step


def _tree(npz):
    out = {}
    for key in npz.files:
        *path, leaf = key.split("/")
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = npz[key]
    return out


def config(case):
    return dataclasses.replace(get_arch(case["arch"]).reduced(),
                               dtype="float32", param_dtype="float32")


def rules_of(case, cfg, mesh_cfg, shape):
    rules, _ = rules_for(cfg, mesh_cfg, shape)
    return rules.replace(embed=("data",)) if case.get("fsdp") else rules


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def train(work, case, mesh_cfg, mesh, coords):
    cfg = config(case)
    with np.load(work / "batch.npz") as npz:
        batches = [{k: torch.from_numpy(npz[f"{k}{i}"]).long()
                    for k in ("tokens", "labels")}
                   for i in range(case["steps"])]
    b, s = batches[0]["tokens"].shape
    shape = ShapeConfig("train", s, b, "train")
    rules = rules_of(case, cfg, mesh_cfg, shape)
    with np.load(work / "params.npz") as npz:
        tree = params_from_jax(_tree(npz), cfg, device="cpu")
    local = shard_params(cfg, tree, mesh, rules)
    zeros = {"m": tree_map(torch.zeros_like, tree),
             "v": tree_map(torch.zeros_like, tree),
             "step": torch.zeros((), dtype=torch.int32)}
    tcfg = TrainConfig(**case["tcfg"])
    step, model = _build_step(cfg, shape, mesh_cfg, rules, tcfg=tcfg,
                              microbatches=case["microbatches"])(mesh, local)
    opt = shard_opt_state(cfg, zeros, mesh, rules)
    fresh = adamw_init(local, step.plan())
    assert [tuple(t.shape) for t in tree_leaves(opt)] == \
        [tuple(t.shape) for t in tree_leaves(fresh)]
    mspec = adamw_init_spec(model.param_spec(), zero1=True,
                            dp_size=mesh_cfg.dp_size,
                            fsdp=rules.lookup("embed") is not None)["m"]
    spec = logical_to_spec(("batch", "seq"), mesh_cfg.axes, rules)
    rows = [{k: local_slice(v, spec, mesh_cfg, coords) for k, v in
             bt.items()} for bt in batches]
    rec = {"coords": coords, "steps": [], "fsdp": rules.lookup("embed")}
    for i, bt in enumerate(rows):
        coll.reset_counts()
        local, opt, metrics = step(local, opt, bt)
        if i == 0:
            rec["counts"] = coll.counts_by_name()
            with activation_sharding(mesh, rules):
                rec["whole"] = {
                    "params": _clone(unshard(model.param_spec(), local,
                                             mesh_cfg, rules)),
                    **{part: _clone(unshard(mspec, opt[part], mesh_cfg,
                                            rules)) for part in ("m", "v")}}
        rec["steps"].append({"metrics": {k: float(v)
                                         for k, v in metrics.items()},
                             "params": _clone(local),
                             "m": _clone(opt["m"]), "v": _clone(opt["v"]),
                             "step": int(opt["step"])})
    if case.get("unsharded"):
        whole = get_model(cfg).load_tree(tree)
        fn = make_train_step(whole, tcfg, microbatches=case["microbatches"])
        state = adamw_init(tree)
        out = []
        for bt in rows:
            tree, state, metrics = fn(tree, state, bt)
            out.append({"metrics": {k: float(v) for k, v in metrics.items()},
                        "params": _clone(tree), "m": _clone(state["m"]),
                        "v": _clone(state["v"])})
        rec["unsharded"] = out
    return rec


def collectives(work, case, mesh_cfg, mesh, coords):
    """Each collective's output and its input's gradient under a loss
    ``sum(out * r)``, ``r`` this rank's seeded cotangent, and the CE."""
    rank = dist.get_rank()
    gen = torch.Generator().manual_seed(100 + rank)
    out = {"coords": coords}
    with activation_sharding(mesh, DEFAULT_RULES):
        for axis in ("model", "data"):
            for name, fn in (
                    ("copy_to", lambda x, a=axis: coll.copy_to(a, x)),
                    ("sum_over", lambda x, a=axis: coll.sum_over(a, x)),
                    ("gather_over",
                     lambda x, a=axis: coll.gather_over(a, x, 1)),
                    ("sum_scatter_over",
                     lambda x, a=axis: coll.sum_scatter_over(a, x, 1))):
                x = torch.randn((3, 4), generator=gen, requires_grad=True)
                y = fn(x)
                r = torch.randn(y.shape, generator=gen)
                (y * r).sum().backward()
                out[f"{name}/{axis}"] = {"x": x.detach(), "y": y.detach(),
                                         "r": r, "dx": x.grad}
        x = torch.randn((5,), generator=gen)
        out["max_over/model"] = {"x": x, "y": coll.max_over("model", x)}
    out["zero1"] = zero1(mesh_cfg, mesh, coords)
    # the vocab-parallel CE: the rank's slice of the whole logits
    with np.load(work / "ce.npz") as npz:
        logits, labels = (torch.from_numpy(npz[k]) for k in ("logits",
                                                             "labels"))
    rules = DEFAULT_RULES.replace(batch=None)
    with activation_sharding(mesh, rules):
        spec = logical_to_spec(("batch", "seq", "vocab"), mesh_cfg.axes,
                               rules)
        mine = local_slice(logits, spec, mesh_cfg, coords).clone()
        mine.requires_grad_(True)
        ce = cross_entropy(mine, labels, case["vocab"])
        ce.backward()
    out["ce"] = {"ce": ce.detach(), "dlogits": mine.grad}
    return out


#: a tree whose moments ZeRO-1 cuts: "a" along its unnamed dimension 0
#: (and "ff" over "model"), "c" along dimension 1; "b" does not divide
ZERO_SPEC = {"a": Param((4, 6), (None, "ff")), "b": Param((3,), (None,)),
             "c": Param((4, 4), ("embed", None))}


def zero1_inputs(coords):
    """The whole parameters (the same on every rank) and the rank's
    gradient of each leaf, whole: its data rank's own, the same on the
    model ranks of a data group."""
    gen = torch.Generator().manual_seed(7)
    params = {k: torch.randn(p.shape, generator=gen)
              for k, p in sorted(ZERO_SPEC.items())}
    gen.manual_seed(20 + coords["data"])
    grads = {k: torch.randn(p.shape, generator=gen)
             for k, p in sorted(ZERO_SPEC.items())}
    return params, grads


def zero1(mesh_cfg, mesh, coords):
    """Two AdamW updates of ``ZERO_SPEC``'s shards through
    ``reduce_grads`` and ``adamw_update``'s ZeRO-1 path."""
    params, grads = zero1_inputs(coords)
    with activation_sharding(mesh, DEFAULT_RULES):
        plan = shard_plan(ZERO_SPEC, mesh_cfg, DEFAULT_RULES)
        specs = {k: logical_to_spec(p.axes, mesh_cfg.axes, DEFAULT_RULES)
                 for k, p in sorted(ZERO_SPEC.items())}
        local = {k: local_slice(v, specs[k], mesh_cfg, coords).clone()
                 for k, v in params.items()}
        opt = adamw_init(local, plan)
        tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1,
                           total_steps=10, weight_decay=0.5)
        out = []
        for scale in (1.0, 0.5):
            g = {k: local_slice(v * scale, specs[k], mesh_cfg,
                                coords).clone() for k, v in grads.items()}
            _, _, metrics = adamw_update(reduce_grads(g, plan), opt, local,
                                         tcfg, plan)
            out.append({"params": _clone(local), "m": _clone(opt["m"]),
                        "metrics": {k: float(v) for k, v in
                                    metrics.items()}})
    return {"kinds": [e.kind for e in plan], "steps": out}


def main(work, rank, world):
    torch.set_num_threads(1)
    case = json.loads((work / "case.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world)
    try:
        mesh_cfg = MeshConfig(tuple(case["mesh"]), ("data", "model"))
        mesh = make_mesh(mesh_cfg, "cpu")
        coords = dict(zip(mesh_cfg.axes, mesh.get_coordinate()))
        run = train if case["mode"] == "train" else collectives
        torch.save(run(work, case, mesh_cfg, mesh, coords),
                   work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))

"""One rank of the port's sharded MoE path on the CPU, for
``tests/test_torch_moe_mesh.py``: imports torch and the port only.

Run as ``python tests/torch_moe_ranks.py WORK RANK WORLD``.
``WORK/cases.json`` holds the mesh and a list of cases, run one after
another in the one gloo group (over ``WORK/store``, one intra-op thread);
the whole parameter trees (keys ``a/b/c``) and the inputs lie one
directory up, shared by every mesh:

* ``"kind": "serve"``: the config (reduced arch, fp32), the global batch
  (``<inputs>.npy``: the prompts), the cache's rows and the decode steps.
  The rules are ``rules_for``'s at a decode of the batch into the cache.
  The rank carves its shards, prefills its rows of the batch through the
  dry run's ``_build_step``, takes the decode steps with its own greedy
  tokens and keeps its logits, tokens, collectives and every MoE call's
  routing (mode, capacity, chosen experts, the smallest margin between a
  token's k-th and (k+1)-th router probability).  With ``"unsharded":
  true`` it also runs the unsharded port on the whole batch, its blocks
  grouped by the mesh's data size, and keeps the same.
* ``"kind": "train"``: ``<inputs>.npz`` (tokens, labels); one step through
  ``_build_step`` of a train shape on the rank's rows (``"fsdp"``: FSDP's
  "embed" forced onto the rules), its metrics, its router gradients before
  the data ranks' sum, its parameter and moment shards after the step.
  With ``"unsharded": true`` the unsharded port's step on the same tree
  and batch beside it.

Everything goes to ``WORK/rank<RANK>.pt``, keyed by case name.
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
from repro_torch.models.transformer import shard_opt_state, shard_params
from repro_torch.nn import moe
from repro_torch.nn.param import tree_map
from repro_torch.sharding import collectives
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.rules import local_slice, logical_to_spec
from repro_torch.train.step import make_train_step

#: the routing of every MoE call since the last reset
ROUTES = []


def _record_routes():
    real = moe.route

    def wrapped(params, x, cfg, **kw):
        r = real(params, x, cfg, **kw)
        k = cfg.moe.num_experts_per_token
        top = torch.topk(r.probs, k + 1, dim=-1).values
        ROUTES.append({"mode": kw.get("mode", "train"), "cap": r.cap,
                       "experts": r.e_k.detach().clone(),
                       "margin": (top[..., k - 1] - top[..., k]).min().item()})
        return r

    moe.route = wrapped


def _routes():
    out = list(ROUTES)
    ROUTES.clear()
    return out


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


def _weights(work, case, cfg):
    with np.load(work.parent / case["weights"]) as npz:
        return params_from_jax(_tree(npz), cfg, device="cpu")


def run(prefill, decode, model, tokens, case, batch):
    """Prefill ``tokens`` (this rank's rows of a batch of ``batch``) and
    take the decode steps: (the logits of each call, the greedy tokens)."""
    b, s = tokens.shape
    cache = model.init_cache(batch, case["cache"], 0, device="cpu")
    cache = tree_map(lambda c: c.float(), cache)
    logits, cache, _ = prefill({"tokens": tokens}, cache)
    out = [logits]
    nxt = logits[:, -1].argmax(-1)
    toks = [nxt]
    for t in range(case["steps"]):
        pos = torch.full((b,), s + t, dtype=torch.long)
        lg, cache = decode(nxt[:, None], pos, cache)
        out.append(lg)
        nxt = lg[:, -1].argmax(-1)
        toks.append(nxt)
    return out, torch.stack(toks, 1)


def serve(work, case, mesh_cfg, mesh, coords):
    cfg = config(case)
    tokens = torch.from_numpy(np.load(work.parent / case["inputs"]))
    b, s = tokens.shape
    pre = ShapeConfig("prefill", s, b, "prefill")
    dec = ShapeConfig("decode", case["cache"], b, "decode")
    rules, notes = rules_for(cfg, mesh_cfg, dec)
    tree = _weights(work, case, cfg)
    local = shard_params(cfg, tree, mesh, rules)
    step_pre, model = _build_step(cfg, pre, mesh_cfg, rules)(mesh, local)
    step_dec, _ = _build_step(cfg, dec, mesh_cfg, rules)(mesh, local)
    rows = local_slice(tokens, logical_to_spec(("batch", "seq"),
                                               mesh_cfg.axes, rules),
                       mesh_cfg, coords)
    collectives.reset_counts()
    _routes()
    logits, toks = run(step_pre, step_dec, model, rows, case, b)
    rec = {"logits": logits, "tokens": toks, "routes": _routes(),
           "counts": collectives.counts_by_name(), "notes": notes,
           "rules": {a: rules.lookup(a) for a in (
               "batch", "experts", "expert_ff", "heads", "kv_heads",
               "kv_seq")}}
    if case.get("unsharded"):
        dp = mesh_cfg.dp_size
        whole = get_model(cfg).load_tree(tree)
        logits, toks = run(
            lambda bt, c: whole.forward(bt, "prefill", cache=c, dp_size=dp),
            lambda t, p, c: whole.decode_step(t, p, c, dp_size=dp), whole,
            tokens, case, b)
        rec["unsharded"] = {"logits": logits, "tokens": toks,
                            "routes": _routes()}
    return rec


def train(work, case, mesh_cfg, mesh, coords):
    cfg = config(case)
    with np.load(work.parent / case["inputs"]) as npz:
        batch = {k: torch.from_numpy(npz[k]).long()
                 for k in ("tokens", "labels")}
    b, s = batch["tokens"].shape
    shape = ShapeConfig("train", s, b, "train")
    rules, _ = rules_for(cfg, mesh_cfg, shape)
    if case.get("fsdp"):
        rules = rules.replace(embed=("data",))
    tree = _weights(work, case, cfg)
    local = shard_params(cfg, tree, mesh, rules)
    zeros = {"m": tree_map(torch.zeros_like, tree),
             "v": tree_map(torch.zeros_like, tree),
             "step": torch.zeros((), dtype=torch.int32)}
    tcfg = TrainConfig(**case["tcfg"])
    step, _ = _build_step(cfg, shape, mesh_cfg, rules, tcfg=tcfg,
                          microbatches=1)(mesh, local)
    opt = shard_opt_state(cfg, zeros, mesh, rules)
    spec = logical_to_spec(("batch", "seq"), mesh_cfg.axes, rules)
    rows = {k: local_slice(v, spec, mesh_cfg, coords)
            for k, v in batch.items()}
    collectives.reset_counts()
    _routes()
    grads, metrics = step.accumulate(local, rows)
    router = grads["layers"]["mlp"]["router"].clone()
    local, opt, metrics = step.finish(local, opt, grads, metrics)
    rec = {"metrics": {k: float(v) for k, v in metrics.items()},
           "router_grad": router, "routes": _routes(),
           "counts": collectives.counts_by_name(), "params": _clone(local),
           "m": _clone(opt["m"]), "embed": rules.lookup("embed")}
    if case.get("unsharded"):
        whole = get_model(cfg).load_tree(tree)
        p, st, m = make_train_step(whole, tcfg, dp_size=mesh_cfg.dp_size)(
            tree, zeros, batch)
        rec["unsharded"] = {"metrics": {k: float(v) for k, v in m.items()},
                            "params": _clone(p), "m": _clone(st["m"])}
    return rec


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def main(work, rank, world):
    torch.set_num_threads(1)
    _record_routes()
    spec = json.loads((work / "cases.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world)
    try:
        mesh_cfg = MeshConfig(tuple(spec["mesh"]), ("data", "model"))
        mesh = make_mesh(mesh_cfg, "cpu")
        coords = dict(zip(mesh_cfg.axes, (int(c) for c in
                                           mesh.get_coordinate())))
        out = {"coords": coords}
        for case in spec["cases"]:
            fn = serve if case["kind"] == "serve" else train
            out[case["name"]] = fn(work, case, mesh_cfg, mesh, coords)
        torch.save(out, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))

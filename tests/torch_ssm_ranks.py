"""One rank of the port's sharded ssm and hybrid families on the CPU, for
``tests/test_torch_ssm_mesh.py``: imports torch and the port only.

Run as ``python tests/torch_ssm_ranks.py WORK RANK WORLD``.
``WORK/cases.json`` holds the mesh and a list of cases, run one after
another in the one gloo group (over ``WORK/store``, one intra-op thread);
the whole parameter trees (keys ``a/b/c``) and the inputs lie one
directory up, shared by every mesh:

* ``"kind": "serve"``: the config (reduced arch, fp32), the global batch
  (``<inputs>.npy``: the prompts), the cache's rows and the decode steps.
  The rules are ``rules_for``'s at a decode of the batch into the cache.
  The rank carves its shards, prefills its rows of the batch through the
  dry run's ``_build_step``, takes the decode steps with its own greedy
  tokens and keeps its logits, tokens, final cache, collectives and the
  heads each of K11, the SSD scan and K10 was given.  With
  ``"unsharded": true`` it also runs the unsharded port on the whole
  batch and keeps the same.
* ``"kind": "train"``: ``<inputs>.npz`` (tokens, labels); one step through
  ``_build_step`` of a train shape on the rank's rows: its metrics, its
  parameter and moment shards after the step, its collectives.  With
  ``"unsharded": true`` the unsharded port's step on the same tree and
  batch beside it.

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
from repro_torch.nn import attention, rwkv, ssm
from repro_torch.nn.param import tree_map
from repro_torch.sharding import collectives
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.rules import local_slice, logical_to_spec
from repro_torch.train.step import make_train_step

#: the heads each kernel (or the SSD scan) was given since the last reset
HEADS = {"K11": set(), "ssd": set(), "K10": set()}


def _record_heads():
    """Wrap K11's wrapper and the per-step WKV, the SSD scan and K10's
    wrapper where the model code calls them, to keep the heads of each
    call's operands."""
    def wrap(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            HEADS[key].add(int(a[0].shape[2]))
            return real(*a, **kw)
        setattr(mod, name, wrapped)

    wrap(rwkv, "wkv6", "K11")
    wrap(rwkv, "wkv6_reference", "K11")
    wrap(ssm, "_ssd_chunked", "ssd")
    wrap(attention, "flash_attention", "K10")


def _heads():
    out = {k: sorted(v) for k, v in HEADS.items()}
    for v in HEADS.values():
        v.clear()
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
    take the decode steps: (the logits of each call, the greedy tokens,
    the final cache)."""
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
    return out, torch.stack(toks, 1), cache


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
    _heads()
    logits, toks, cache = run(step_pre, step_dec, model, rows, case, b)
    rec = {"logits": logits, "tokens": toks, "cache": cache,
           "heads": _heads(), "counts": collectives.counts_by_name(),
           "notes": notes,
           "rules": {a: rules.lookup(a) for a in (
               "batch", "heads", "kv_heads", "kv_seq", "ssm_inner", "ff")}}
    if case.get("unsharded"):
        whole = get_model(cfg).load_tree(tree)
        logits, toks, cache = run(
            lambda bt, c: whole.forward(bt, "prefill", cache=c),
            lambda t, p, c: whole.decode_step(t, p, c), whole, tokens,
            case, b)
        rec["unsharded"] = {"logits": logits, "tokens": toks,
                            "cache": cache}
    return rec


def train(work, case, mesh_cfg, mesh, coords):
    cfg = config(case)
    with np.load(work.parent / case["inputs"]) as npz:
        batch = {k: torch.from_numpy(npz[k]).long()
                 for k in ("tokens", "labels")}
    b, s = batch["tokens"].shape
    shape = ShapeConfig("train", s, b, "train")
    rules, _ = rules_for(cfg, mesh_cfg, shape)
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
    _heads()
    local, opt, metrics = step(local, opt, rows)
    rec = {"metrics": {k: float(v) for k, v in metrics.items()},
           "heads": _heads(), "counts": collectives.counts_by_name(),
           "params": _clone(local), "m": _clone(opt["m"])}
    if case.get("unsharded"):
        whole = get_model(cfg).load_tree(tree)
        p, st, m = make_train_step(whole, tcfg)(tree, zeros, batch)
        rec["unsharded"] = {"metrics": {k: float(v) for k, v in m.items()},
                            "params": _clone(p), "m": _clone(st["m"])}
    return rec


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def main(work, rank, world):
    torch.set_num_threads(1)
    _record_heads()
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

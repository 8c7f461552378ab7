"""One rank of the port's tensor-parallel path on the CPU, for
``tests/test_torch_tensor_parallel.py``: imports torch and the port only.

Run as ``python tests/torch_tp_ranks.py WORK RANK WORLD``: ``WORK/case.json``
names the config, the mesh, the prefill's and the cache's lengths, the
cache's type (the model's cache cast to it) and the decode steps; ``WORK/params.npz`` holds the whole parameter tree
(keys ``a/b/c``) and ``WORK/tokens.npy`` the prompts.  The rank joins a
gloo group over ``WORK/store``, carves its shards (``shard_params``),
prefills its rows of the batch through the dry run's ``_build_step``,
takes the decode steps with its own greedy tokens, and writes what it
saw to ``WORK/rank<RANK>.pt``.  With ``"unsharded": true`` it also runs
the unsharded port on the same weights and writes that beside.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.config import MeshConfig, ShapeConfig, get_arch
from repro_torch.launch.dryrun import _build_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.common import params_from_jax
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import shard_params
from repro_torch.sharding import collectives
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.rules import local_slice, logical_to_spec


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
    base = get_arch(case["arch"]).reduced()
    return dataclasses.replace(base, dtype=case["dtype"],
                               param_dtype=case["dtype"],
                               **case.get("overrides", {}))


def run(step_pre, step_dec, model, tokens, case, batch):
    """Prefill ``tokens`` (this rank's rows of a batch of ``batch``) and
    take the decode steps: (prefill logits, the decode steps' logits,
    their greedy tokens, the cache)."""
    b, s = tokens.shape
    cache = {k: c.to(getattr(torch, case["cache_dtype"])) for k, c in
             model.init_cache(batch, case["cache"], 0, device="cpu").items()}
    logits, cache, _ = step_pre({"tokens": tokens}, cache)
    out = [logits]
    nxt = logits[:, -1].argmax(-1)
    toks = [nxt]
    for t in range(case["steps"]):
        pos = torch.full((b,), s + t, dtype=torch.long)
        lg, cache = step_dec(nxt[:, None], pos, cache)
        out.append(lg)
        nxt = lg[:, -1].argmax(-1)
        toks.append(nxt)
    return out, torch.stack(toks, 1), cache


def main(work, rank, world):
    torch.set_num_threads(1)
    case = json.loads((work / "case.json").read_text())
    dist.init_process_group("gloo", init_method=f"file://{work / 'store'}",
                            rank=rank, world_size=world)
    try:
        cfg = config(case)
        mesh_cfg = MeshConfig(tuple(case["mesh"]), ("data", "model"))
        mesh = make_mesh(mesh_cfg, "cpu")
        coords = dict(zip(mesh_cfg.axes, mesh.get_coordinate()))
        tokens = torch.from_numpy(np.load(work / "tokens.npy"))
        b, s = tokens.shape
        pre = ShapeConfig("prefill", s, b, "prefill")
        dec = ShapeConfig("decode", case["cache"], b, "decode")
        rules, _ = rules_for(cfg, mesh_cfg, dec)
        with np.load(work / "params.npz") as npz:
            tree = params_from_jax(_tree(npz), cfg, device="cpu")
        local = shard_params(cfg, tree, mesh, rules)
        step_pre, model = _build_step(cfg, pre, mesh_cfg, rules)(mesh, local)
        step_dec, _ = _build_step(cfg, dec, mesh_cfg, rules)(mesh, local)
        rows = local_slice(tokens, logical_to_spec(("batch", "seq"),
                                                   mesh_cfg.axes, rules),
                           mesh_cfg, coords)
        collectives.reset_counts()
        logits, toks, cache = run(step_pre, step_dec, model, rows, case, b)
        rec = {"coords": coords, "logits": logits, "tokens": toks,
               "cache": cache, "counts": collectives.counts_by_name()}
        if case.get("unsharded"):
            whole = get_model(cfg).load_tree(tree)

            def pre_1(batch, c):
                return whole.forward(batch, "prefill", cache=c)

            def dec_1(t, p, c):
                return whole.decode_step(t, p, c)

            rec["unsharded"] = run(pre_1, dec_1, whole, rows, case,
                                   rows.shape[0])
        torch.save(rec, work / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))

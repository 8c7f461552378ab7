"""The port's kv-sequence sharding on the CPU: the cache cut by sequence
("kv_seq") and q heads cut over whole kv heads, in reduced fp32 models on
gloo ranks, against the JAX package's unsharded jitted forward,
``decode_step`` and ``make_train_step`` on the same weights.

The ranks (``tests/torch_kvseq_ranks.py``) are processes of their own
that import torch and the port only; one spawn a mesh runs every case of
that mesh, one after another, and JAX runs once a case, here.  The rules
are ``rules_for``'s:

* 1 x 4, reduced qwen1.5 (4 q heads over 2 kv heads): kv heads whole,
  the cache cut over "model", one q head a rank; a 5-token prompt into 8
  rows a rank, so three ranks start with no valid row;
* the same with 6 q heads (q heads whole, the cache cut over "model");
* reduced starcoder2 (its 64-row window): an 80-token prompt, the ring
  wrapped across the four ranks' 16 rows each;
* the int8 cache on the first case;
* one train step of reduced starcoder2 (q heads cut over whole kv heads,
  the backward of the replicated ``wk`` and ``wv``);
* 2 x 2, batch 1 and one kv head: the batch replicated, the cache cut
  over ("data", "model");
* 1 x 2, 6 q heads over 3 kv heads: rank 0's q heads 0-2 read kv heads
  0, 0 and 1, which straddle.

Held: the logits within ``TOL`` x max(1, |logits|) of JAX's (the int8
cache to ``tests/test_torch_kv_quant.py``'s limits), the greedy tokens
equal, each rank's cache rows the matching rows of JAX's cache, the
softmax's exchanges counted once a layer a step; the train step's
metrics and new shards against JAX's, its ``wk`` and ``wv`` gradients
the same bits on every rank.  Beside them, on meta tensors: the cache
that ``init_cache`` lays out at the JAX package's two production meshes
for every dense arch and serving shape, against the dry run's bytes.
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
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.core import config as tconfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models import registry as tregistry
from repro_torch.models.transformer import TransformerLM
from repro_torch.nn.param import tree_leaves
from repro_torch.sharding.auto import rules_for
from repro_torch.sharding.rules import (local_shape, local_slice,
                                        logical_to_spec)

ROOT = Path(__file__).resolve().parent.parent
#: relative to max(1, max|JAX logits|): the same fp32 arithmetic, the
#: softmax's max, sums and partial outputs exchanged over the ranks
TOL = 1e-5
#: the int8 cache (tests/test_torch_kv_quant.py): a k or v whose fp32
#: value differs in its last bits may quantize to the neighbouring int8
KVQ_TOL = {"prefill": 1e-4, "decode": 2e-3}
TC = dict(learning_rate=1e-3, warmup_steps=1, total_steps=10)

QWEN, STARCODER = "qwen1.5-32b", "starcoder2-15b"
#: name -> (mesh, arch, overrides, batch, prompt, cache rows, steps)
SERVE = {
    "q_cut": ((1, 4), QWEN, {}, 2, 5, 32, 4),
    "q_whole": ((1, 4), QWEN, {"num_heads": 6}, 2, 12, 32, 4),
    "ring": ((1, 4), STARCODER, {}, 2, 80, 128, 4),
    "int8": ((1, 4), QWEN, {"kv_quant": True}, 2, 5, 32, 4),
    "data_model": ((2, 2), QWEN, {"num_kv_heads": 1}, 1, 12, 32, 4),
    "straddle": ((1, 2), QWEN, {"num_heads": 6, "num_kv_heads": 3}, 2,
                 12, 24, 4),
}
#: the train case: (mesh, arch, batch, seq)
TRAIN = ((1, 4), STARCODER, 2, 16)
MESHES = ((1, 4), (2, 2), (1, 2))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, overrides):
    return tuple(dataclasses.replace(m.get_arch(arch).reduced(),
                                     dtype="float32", param_dtype="float32",
                                     **overrides)
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
    return {k: np.asarray(v) for k, v in _leaves(tree).items()}


def _jax_serve(name):
    """JAX's weights, prompts, the logits of its prefill and decode
    steps, its greedy tokens and its final cache."""
    _, arch, over, batch, prompt, rows, steps = SERVE[name]
    jcfg, _ = _cfgs(arch, over)
    jm = jregistry.get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)
    pre = jax.jit(lambda p, t, c: jm.forward(p, {"tokens": t}, "prefill",
                                             cache=c))
    dec = jax.jit(lambda p, t, pos, c: jm.decode_step(p, t, pos, c))
    cache = jm.init_cache(batch, rows)
    if not jcfg.kv_quant:
        cache = jax.tree_util.tree_map(lambda c: c.astype(jnp.float32),
                                       cache)
    logits, cache, _ = pre(jp, jnp.asarray(toks), cache)
    out = [np.asarray(logits)]
    nxt = np.asarray(logits[:, -1].argmax(-1))
    tokens = [nxt]
    for t in range(steps):
        pos = np.full((batch,), prompt + t, np.int32)
        lg, cache = dec(jp, jnp.asarray(nxt[:, None]), jnp.asarray(pos),
                        cache)
        out.append(np.asarray(lg))
        nxt = np.asarray(lg[:, -1].argmax(-1))
        tokens.append(nxt)
    return {"params": _flat(jax.tree_util.tree_map(np.asarray, jp)),
            "tokens_in": toks, "logits": out,
            "tokens": np.stack(tokens, 1), "cache": _flat(cache)}


def _jax_train():
    _, arch, b, s = TRAIN
    jcfg, _ = _cfgs(arch, {})
    jm = jregistry.get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(7).integers(0, jcfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    fn = jax.jit(jstep.make_train_step(jm, jconfig.TrainConfig(**TC),
                                       dp_size=1, microbatches=1))
    p, st, m = fn(jp, jopt.adamw_init(jp),
                  {k: jnp.asarray(v) for k, v in batch.items()})
    return {"params0": _flat(jax.tree_util.tree_map(np.asarray, jp)),
            "batch": batch, "params": _flat(p), "m": _flat(st["m"]),
            "metrics": {k: float(v) for k, v in m.items()}}


_RUNS = {}


def _run(mesh, tmp_path_factory):
    """Every case of ``mesh`` on its ranks, spawned once: (JAX's records
    by case name, the ranks' records)."""
    if mesh in _RUNS:
        return _RUNS[mesh]
    work = tmp_path_factory.mktemp(f"kvseq{mesh[0]}x{mesh[1]}")
    refs, cases = {}, []
    for name, (m, arch, over, batch, _, rows, steps) in SERVE.items():
        if m != mesh:
            continue
        refs[name] = ref = _jax_serve(name)
        np.savez(work / f"{name}.npz", **ref["params"])
        np.save(work / f"{name}_tokens.npy", ref["tokens_in"])
        cases.append(dict(kind="serve", name=name, arch=arch,
                          overrides=over, cache=rows, steps=steps,
                          cache_dtype="float32"))
    if TRAIN[0] == mesh:
        refs["train"] = ref = _jax_train()
        np.savez(work / "train.npz", **ref["params0"])
        np.savez(work / "train_batch.npz", **ref["batch"])
        cases.append(dict(kind="train", name="train", arch=TRAIN[1],
                          tcfg=TC))
    (work / "cases.json").write_text(json.dumps({"mesh": list(mesh),
                                                 "cases": cases}))
    world = math.prod(mesh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_kvseq_ranks.py"),
         str(work), str(r), str(world)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    recs = [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
    _RUNS[mesh] = refs, recs
    return refs, recs


def _close(ours, ref, tol):
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _slice(arr, spec, mesh_cfg, coords):
    return local_slice(torch.from_numpy(np.array(arr)), spec, mesh_cfg,
                       coords).numpy()


@pytest.mark.parametrize("name", tuple(SERVE))
def test_sharded_serving_matches_jax(tmp_path_factory, name):
    mesh, arch, over, batch, prompt, rows, steps = SERVE[name]
    refs, recs = _run(mesh, tmp_path_factory)
    ref = refs[name]
    _, tcfg = _cfgs(arch, over)
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    rules, notes = rules_for(tcfg, mesh_cfg, tconfig.ShapeConfig(
        "decode", rows, batch, "decode"))
    kv_axes = rules.lookup("kv_seq")
    assert kv_axes is not None and "model" in kv_axes, notes
    quant = tcfg.kv_quant
    bspec = logical_to_spec(("batch", None), mesh_cfg.axes, rules)
    cspec = {k: logical_to_spec(p.axes, mesh_cfg.axes, rules) for k, p in
             _leaves(tregistry.get_model(tcfg).cache_spec(
                 batch, rows, 0)).items()}
    layers = tcfg.num_layers
    for rank in recs:
        coords, rec = rank["coords"], rank[name]
        assert rec["kv_seq"] == kv_axes
        for step, (lg, want) in enumerate(zip(rec["logits"],
                                              ref["logits"])):
            tol = (KVQ_TOL["prefill" if step == 0 else "decode"] if quant
                   else TOL)
            _close(lg.numpy(), _slice(want, bspec + (None,), mesh_cfg,
                                      coords), tol)
        np.testing.assert_array_equal(
            rec["tokens"].numpy(), _slice(ref["tokens"], bspec, mesh_cfg,
                                          coords))
        got = _leaves(rec["cache"])
        assert sorted(got) == sorted(ref["cache"]) == sorted(cspec)
        for k, t in got.items():
            want = _slice(ref["cache"][k], cspec[k], mesh_cfg, coords)
            if not quant:
                _close(t.numpy(), want, TOL)
            elif k.endswith("_scale"):
                a, b = t.float().numpy(), want.astype(np.float32)
                assert np.all(np.abs(a - b) <= np.abs(b) * 2.0 ** -10), k
            else:
                a, b = t.numpy().astype(np.int32), want.astype(np.int32)
                assert np.abs(a - b).max() <= 1, k
                assert (a != b).mean() < 0.01, k
        # a decode step's softmax: one max over the cache's shards a layer
        axes = "+".join(a for a in kv_axes if mesh_cfg.size(a) > 1)
        assert rec["counts"][f"max_over/{axes}"]["calls"] == \
            steps * layers
        if rules.lookup("heads") is not None:  # q gathered a layer a step
            assert rec["counts"]["gather_over/model"]["calls"] == \
                steps * layers + 1 + steps


def test_ranks_of_a_mesh_agree(tmp_path_factory):
    """Every case's logits are the same bits on every rank of its mesh:
    no case cuts the batch (dp 1, or batch 1 replicated at 2 x 2), and
    every exchange sums in rank order."""
    for mesh in MESHES:
        _, recs = _run(mesh, tmp_path_factory)
        for name in SERVE:
            if SERVE[name][0] != mesh:
                continue
            for rank in recs[1:]:
                for x, y in zip(recs[0][name]["logits"],
                                rank[name]["logits"]):
                    assert torch.equal(x, y), name


def test_train_step_with_q_heads_cut_over_whole_kv_heads(tmp_path_factory):
    """Reduced starcoder2 at 1 x 4: each rank's q head reads one of the 2
    whole kv heads; one step's metrics within 1e-4 of JAX's, its moments
    and new shards to ``tests/test_torch_train.py``'s limits, and the
    ``wk``/``wv`` gradients the same bits on the four ranks."""
    mesh, arch, b, s = TRAIN
    refs, recs = _run(mesh, tmp_path_factory)
    ref = refs["train"]
    _, tcfg = _cfgs(arch, {})
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    rules, _ = rules_for(tcfg, mesh_cfg,
                         tconfig.ShapeConfig("train", s, b, "train"))
    assert rules.lookup("heads") == "model" and rules.lookup(
        "kv_heads") is None
    spec = _leaves(TransformerLM(tcfg).param_spec())
    lr = ref["metrics"]["lr"]
    for rank in recs:
        coords, rec = rank["coords"], rank["train"]
        for k, v in ref["metrics"].items():
            assert abs(rec["metrics"][k] - v) <= 1e-4 * max(1.0, abs(v)), k
        params, mom = _leaves(rec["params"]), _leaves(rec["m"])
        for k, want in ref["params"].items():
            ps = logical_to_spec(spec[k].axes, mesh_cfg.axes, rules)
            _close(mom[k].numpy(), _slice(ref["m"][k], ps, mesh_cfg,
                                          coords), 1e-4)
            a, b_ = params[k].numpy(), _slice(want, ps, mesh_cfg, coords)
            m = np.abs(_slice(ref["m"][k], ps, mesh_cfg, coords))
            tiny = m <= 1e-3 * max(float(m.max()), 1e-30)
            err = np.abs(a - b_)
            assert (err[~tiny] <= 1e-6 * np.maximum(1.0, np.abs(b_[~tiny]))
                    + 1e-3 * lr).all(), k
            assert (err[tiny] <= 2.02 * lr + 1e-6).all(), k
        # k and v entered the head selection through copy_to: their
        # cotangents summed over "model" once a layer each
        assert rec["counts"]["copy_to.bwd/model"]["calls"] >= 2 * \
            tcfg.num_layers
        for n, g in rec["kv_grads"].items():
            assert torch.equal(g, recs[0]["train"]["kv_grads"][n]), n


#: the dense archs and serving shapes the JAX package's dry run lowers at
#: its two production meshes
DENSE = ("gemma2-2b", "starcoder2-15b", "internlm2-20b", "qwen1.5-32b")
SERVING = ("prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("mesh_name", ("16x16", "2x16x16"))
@pytest.mark.parametrize("shape_name", SERVING)
@pytest.mark.parametrize("arch", DENSE)
def test_init_cache_is_the_dry_runs_cache(arch, shape_name, mesh_name):
    """``init_cache`` on meta tensors: every leaf the local shape of its
    logical axes' spec under ``rules_for`` (the cache cut by sequence
    where the kv heads do not divide "model" or the batch does not divide
    dp), and its bytes the dry run's ``cache`` bytes."""
    mesh_cfg = parse_mesh(mesh_name)
    shape = tconfig.get_shape(shape_name)
    cfg = tconfig.get_arch(arch)
    if dryrun.kv_quant_switch(cfg, shape, mesh_cfg):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    rules, _ = rules_for(cfg, mesh_cfg, shape)
    model = TransformerLM(cfg, mesh_cfg, rules)
    window = model.effective_window(shape)
    cache = model.init_cache(shape.global_batch, shape.seq_len, window,
                             device="meta")
    spec = model.cache_spec(shape.global_batch, shape.seq_len, window)
    got, want = _leaves(cache), _leaves(spec)
    assert sorted(got) == sorted(want)
    for k, p in want.items():
        assert tuple(got[k].shape) == local_shape(
            p.shape, logical_to_spec(p.axes, mesh_cfg.axes, rules),
            mesh_cfg), k
    rec = dryrun.run_one(arch, shape_name, mesh_cfg, trace=False)
    assert sum(t.numel() * t.element_size() for t in tree_leaves(cache)) \
        == rec["per_device_bytes"]["cache"]


#: (arch or a reduced override, mesh): q heads cut over whole kv heads as
#: ``rules_for`` cuts them, and one whose local heads straddle kv heads
HEAD_CUTS = (("internlm2-20b", (16, 16)), ("starcoder2-15b", (1, 8)),
             ("gemma2-2b", (1, 8)), ("qwen1.5-32b:reduced", (1, 4)),
             ("qwen1.5-32b:straddle", (1, 2)))


@pytest.mark.parametrize("arch,mesh", HEAD_CUTS,
                         ids=[a for a, _ in HEAD_CUTS])
def test_local_q_heads_read_jax_repeats_kv_heads(arch, mesh):
    """Under ``rules_for``'s rules (q heads cut, kv heads whole), every
    model rank's selection gives local q head i (global ``r * h + i``)
    the kv head ``g // (H / kvh)`` that JAX's ``jnp.repeat`` gives it,
    read through K10's own ``i // (h / kvh_selected)``."""
    from repro_torch.nn.attention import _local_kv
    from repro_torch.sharding.ctx import Sharding, installed

    name, _, kind = arch.partition(":")
    cfg = tconfig.get_arch(name)
    if kind:
        cfg = cfg.reduced()
    if kind == "straddle":
        cfg = dataclasses.replace(cfg, num_heads=6, num_kv_heads=3)
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    rules, _ = rules_for(cfg, mesh_cfg, tconfig.get_shape("decode_32k"))
    assert rules.lookup("heads") == "model"
    assert rules.lookup("kv_heads") is None
    H, kvh = cfg.num_heads, cfg.num_kv_heads
    h = H // mesh[1]
    k = torch.arange(kvh, dtype=torch.float32).reshape(1, 1, kvh, 1)
    straddled = False
    for r in range(mesh[1]):
        with installed(Sharding(None, mesh_cfg, rules,
                                {"data": 0, "model": r})):
            sel = _local_kv(k, h)
        group = h // sel.shape[2]
        straddled |= sel.shape[2] == h and h > 1
        for i in range(h):
            assert sel[0, 0, i // group, 0] == (r * h + i) // (H // kvh)
    assert straddled == (kind == "straddle")


def test_shard_rows_follow_local_slice():
    """``shard_rows``: the offset and the whole size of a rank's rows of a
    dimension cut over ("data", "model"), the rows ``local_slice`` carves
    for it; whole without a cut."""
    from repro_torch.sharding.ctx import Sharding, installed, shard_rows

    mesh_cfg = tconfig.MeshConfig((2, 8), ("data", "model"))
    rules = rules_for(tconfig.get_arch("starcoder2-15b"), mesh_cfg,
                      tconfig.get_shape("long_500k"))[0]
    assert rules.lookup("kv_seq") == ("data", "model")
    seq = torch.arange(64)
    spec = logical_to_spec(("kv_seq",), mesh_cfg.axes, rules)
    for d in range(2):
        for m in range(8):
            coords = {"data": d, "model": m}
            with installed(Sharding(None, mesh_cfg, rules, coords)):
                off, total, axes = shard_rows("kv_seq", 4)
                assert shard_rows("seq", 4) == (0, 4, ())
            assert (total, axes) == (64, ("data", "model"))
            assert torch.equal(local_slice(seq, spec, mesh_cfg, coords),
                               torch.arange(off, off + 4))

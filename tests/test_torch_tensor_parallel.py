"""The port's tensor-parallel path on the CPU: reduced qwen1.5-32b in fp32
on gloo ranks against the JAX package's unsharded jitted forward and
``decode_step`` on the same weights.

The ranks (``tests/torch_tp_ranks.py``) are processes of their own that
import torch and the port only, joined over a ``FileStore``; JAX runs
once, here.  Each rank carves its shards of JAX's weights
(``params_from_jax`` then ``shard_params``), prefills its rows of the
batch through the dry run's ``_build_step`` and takes ``STEPS`` decode
steps with its own greedy tokens.  Held: the logits within ``TOL`` x
max(1, |logits|) of JAX's, the greedy tokens equal, each rank's cache
shard the matching slice of JAX's cache, the logits equal bit for bit on
the ranks of one data group, and the collectives a step.  The 1 x 1 mesh
gives the unsharded port's bits.

The cache of these cases is fp32 on both sides (the models' bf16 cache
cast): a k or v whose fp32 value differs in its last bits between the
two packages may round to the neighbouring bf16 value, and a decode step
reading it then moves by 1e-4 to 2e-3 of the logits, the port's
unsharded path as much as the sharded one (``tests/test_torch_lm.py``
allows 2e-3 there).  The case on the models' own bf16 cache holds the
prefill to ``TOL`` and the decode steps and the cache to those limits.
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
from repro_torch.core import config as tconfig
from repro_torch.kernels.matmul_fused.ops import matmul_fused
from repro_torch.launch.dryrun import _build_step
from repro_torch.models.transformer import TransformerLM
from repro_torch.sharding.auto import rules_for

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen1.5-32b"
#: prompts of PROMPT tokens into a cache of CACHE rows, then STEPS steps
PROMPT, CACHE, STEPS = 12, 24, 4
#: relative to max(1, max|JAX logits|): the same fp32 arithmetic, the
#: row-parallel sums split over the ranks
TOL = 1e-5
#: the bf16 cache: a k or v whose fp32 value differs in its last bits may
#: round to the neighbouring bf16 value, and a decode step reading it
#: moves with it (tests/test_torch_lm.py's fp32 TOL)
BF16_CACHE_TOL = {"cache": 2.0 ** -7, "decode": 2e-3}
#: (mesh, batch, kv heads): 1 x 2 and 2 x 2 at the reduced config's 2 kv
#: heads, 1 x 4 at 4
MESHES = (((1, 2), 2, 2), ((2, 2), 4, 2), ((1, 4), 2, 4))


def _case(kv, cache_dtype="float32"):
    overrides = {} if kv == 2 else {"num_kv_heads": kv}
    return {"arch": ARCH, "dtype": "float32", "overrides": overrides,
            "cache": CACHE, "steps": STEPS, "cache_dtype": cache_dtype}


def _configs(case):
    return tuple(dataclasses.replace(m.get_arch(ARCH).reduced(),
                                     dtype=case["dtype"],
                                     param_dtype=case["dtype"],
                                     **case["overrides"])
                 for m in (jconfig, tconfig))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


_JAX = {}


def _jax_run(case, batch):
    """JAX's weights, prompts, and its prefill + decode logits, greedy
    tokens and final cache (the forward and ``decode_step`` jitted)."""
    key = (json.dumps(case, sort_keys=True), batch)
    if key in _JAX:
        return _JAX[key]
    jcfg, _ = _configs(case)
    jm = jregistry.get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (batch, PROMPT)).astype(np.int32)
    pre = jax.jit(lambda p, t, c: jm.forward(p, {"tokens": t}, "prefill",
                                             cache=c))
    dec = jax.jit(lambda p, t, pos, c: jm.decode_step(p, t, pos, c))
    cache = jax.tree_util.tree_map(lambda c: c.astype(case["cache_dtype"]),
                                   jm.init_cache(batch, CACHE))
    logits, cache, _ = pre(jp, jnp.asarray(toks), cache)
    out = [np.asarray(logits)]
    nxt = np.asarray(logits[:, -1].argmax(-1))
    tokens = [nxt]
    for t in range(STEPS):
        pos = np.full((batch,), PROMPT + t, np.int32)
        lg, cache = dec(jp, jnp.asarray(nxt[:, None]), jnp.asarray(pos),
                        cache)
        out.append(np.asarray(lg))
        nxt = np.asarray(lg[:, -1].argmax(-1))
        tokens.append(nxt)
    rec = (_flat(jax.tree_util.tree_map(np.asarray, jp)), toks, out,
           np.stack(tokens, 1),
           jax.tree_util.tree_map(lambda c: np.asarray(c, np.float32), cache))
    _JAX[key] = rec
    return rec


def _spawn(tmp_path, case, mesh, params, tokens):
    """Run ``prod(mesh)`` ranks over a FileStore; their records."""
    work = tmp_path / "work"
    work.mkdir()
    (work / "case.json").write_text(json.dumps(dict(case, mesh=list(mesh))))
    np.savez(work / "params.npz", **params)
    np.save(work / "tokens.npy", tokens)
    world = int(np.prod(mesh))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_tp_ranks.py"),
         str(work), str(r), str(world)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


def _close(ours, ref, tol):
    a, b = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _check(recs, case, mesh, batch, kv, jax_rec, decode_tol, cache_tol):
    """The ranks' records against JAX's, and against each other."""
    _, _, jlogits, jtokens, jcache = jax_rec
    dp, m = mesh
    rows = batch // dp
    layers = _configs(case)[1].num_layers
    for rec in recs:
        d, j = rec["coords"]["data"], rec["coords"]["model"]
        sl = slice(d * rows, (d + 1) * rows)
        for step, (lg, ref) in enumerate(zip(rec["logits"], jlogits)):
            _close(lg.numpy(), ref[sl], TOL if step == 0 else decode_tol)
        np.testing.assert_array_equal(rec["tokens"].numpy(), jtokens[sl])
        kvh = kv // m
        for name in ("k", "v"):
            want = jcache[name][:, sl, :, j * kvh:(j + 1) * kvh]
            _close(rec["cache"][name].float().numpy(), want, cache_tol)
        # one step of the model's collectives: per layer o and down, then
        # the embedding's sum and the logits' gather
        steps = 1 + STEPS
        assert rec["counts"]["sum_over/model"]["calls"] == \
            steps * (2 * layers + 1)
        assert rec["counts"]["gather_over/model"]["calls"] == steps
    for a in recs:
        for b in recs:
            if a["coords"]["data"] == b["coords"]["data"]:
                for x, y in zip(a["logits"], b["logits"]):
                    assert torch.equal(x, y)


@pytest.mark.parametrize("mesh,batch,kv", MESHES,
                         ids=[f"{m[0]}x{m[1]}" for m, _, _ in MESHES])
def test_sharded_prefill_and_decode_match_jax(tmp_path, mesh, batch, kv):
    case = _case(kv)
    jax_rec = _jax_run(case, batch)
    recs = _spawn(tmp_path, case, mesh, jax_rec[0], jax_rec[1])
    _check(recs, case, mesh, batch, kv, jax_rec, TOL, TOL)


def test_sharded_path_on_the_bf16_cache(tmp_path):
    """The models' own bf16 cache at 1 x 2: the prefill within ``TOL``,
    the decode steps and the cache within ``BF16_CACHE_TOL``."""
    case = _case(2, "bfloat16")
    jax_rec = _jax_run(case, 2)
    recs = _spawn(tmp_path, case, (1, 2), jax_rec[0], jax_rec[1])
    _check(recs, case, (1, 2), 2, 2, jax_rec, BF16_CACHE_TOL["decode"],
           BF16_CACHE_TOL["cache"])


def test_one_by_one_mesh_gives_the_unsharded_bits(tmp_path):
    case = dict(_case(2), unsharded=True)
    params, toks, *_ = _jax_run(case, 2)
    rec, = _spawn(tmp_path, case, (1, 1), params, toks)
    logits, tokens, cache = rec["unsharded"]
    for x, y in zip(rec["logits"], logits):
        assert torch.equal(x, y)
    assert torch.equal(rec["tokens"], tokens)
    for name in ("k", "v"):
        assert torch.equal(rec["cache"][name], cache[name])
    assert rec["counts"] == {}


def test_kv_heads_not_dividing_model_raise_the_kv_seq_rule():
    """Reduced qwen1.5's 2 kv heads on a 4-way "model" axis: the rules
    shard the kv sequence and keep the kv heads whole while the q heads
    are cut; the executed path takes it: the step builds, and the rank's
    cache holds every kv head and a quarter of the rows
    (``tests/test_torch_kv_seq.py`` runs it against JAX)."""
    cfg = tconfig.get_arch(ARCH).reduced()
    mesh_cfg = tconfig.MeshConfig((1, 4), ("data", "model"))
    shape = tconfig.ShapeConfig("decode", CACHE, 2, "decode")
    rules, notes = rules_for(cfg, mesh_cfg, shape)
    assert any("kv-seq" in n for n in notes)
    assert rules.lookup("kv_seq") == ("model",)
    assert callable(_build_step(cfg, shape, mesh_cfg, rules))
    model = TransformerLM(cfg, mesh_cfg, rules)
    cache = model.init_cache(2, CACHE, device="meta")
    assert tuple(cache["k"].shape) == (cfg.num_layers, 2, CACHE // 4,
                                       cfg.num_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("rule,arch,mesh", [
    ("fsdp", "rwkv6-1.6b", (2, 1)),
    ("heads", "zamba2-1.2b", (1, 8)),
    ("family", "llama-3.2-vision-11b", (1, 2)),
    ("train", "seamless-m4t-large-v2", (1, 2)),
    ("seq_res", "qwen1.5-32b", (1, 2))])
def test_unsupported_rules_raise_and_name_themselves(rule, arch, mesh):
    cfg = tconfig.get_arch(arch).reduced()
    mesh_cfg = tconfig.MeshConfig(mesh, ("data", "model"))
    shape = tconfig.get_shape("train_4k" if rule == "train" else
                              "decode_32k")
    rules, _ = rules_for(cfg, mesh_cfg, shape)
    if rule == "seq_res":  # seq_sp's rule (launch/variants.py)
        from repro_torch.launch.variants import apply_variants

        _, rules, _, _ = apply_variants(("seq_sp",), cfg, rules,
                                        mesh_cfg.model_size)
    if rule == "fsdp":  # rules_for never sets it for the ssm family
        rules = rules.replace(embed=("data",))
    with pytest.raises(NotImplementedError) as e:
        _build_step(cfg, shape, mesh_cfg, rules)
    # "heads": the reduced zamba2's 4 attention heads whole on 8 ranks,
    # its 512-wide inner dimension cut
    word = {"fsdp": "FSDP's 'embed'", "heads": "'heads'",
            "family": "'media'", "train": "'media'",
            "seq_res": "'seq_res'"}[rule]
    assert word in str(e.value)


@pytest.mark.parametrize("act,bias", [("none", False), ("silu", True),
                                      ("gelu", True)])
def test_k3_fp32_store_plain_version(act, bias):
    """The fp32 store of bf16 operands on the CPU is the plain version's
    sum before its cast: JAX's ``matmul_fused_ref``, undowncast, to fp32
    rounding; and cast to bf16 it is K3's bf16 result bit for bit."""
    from repro.kernels.matmul_fused.ref import matmul_fused_ref as jref

    rng = np.random.default_rng(3)
    x = rng.standard_normal((37, 96)).astype(np.float32)
    w = rng.standard_normal((96, 72)).astype(np.float32)
    b = rng.standard_normal(72).astype(np.float32) if bias else None
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    bt = None if b is None else torch.from_numpy(b)
    y = matmul_fused(xb, wb, bt, act=act, out_dtype=torch.float32)
    assert y.dtype == torch.float32
    ref = np.asarray(jref(jnp.asarray(xb.float().numpy()),
                          jnp.asarray(wb.float().numpy()),
                          None if b is None else jnp.asarray(b), act))
    np.testing.assert_allclose(y.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert torch.equal(y.to(torch.bfloat16),
                       matmul_fused(xb, wb, bt, act=act))
    meta = matmul_fused(xb.to("meta"), wb.to("meta"), None,
                        out_dtype=torch.float32)
    assert meta.shape == (37, 72) and meta.dtype == torch.float32
    with pytest.raises(ValueError, match="cannot store"):
        matmul_fused(xb.float(), wb.float(), out_dtype=torch.bfloat16)

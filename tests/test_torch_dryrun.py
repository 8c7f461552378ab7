"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, without
a card.

Its per-device bytes of parameters, cache and optimizer moments equal a
sum over the JAX package's own specs (``rules_for`` and
``logical_to_spec`` of the JAX package, its ``adamw_init_spec``); its
int8-KV switch is the JAX dry run's rule; qwen1.5-32b's traced decode
step at 1 x 4 (all 64 layers, rank 0 of a fake process group of 4, meta
tensors) counts two ``sum_over`` a layer (o and down), one for the
embedding and one ``gather_over`` for the logits; at the JAX package's
own meshes (16 x 16, 2 x 16 x 16) every dense row is traced with the
cache cut by sequence, and a decode step counts the softmax's exchange
across the cache's shards; a family or rule the executed path lacks is
recorded with the rule it names.  The fake group is
destroyed when each trace ends, so no other test sees a process group.
"""
import ast
import math
from pathlib import Path

import pytest
import torch.distributed as dist

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro.sharding import auto as jauto
from repro.sharding import rules as jrules
from repro.train import optimizer as joptimizer
from repro.train import step as jstep
from repro_torch.core import config as tconfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_group, parse_mesh

ROOT = Path(__file__).resolve().parent.parent
BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1, "int32": 4}
MESHES = {"single_pod": "16x16", "multi_pod": "2x16x16", "1x4": "1x4",
          "1x8": "1x8"}


def _jax_threshold():
    """``KV_QUANT_THRESHOLD_BYTES`` of the JAX dry run, read from its
    source (importing it would set ``XLA_FLAGS`` for this process)."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in tree.body:
        if (isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "KV_QUANT_THRESHOLD_BYTES"):
            return eval(compile(ast.Expression(node.value), "", "eval"))
    raise AssertionError("no KV_QUANT_THRESHOLD_BYTES")


def _jax_kv_quant(cfg, shape, mesh):
    """The JAX dry run's int8-KV rule (``run_one``), on its configs."""
    if not shape.is_decode or cfg.is_attention_free:
        return False
    win = cfg.sliding_window or (cfg.long_context_window
                                 if shape.seq_len > 131_072 else 0)
    s_eff = min(shape.seq_len, win) if win else shape.seq_len
    n_attn = (cfg.num_layers if cfg.shared_attn_every == 0
              else cfg.num_layers // cfg.shared_attn_every)
    cache = (2 * n_attn * shape.global_batch * s_eff * cfg.num_kv_heads
             * cfg.head_dim * 2)
    return cache / mesh.num_devices > _jax_threshold()


def _jax_bytes(tree, mesh, rules, default):
    """Per-device bytes of a JAX spec tree under JAX's specs."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    total = 0
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
            continue
        n = 1
        for dim, entry in zip(t.shape, jrules.logical_to_spec(
                t.axes, mesh.axes, rules)):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * BYTES[t.dtype or default]
    return total


def _retype(tree, dtype):
    """A JAX spec tree with every leaf's dtype ``dtype``."""
    if isinstance(tree, dict):
        return {k: _retype(v, dtype) for k, v in tree.items()}
    return tree._replace(dtype=dtype)


def test_threshold_is_jax():
    assert dryrun.KV_QUANT_THRESHOLD_BYTES == _jax_threshold()


@pytest.mark.parametrize("mesh_name", ("single_pod", "1x4"))
@pytest.mark.parametrize("shape_name", ("decode_32k", "train_4k"))
@pytest.mark.parametrize("arch", ("qwen1.5-32b", "gemma2-2b", "grok-1-314b"))
def test_per_device_bytes_equal_jax_specs(arch, shape_name, mesh_name):
    import dataclasses

    tmesh = parse_mesh(MESHES[mesh_name])
    jmesh = jconfig.MeshConfig(tmesh.shape, tmesh.axes)
    rec = dryrun.run_one(arch, shape_name, tmesh)
    jcfg, shape = jconfig.get_arch(arch), jconfig.get_shape(shape_name)
    quant = _jax_kv_quant(jcfg, shape, jmesh)
    assert rec["kv_quant"] == quant
    if quant:
        jcfg = dataclasses.replace(jcfg, kv_quant=True)
    rules, notes = jauto.rules_for(jcfg, jmesh, shape)
    assert rec["sharding_notes"] == notes + (["int8 KV cache"] if quant
                                             else [])
    jm = jregistry.get_model(jcfg)
    spec = jm.param_spec()
    per = rec["per_device_bytes"]
    assert per["params"] == _jax_bytes(spec, jmesh, rules, jcfg.param_dtype)
    if shape.kind == "train":
        fsdp = dict(rules.table).get("embed") is not None
        big = jregistry.analytic_param_count(jcfg) > 100e9
        opt = joptimizer.adamw_init_spec(
            spec, zero1=True, dp_size=jmesh.dp_size, fsdp=fsdp,
            moment_dtype="bfloat16" if big else "float32")
        assert per["optimizer"] == _jax_bytes(opt, jmesh, rules, "float32")
        # the gradients in the parameters' types, and the microbatches'
        # accumulator in JAX's grad_acc_dtype
        assert per["grads"] == _jax_bytes(spec, jmesh, rules,
                                          jcfg.param_dtype)
        k = jstep.default_microbatches(
            shape.global_batch * shape.seq_len, jmesh.dp_size)
        assert rec["microbatches"] == k
        acc = _retype(spec, "bfloat16" if big else "float32")
        if k > 1:
            assert per["grad_acc"] == _jax_bytes(acc, jmesh, rules,
                                                 jcfg.param_dtype)
        else:
            assert "grad_acc" not in per
    else:
        window = jm.effective_window(shape)
        assert per["cache"] == _jax_bytes(
            jm.cache_spec(shape.global_batch, shape.seq_len, window),
            jmesh, rules, "bfloat16")
    assert per["total"] == sum(v for k, v in per.items() if k != "total")
    assert rec["fits"] == (per["total"] <= dryrun.CARD_MEMORY_BYTES)
    if arch == "grok-1-314b":  # the MoE family's steps, traced
        assert rec["traced"], rec.get("why_not_traced")
    if arch != "grok-1-314b" and shape.kind == "train" and \
            mesh_name == "1x4":
        # the dense family's train step, traced: collectives a step
        assert rec["traced"], rec.get("why_not_traced")
        assert rec["collectives"]["sum_over/model"]["calls"] > 0
    if arch != "grok-1-314b" and mesh_name == "single_pod":
        # 40 kv heads on 16 (qwen1.5), 4 on 16 (gemma2): the kv sequence
        # sharded over "model", in the executed path
        assert rec["traced"], rec.get("why_not_traced")
        assert any("kv-seq" in n for n in rec["sharding_notes"])
    assert not dist.is_initialized()


def test_traced_decode_step_counts_the_collectives():
    """qwen1.5-32b at 64 layers on 1 x 4: per layer o and down summed over
    "model", the embedding summed, the logits gathered; the bytes those
    of fp32 [128, 1, 5120] partials and the [128, 1, 38016] logits
    slices (each rank receives 3 others')."""
    rec = dryrun.run_one("qwen1.5-32b", "decode_32k", parse_mesh("1x4"))
    assert rec["traced"], rec.get("why_not_traced")
    coll = rec["collectives"]
    assert coll["sum_over/model"]["calls"] == 2 * 64 + 1
    assert coll["gather_over/model"]["calls"] == 1
    assert coll["gather_over/model"]["bytes"] == 3 * 128 * 38016 * 4
    assert coll["sum_over/model"]["bytes"] == \
        3 * (2 * 64 * 128 * 5120 * 4 + 128 * 5120 * 2)
    assert rec["logits_shape"] == [128, 1, 152064]
    assert not dist.is_initialized()


DENSE = ("gemma2-2b", "starcoder2-15b", "internlm2-20b", "qwen1.5-32b")
#: the rule each other family lacks, as ``check_executed`` names it (the
#: moe, ssm and hybrid families are traced: tests/test_torch_moe_mesh.py,
#: tests/test_torch_ssm_mesh.py)
REFUSED = {"vlm": "'media'", "audio": "'media'"}


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("mesh_name", ("single_pod", "multi_pod"))
def test_every_dense_row_traced_at_the_production_meshes(mesh_name, arch):
    """The JAX package's own meshes, 16 x 16 and 2 x 16 x 16: every shape
    of the dense family traced at full depth, the cache cut by sequence
    (no dense arch has kv heads that 16 divides)."""
    mesh = parse_mesh(MESHES[mesh_name])
    for shape in tconfig.SHAPES:
        rec = dryrun.run_one(arch, shape, mesh)
        assert rec["traced"], (shape, rec.get("why_not_traced"))
        assert any("kv-seq" in n for n in rec["sharding_notes"]), shape
    assert not dist.is_initialized()


@pytest.mark.parametrize("mesh_name", ("single_pod", "multi_pod"))
def test_other_families_refused_with_their_rule(mesh_name):
    """Every vlm and audio row at the production meshes is refused, its
    reason naming the rule the executed path lacks."""
    mesh = parse_mesh(MESHES[mesh_name])
    n = 0
    for arch in tconfig.list_archs():
        family = tconfig.get_arch(arch).family
        if family not in REFUSED:
            continue
        for shape in tconfig.SHAPES:
            rec = dryrun.run_one(arch, shape, mesh)
            assert not rec["traced"], (arch, shape)
            why = rec["why_not_traced"]
            assert REFUSED[family] in why and f"{family} family" in why, \
                (arch, shape, why)
            n += 1
    assert n == 8


def test_traced_decode_step_counts_the_softmax_exchange():
    """qwen1.5-32b's ``decode_32k`` at 16 x 16: its 40 kv heads whole
    (and its 40 q heads), the cache cut over "model" into 2048 rows a
    rank; each of the 64 layers takes the softmax's max and sums the
    exps and the partial outputs over "model" (fp32 [8, 40, 1, 1, 1] and
    [8, 1, 40, 1, 128] a rank), besides down's partial and the
    embedding's.  starcoder2-15b's q heads are cut over its 4 whole kv
    heads: q is gathered over "model" once a layer."""
    rec = dryrun.run_one("qwen1.5-32b", "decode_32k", parse_mesh("16x16"))
    assert rec["traced"], rec.get("why_not_traced")
    coll = rec["collectives"]
    stat, out, part, emb = 8 * 40 * 4, 8 * 40 * 128 * 4, 8 * 5120 * 4, \
        8 * 5120 * 2
    assert coll["max_over/model"] == {"calls": 64, "bytes": 15 * 64 * stat}
    assert coll["sum_over/model"] == {
        "calls": 3 * 64 + 1,
        "bytes": 15 * (64 * (stat + out + part) + emb)}
    assert coll["gather_over/model"]["calls"] == 1
    rec = dryrun.run_one("starcoder2-15b", "decode_32k", parse_mesh("16x16"))
    assert rec["collectives"]["gather_over/model"]["calls"] == 40 + 1
    assert rec["collectives"]["max_over/model"]["calls"] == 40
    assert not dist.is_initialized()


def test_qwen_fits_four_cards_at_four_slots_of_8192_rows():
    """The whole 64-layer qwen1.5-32b with 4 slots x 8192 rows at 1 x 4:
    17.6 GB of weights a card; its bf16 cache would hold 10.7 GB a card,
    past the JAX rule's 8 GiB, so the cache is int8 (5.45 GB with its
    fp16 scales); traced."""
    shape = tconfig.ShapeConfig("serve_4x8192", 8192, 4, "decode")
    rec = dryrun.run_one("qwen1.5-32b", shape, parse_mesh("1x4"))
    per = rec["per_device_bytes"]
    assert rec["traced"] and rec["fits"] and rec["kv_quant"]
    assert per["cache"] == 64 * 2 * 4 * 8192 * 10 * (128 + 2)
    assert 23.0e9 < per["total"] < 23.1e9
    one = dryrun.run_one("qwen1.5-32b", shape, parse_mesh("1x1"),
                         trace=False)
    assert not one["fits"]


@pytest.mark.parametrize("mesh_name", tuple(MESHES))
def test_every_arch_and_shape_reckoned(mesh_name):
    mesh = parse_mesh(MESHES[mesh_name])
    for arch in tconfig.list_archs():
        for shape in tconfig.SHAPES:
            rec = dryrun.run_one(arch, shape, mesh, trace=False)
            per = rec["per_device_bytes"]
            assert per["params"] > 0 and per["total"] >= per["params"]
            assert rec["mesh"] == MESHES[mesh_name]
            assert rec["card"] == dryrun.CARD


def test_train_record_repairs_the_gradients():
    """gemma2-2b's ``train_4k`` at 1 x 1: 5.23 GB of bf16 parameters,
    20.91 of fp32 moments, 5.23 of gradients in the parameters' types and,
    at 128 microbatches, a 10.46-GB fp32 accumulator (the fp32 norms are
    already 4 bytes): about 41.8 GB."""
    rec = dryrun.run_one("gemma2-2b", "train_4k", parse_mesh("1x1"),
                         trace=False)
    gb = {k: v / 1e9 for k, v in rec["per_device_bytes"].items()}
    assert rec["microbatches"] == 128
    assert gb["grads"] == pytest.approx(gb["params"])
    assert gb["grad_acc"] == pytest.approx(2 * gb["params"], rel=1e-3)
    assert 41.7 < gb["total"] < 41.9


def test_traced_train_step_counts_the_collectives():
    """gemma2-2b's ``train_4k`` at 1 x 4 (dp 1: 128 microbatches of 2
    rows): a microbatch sums o and down over "model" in the forward and
    again in the remat recompute, the embedding once and the CE's sum of
    exps and gold logit, takes one max, and sums the cotangents of the
    column-parallel inputs (q/k/v and gate/up of 26 blocks, the head) in
    the backward; once a step the grad norm's shard sums."""
    rec = dryrun.run_one("gemma2-2b", "train_4k", parse_mesh("1x4"))
    assert rec["traced"], rec.get("why_not_traced")
    k = rec["microbatches"]
    assert k == 128
    mb = rec["collectives_microbatch"]
    assert mb["sum_over/model"]["calls"] == 2 * 26 + 1 + 2 * 26 + 2
    assert mb["copy_to.bwd/model"]["calls"] == 2 * 26 + 1
    assert mb["max_over/model"]["calls"] == 1
    coll = rec["collectives"]
    for name, v in coll.items():
        once = rec["collectives_once"].get(name, {"calls": 0})["calls"]
        assert v["calls"] == k * mb.get(name, {"calls": 0})["calls"] + once
    assert not dist.is_initialized()


def test_fsdp_train_step_gathers_unit_by_unit():
    """qwen1.5-32b's ``train_4k`` at 2 x 4 shards "embed" over "data":
    each unit's leaves are gathered in the forward and again in the
    recompute, and each gather's adjoint sums the data ranks' gradients
    onto the shard."""
    rec = dryrun.run_one("qwen1.5-32b", "train_4k", parse_mesh("2x4"))
    assert rec["traced"], rec.get("why_not_traced")
    assert any(n.startswith("FSDP") for n in rec["sharding_notes"])
    mb = rec["collectives_microbatch"]
    # 9 leaves a layer cut by "embed" (two norms, q, k, v, o, gate, up,
    # down), the embedding, the head and the final norm
    assert mb["gather_over/data"]["calls"] == 2 * 9 * 64 + 3
    assert mb["gather_over.bwd/data"]["calls"] == 9 * 64 + 3
    assert not dist.is_initialized()


def test_fake_group_is_destroyed_and_refuses_a_second():
    with fake_group(4):
        assert dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already exists"):
            with fake_group(2):
                pass
    assert not dist.is_initialized()


def test_cli_prints_a_record(capsys, tmp_path):
    assert dryrun.main(["--arch", "gemma2-2b", "--shape", "decode_32k",
                        "--mesh", "1x4", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "gemma2-2b decode_32k 1x4" in out and "sum_over/model" in out
    assert (tmp_path / "gemma2-2b__decode_32k__1x4.json").exists()


def test_isolated_from_jax():
    """The sharding and launch modules load nothing of the JAX package."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh\n"
            "import repro_torch.launch.inputs, repro_torch.launch.variants\n"
            "import repro_torch.sharding.auto, repro_torch.sharding.ctx\n"
            "import repro_torch.sharding.collectives\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax', 'jaxlib')))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(ROOT / "src")})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


@pytest.mark.parametrize("variant,k", [("mb2", 2), ("mb16", 16)])
def test_microbatch_variant_is_traced_at_its_microbatches(variant, k):
    """A ``mbK`` variant's train step is traced at K microbatches (the
    JAX dry run builds its step with the variant's ``mb_override``): the
    record's microbatches are K, and every collective's calls and bytes a
    step are K times a microbatch's plus the once-a-step exchanges."""
    rec = dryrun.run_one("gemma2-2b", "train_4k", parse_mesh("1x4"),
                         (variant,))
    assert rec["traced"], rec.get("why_not_traced")
    assert rec["mb_override"] == rec["microbatches"] == k
    mb, once = rec["collectives_microbatch"], rec["collectives_once"]
    assert mb["copy_to.bwd/model"]["calls"] > 0
    for name, v in rec["collectives"].items():
        for f in ("calls", "bytes"):
            assert v[f] == k * mb.get(name, {f: 0})[f] + \
                once.get(name, {f: 0})[f], (name, f)
    assert not dist.is_initialized()

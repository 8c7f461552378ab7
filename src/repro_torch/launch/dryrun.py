"""The dry run: every (architecture x input shape x mesh) reckoned
against the card, and the dense and MoE families' train, prefill and
decode steps traced over the mesh.  The port's counterpart of
``repro.launch.dryrun``.

For each combination it records the sharding rules' notes
(``sharding.auto.rules_for``, the variants' after them), the JAX
package's switch to an int8 KV cache above ``KV_QUANT_THRESHOLD_BYTES``
a device, and the bytes a device holds as arguments of the step: the
parameters, the cache, the batch and, for ``train_4k``, the optimizer's
moments (``adamw_init_spec(zero1=True, fsdp=...)``), the gradients (the
parameters' local bytes) and, where the step takes more than one
microbatch, their accumulator in ``grad_acc_dtype``, each leaf at its
shard shape under the rules.  The fit is against ``CARD_MEMORY_BYTES``.
Temporaries (activations, the logits) are not reckoned.

For the dense, MoE, ssm and hybrid families, the step that
:func:`_build_step` builds
(the one the tests and the smoke execute) is traced on meta tensors of
the local shapes, as rank 0 of a fake process group of the mesh's size:
the kernels' wrappers return shapes alone, and the collectives are
counted, not run (``sharding.collectives.COUNTS``: calls and bytes a
step by collective and mesh axis, a backward's apart; the role of the
JAX package's ``hlo_analysis``).  A train step traces one microbatch's
forward, backward and the update, and counts the microbatch's
collectives as many times as the step takes microbatches.  The cache is
cut as its leaves' logical axes say (by sequence where the kv heads do
not divide "model" or the batch does not divide dp), and a decode step
counts the softmax's exchange across the cache's shards: a ``max_over``
and two ``sum_over`` (the sum of the exps, the partial outputs) a layer
over the "kv_seq" axes, and where q heads are cut over whole kv heads a
``gather_over`` of q over "model".  An MoE block counts its exchange over
"model" (the picked rows where the experts are cut, the down product's
fp32 partials where each expert's ff axis is) and, where the batch is
cut, its aux statistics' sums over the data axes.  A Mamba2 block counts
its gathers of ``in_proj``'s columns and of the conv's weights (and of
the conv state in a decode step) over "model", and its norm's sum of
squares; an RWKV6 layer counts its row-parallel ``wo`` and ``wv``.  A
family or rule the
executed path lacks is recorded as ``"traced": false`` with its reason
(the rule ``check_executed`` names, where one applies), never replicated
in silence.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen1.5-32b --shape decode_32k \\
      --mesh 1x4 [--variant head_pad+int8kv] [--out DIR]
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
      --mesh 1x4
  python -m repro_torch.launch.dryrun --all [--multi-pod | --mesh DxM]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from pathlib import Path
from typing import Sequence, Union

import torch

from repro_torch.core.config import (MeshConfig, ModelConfig, ShapeConfig,
                                     SHAPES, get_arch, get_shape, list_archs)

#: per-device bf16 KV-cache footprint above which decode shapes switch to
#: int8 KV quantization (the JAX package's rule)
KV_QUANT_THRESHOLD_BYTES = 8 * 2**30
#: the card each device of a mesh stands for: an NVIDIA H100 80GB HBM3
CARD = "NVIDIA H100 80GB HBM3"
CARD_MEMORY_BYTES = 80 * 10**9

#: the families whose steps the executed sharded path takes, and the dry
#: run traces: ``TransformerLM``'s (dense and MoE), ``RWKV6LM``'s (ssm) and
#: ``Zamba2LM``'s (hybrid)
TRACED_FAMILIES = ("dense", "moe", "ssm", "hybrid")

_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1, "int32": 4}


def train_settings(cfg: ModelConfig, shape: ShapeConfig,
                   mesh_cfg: MeshConfig, microbatches=None) -> dict:
    """The JAX dry run's train settings for ``cfg`` at ``shape`` on
    ``mesh_cfg``: ``default_microbatches`` at 4096 local tokens for the
    vlm and audio families and 8192 otherwise (or ``microbatches``), and
    bf16 moments and gradient accumulation above 100 B parameters."""
    from repro_torch.train.step import default_microbatches

    big = cfg.num_params() > 100e9
    mlt = 4096 if cfg.family in ("vlm", "audio") else 8192
    return {"microbatches": microbatches or default_microbatches(
                shape.global_batch * shape.seq_len, mesh_cfg.dp_size,
                max_local_tokens=mlt),
            "grad_acc_dtype": "bfloat16" if big else "float32",
            "moment_dtype": "bfloat16" if big else "float32"}


def _build_step(cfg: ModelConfig, shape: ShapeConfig, mesh_cfg: MeshConfig,
                rules, *, tcfg=None, microbatches=None):
    """The step of ``shape`` over one rank's shards: ``build(mesh,
    params)`` loads the rank's tree ``params`` (``shard_params`` /
    ``shard_init``'s, or meta tensors of the local shapes) into the
    model of ``get_model(cfg, mesh_cfg, rules)`` and returns ``(step,
    model)``:
    ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` for a train shape (``make_train_step`` with
    ``train_settings``' microbatches, ``microbatches`` if given, and
    ``tcfg`` or the default ``TrainConfig``; the rank's rows of the
    global batch, ``params`` the tree the model was built on),
    ``prefill(batch, cache) -> (logits, cache, aux)`` for a prefill shape,
    ``serve_step(tokens, positions, cache) -> (logits, cache)`` for a
    decode shape, each run under the mesh's ``activation_sharding``.
    Raises NotImplementedError (``check_executed``) for a rule the path
    does not take."""
    from repro_torch.core.config import TrainConfig
    from repro_torch.models.registry import get_model
    from repro_torch.models.transformer import check_executed
    from repro_torch.sharding.ctx import activation_sharding, global_sizes
    from repro_torch.train.step import make_train_step

    check_executed(cfg, mesh_cfg, rules)
    sizes = global_sizes(cfg, shape.global_batch)

    def build(mesh, params):
        model = get_model(cfg, mesh_cfg, rules).load_tree(params)
        window = model.effective_window(shape)

        if shape.kind == "train":
            settings = train_settings(cfg, shape, mesh_cfg, microbatches)
            # the activations hold a microbatch's rows
            mb_sizes = global_sizes(cfg, shape.global_batch
                                    // settings["microbatches"])
            inner = make_train_step(
                model, tcfg or TrainConfig(), window_override=window,
                microbatches=settings["microbatches"],
                grad_acc_dtype=settings["grad_acc_dtype"])

            def under_mesh(fn):
                def run(*args, **kw):
                    with activation_sharding(mesh, rules, mb_sizes):
                        return fn(*args, **kw)
                return run

            train_step = under_mesh(inner)
            for name in ("accumulate", "finish", "plan"):
                setattr(train_step, name, under_mesh(getattr(inner, name)))
            train_step.microbatches = settings["microbatches"]
            return train_step, model

        if shape.kind == "prefill":
            def prefill(batch, cache):
                with activation_sharding(mesh, rules, sizes):
                    return model.forward(batch, "prefill",
                                         window_override=window, cache=cache)
            return prefill, model

        def serve_step(tokens, positions, cache):
            with activation_sharding(mesh, rules, sizes):
                return model.decode_step(tokens, positions, cache,
                                         window=window)
        return serve_step, model

    return build


def _leaf_bytes(shape, axes, dtype: str, mesh_cfg: MeshConfig, rules) -> int:
    from repro_torch.sharding.rules import local_shape, logical_to_spec

    spec = logical_to_spec(axes, mesh_cfg.axes, rules)
    return math.prod(local_shape(shape, spec, mesh_cfg)) * _BYTES[dtype]


def spec_bytes(spec, mesh_cfg: MeshConfig, rules, default: str) -> int:
    """Per-device bytes of a Param tree, each leaf at its shard shape."""
    from repro_torch.nn.param import tree_leaves

    return sum(_leaf_bytes(p.shape, p.axes, p.dtype or default, mesh_cfg,
                           rules) for p in tree_leaves(spec))


def kv_quant_switch(cfg: ModelConfig, shape: ShapeConfig,
                    mesh_cfg: MeshConfig) -> bool:
    """The JAX package's rule: a decode shape whose bf16 KV cache would
    hold more than ``KV_QUANT_THRESHOLD_BYTES`` a device runs int8."""
    if not shape.is_decode or cfg.is_attention_free:
        return False
    win = cfg.sliding_window or (cfg.long_context_window
                                 if shape.seq_len > 131_072 else 0)
    s_eff = min(shape.seq_len, win) if win else shape.seq_len
    n_attn = (cfg.num_layers if cfg.shared_attn_every == 0
              else cfg.num_layers // cfg.shared_attn_every)
    cache_bytes = (2 * n_attn * shape.global_batch * s_eff
                   * cfg.num_kv_heads * cfg.head_dim * 2)
    return cache_bytes / mesh_cfg.num_devices > KV_QUANT_THRESHOLD_BYTES


def _trace(cfg, shape, mesh_cfg, rules, model_spec, window,
           microbatches=None):
    """One step of ``_build_step`` on meta tensors as rank 0 of a fake
    group of the mesh's size: the collectives it calls, by name.  A train
    step (at ``microbatches``, a variant's, or ``train_settings``'
    default) traces one microbatch's forward and backward, counts its
    collectives once a microbatch, and adds the once-a-step exchanges of
    ``finish`` (the data ranks' gradient sums, the norm's, the ZeRO-1
    gathers)."""
    from repro_torch.launch.inputs import input_specs
    from repro_torch.launch.mesh import fake_group, make_production_mesh
    from repro_torch.nn.param import DTYPES, tree_map
    from repro_torch.sharding import collectives
    from repro_torch.sharding.rules import (local_shape, local_spec,
                                            logical_to_spec)

    build = _build_step(cfg, shape, mesh_cfg, rules,
                        microbatches=microbatches)
    params = tree_map(lambda p: torch.empty(
        p.shape, dtype=DTYPES[p.dtype or cfg.param_dtype], device="meta"),
        local_spec(model_spec, mesh_cfg, rules))
    b_specs, b_axes = input_specs(cfg, shape)
    batch = {k: torch.empty(local_shape(
        v.shape, logical_to_spec(b_axes[k], mesh_cfg.axes, rules), mesh_cfg),
        dtype=v.dtype, device="meta") for k, v in b_specs.items()}
    with fake_group(mesh_cfg.num_devices):
        mesh = make_production_mesh(mesh_cfg=mesh_cfg)
        step, model = build(mesh, params)
        if shape.kind == "train":
            return _trace_train(step, params, batch, collectives)
        cache = model.init_cache(shape.global_batch, shape.seq_len, window,
                                 device="meta")
        collectives.reset_counts()
        if shape.kind == "prefill":
            logits = step({"tokens": batch["tokens"]}, cache)[0]
        else:
            logits = step(batch["tokens"], batch["positions"], cache)[0]
        counts = collectives.counts_by_name()
    return {"logits_shape": list(logits.shape), "collectives": counts}


def _trace_train(step, params, batch, collectives) -> dict:
    """``step``'s collectives a train step: one microbatch's times the
    microbatches, plus ``finish``'s."""
    from repro_torch.train.optimizer import adamw_init

    k = step.microbatches
    opt = adamw_init(params, step.plan())
    collectives.reset_counts()
    grads, metrics = step.accumulate(params, batch, [0])
    per_mb = collectives.counts_by_name()
    collectives.reset_counts()
    step.finish(params, opt, grads, metrics)
    once = collectives.counts_by_name()
    total = {}
    for name in sorted(set(per_mb) | set(once)):
        a, b = per_mb.get(name, {}), once.get(name, {})
        total[name] = {f: k * a.get(f, 0) + b.get(f, 0)
                       for f in ("calls", "bytes")}
    return {"microbatches": k, "collectives": total,
            "collectives_microbatch": per_mb, "collectives_once": once}


def run_one(arch: str, shape: Union[str, ShapeConfig], mesh_cfg: MeshConfig,
            variants: Sequence[str] = (), trace: bool = True) -> dict:
    """The record of ``arch`` at ``shape`` (a name of ``SHAPES`` or a
    ``ShapeConfig``) on ``mesh_cfg``."""
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import tree_map
    from repro_torch.sharding.auto import rules_for
    from repro_torch.train.optimizer import adamw_init_spec

    cfg = get_arch(arch)
    shape = get_shape(shape) if isinstance(shape, str) else shape
    if kv_quant_switch(cfg, shape, mesh_cfg):
        cfg = dataclasses.replace(cfg, kv_quant=True)
    mb_override, vnotes = None, []
    if variants:
        # config transforms before rules_for, so that the divisibility
        # policies see the transformed architecture (e.g. padded heads)
        from repro_torch.launch.variants import apply_variants
        from repro_torch.sharding.rules import DEFAULT_RULES

        cfg, _, vnotes, mb_override = apply_variants(
            variants, cfg, DEFAULT_RULES, mesh_cfg.model_size)
    rules, notes = rules_for(cfg, mesh_cfg, shape)
    if variants:
        # rule-only overrides on the derived rules (e.g. seq_sp)
        _, rules, _, _ = apply_variants(variants, cfg, rules,
                                        mesh_cfg.model_size)
    notes = notes + vnotes
    if cfg.kv_quant:
        notes = notes + ["int8 KV cache"]

    t0 = time.perf_counter()
    model = get_model(cfg)
    spec = model.param_spec()
    window = model.effective_window(shape)
    dp = mesh_cfg.dp_size
    rec = {"arch": cfg.name, "shape": shape.name,
           "mesh": "x".join(map(str, mesh_cfg.shape)),
           "num_devices": mesh_cfg.num_devices, "sharding_notes": notes,
           "variants": list(variants), "kv_quant": cfg.kv_quant,
           "layers": cfg.num_layers, "mb_override": mb_override}
    per = {"params": spec_bytes(spec, mesh_cfg, rules, cfg.param_dtype)}
    if shape.kind == "train":
        fsdp = dict(rules.table).get("embed") is not None
        settings = train_settings(cfg, shape, mesh_cfg, mb_override)
        opt = adamw_init_spec(spec, zero1=True, dp_size=dp, fsdp=fsdp,
                              moment_dtype=settings["moment_dtype"])
        per["optimizer"] = spec_bytes(opt, mesh_cfg, rules, "float32")
        # the backward's gradient buffers, in the parameters' local shapes
        # and types, and the microbatches' accumulator beside them
        per["grads"] = per["params"]
        if settings["microbatches"] > 1:
            per["grad_acc"] = spec_bytes(
                tree_map(lambda p: p._replace(
                    dtype=settings["grad_acc_dtype"]), spec),
                mesh_cfg, rules, cfg.param_dtype)
        rec["microbatches"] = settings["microbatches"]
    else:
        per["cache"] = spec_bytes(
            model.cache_spec(shape.global_batch, shape.seq_len, window),
            mesh_cfg, rules, "bfloat16")
    from repro_torch.launch.inputs import input_specs

    b_specs, b_axes = input_specs(cfg, shape)
    per["batch"] = sum(
        _leaf_bytes(tuple(v.shape), b_axes[k], str(v.dtype).split(".")[-1],
                    mesh_cfg, rules) for k, v in b_specs.items())
    total = sum(per.values())
    rec["per_device_bytes"] = dict(per, total=total)
    rec["card"], rec["card_bytes"] = CARD, CARD_MEMORY_BYTES
    rec["fits"] = total <= CARD_MEMORY_BYTES
    rec["traced"] = False
    if not trace:
        rec["why_not_traced"] = "not asked"
    elif cfg.family not in TRACED_FAMILIES:
        from repro_torch.models.transformer import check_executed

        why = (f"the {cfg.family} family: the trace is of the "
               f"{' and '.join(TRACED_FAMILIES)} families' steps")
        try:  # the rule the executed path lacks for it, where one cuts
            check_executed(cfg, mesh_cfg, rules)
        except NotImplementedError as e:
            why = f"{e}; {why}"
        rec["why_not_traced"] = why
    else:
        try:
            rec.update(_trace(cfg, shape, mesh_cfg, rules, spec, window,
                              mb_override))
            rec["traced"] = True
        except NotImplementedError as e:  # a rule the executed path lacks
            rec["why_not_traced"] = str(e)
    rec["seconds"] = time.perf_counter() - t0
    return rec


def summary(rec: dict) -> str:
    gb = {k: round(v / 1e9, 2) for k, v in rec["per_device_bytes"].items()}
    coll = rec.get("collectives")
    return (f"{rec['arch']} {rec['shape']} {rec['mesh']}: "
            f"{gb['total']} GB a device of {rec['card_bytes'] / 1e9:.0f} "
            f"({'fits' if rec['fits'] else 'does not fit'}) {gb}; "
            + (f"collectives a step {coll}" if rec["traced"]
               else f"not traced: {rec['why_not_traced']}"))


def main(argv=None) -> int:
    from repro_torch.launch.mesh import mesh_config, parse_mesh

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mesh", help="DxM (data x model) or PxDxM, e.g. 1x4")
    ap.add_argument("--all", action="store_true",
                    help="every (arch, shape) pair on the chosen mesh")
    ap.add_argument("--variant", default="",
                    help="'+'-separated variant chain, e.g. head_pad+int8kv")
    ap.add_argument("--no-trace", action="store_true")
    ap.add_argument("--out", help="write one JSON record a combination here")
    args = ap.parse_args(argv)
    mesh_cfg = (parse_mesh(args.mesh) if args.mesh
                else mesh_config(args.multi_pod))
    if args.all:
        combos = [(a, s) for a in list_archs() for s in SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")
    variants = tuple(v for v in args.variant.split("+") if v)
    out = Path(args.out) if args.out else None
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
    for arch, shape in combos:
        rec = run_one(arch, shape, mesh_cfg, variants,
                      trace=not args.no_trace)
        print(summary(rec), flush=True)
        if out is not None:
            tag = "-".join(variants)
            (out / f"{arch}__{shape}__{rec['mesh']}"
                   f"{'__v-' + tag if tag else ''}.json").write_text(
                json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

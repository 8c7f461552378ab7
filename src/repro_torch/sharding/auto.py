"""Per-(arch, mesh, shape) sharding-rule adaptation: the port's copy of
``repro.sharding.auto``.

Starting from the default logical-axis table, drop shardings that do not
divide (e.g. qwen1.5's 40 heads on a 16-way model axis), add FSDP where
model-axis sharding alone leaves more than about 1.5 GiB of parameters a
device, and move the batch sharding to the KV sequence for tiny-batch
long-context decode.  Every decision is recorded in the returned
``notes``, word for word as the JAX package's.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.core.config import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.sharding.rules import AxisRules, DEFAULT_RULES


def rules_for(
    cfg: ModelConfig,
    mesh: MeshConfig,
    shape: Optional[ShapeConfig] = None,
) -> Tuple[AxisRules, list]:
    M = mesh.model_size
    dp = mesh.dp_size
    over = {}
    notes = []

    def drop(axis: str, size: int, what: str):
        if size % M:
            over[axis] = None
            notes.append(f"{what} ({size}) not divisible by model={M}: replicated")

    if cfg.num_heads:
        drop("heads", cfg.num_heads, "q heads")
    if cfg.num_kv_heads:
        drop("kv_heads", cfg.num_kv_heads, "kv heads")
    drop("ff", cfg.d_ff, "d_ff")
    drop("vocab", cfg.padded_vocab, "padded vocab")
    if cfg.moe is not None:
        # expert and tensor sharding are mutually exclusive (both map to the
        # model axis; one spec may use it only once)
        if cfg.moe.shard_mode == "expert":
            drop("experts", cfg.moe.num_experts, "experts")
            over["expert_ff"] = None
        else:
            drop("expert_ff", cfg.moe.d_ff_expert, "expert d_ff")
            over["experts"] = None
    if cfg.ssm is not None:
        drop("ssm_inner", cfg.ssm.expand * cfg.d_model, "ssm inner dim")
    if cfg.rwkv is not None:
        drop("ssm_inner", cfg.d_model, "rwkv inner dim")

    # FSDP: when model-axis sharding alone leaves > ~1.5 GiB of parameters
    # per device, additionally shard the "embed" parameter axis over the
    # data axes (ZeRO-3 style weight gathering).
    per_dev_param_bytes = 2 * cfg.num_params() / max(M, 1)
    if per_dev_param_bytes > 1.5 * 2**30 and cfg.d_model % dp == 0:
        over["embed"] = tuple(a for a in mesh.axes if a in ("pod", "data"))
        notes.append(
            f"FSDP: params would be {per_dev_param_bytes/2**30:.1f} GiB/device "
            f"under model-only sharding; 'embed' param axis sharded over dp"
        )

    kv_seq_axes = []
    if shape is not None and shape.global_batch % dp:
        over["batch"] = None
        kv_seq_axes += [a for a in mesh.axes if a in ("pod", "data")]
        notes.append(
            f"batch ({shape.global_batch}) not divisible by dp={dp}: "
            "replicated; KV sequence sharded over dp instead"
        )
    if cfg.num_kv_heads and cfg.num_kv_heads % M:
        # kv heads replicated -> shard the cache/context sequence over model
        kv_seq_axes.append("model")
        over["media"] = "model"
        notes.append("kv-seq (and media/context) sharded over model "
                     "(kv heads replicated)")
    if kv_seq_axes:
        over["kv_seq"] = tuple(kv_seq_axes)
    return DEFAULT_RULES.replace(**over), notes

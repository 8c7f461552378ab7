"""Named optimization variants: the port's copy of
``repro.launch.variants``.

Each variant is (config transform, rules transform, note); the configs,
rules and notes are the JAX package's, word for word.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from repro_torch.core.config import ModelConfig
from repro_torch.sharding.rules import AxisRules


def _pad_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def head_pad(cfg: ModelConfig, rules: AxisRules, model_size: int = 16):
    """Pad q heads (and kv heads when beneficial) to the model-axis multiple
    so attention shards instead of replicating.  Semantics-preserving: the
    padded head slices are zero-initialized and their outputs are annihilated
    by the zero rows of wo (tests/test_torch_variants.py)."""
    nh = _pad_up(cfg.num_heads, model_size)
    kvh = cfg.num_kv_heads
    padded_kv = _pad_up(kvh, model_size)
    if nh % kvh != 0:
        # kv must divide the padded head count — forced to pad kv too
        kvh = padded_kv
    elif kvh % model_size and padded_kv <= 2 * kvh:
        # optional kv pad when it costs <=2x KV-cache memory
        kvh = padded_kv
    if nh % kvh:
        raise ValueError(f"head_pad: {nh} q heads over {kvh} kv heads")
    cfg2 = dataclasses.replace(cfg, num_heads=nh, num_kv_heads=kvh)
    rules2 = rules.replace(heads="model" if nh % model_size == 0 else None,
                           kv_heads="model" if kvh % model_size == 0 else None)
    return cfg2, rules2, (f"head_pad: q {cfg.num_heads}->{nh}, "
                          f"kv {cfg.num_kv_heads}->{kvh}")


def seq_sp(cfg: ModelConfig, rules: AxisRules, model_size: int = 16):
    """Megatron-style sequence parallelism: the residual stream (and the
    saved scan carries) shard their sequence axis over the model axis."""
    rules2 = rules.replace(seq_res="model")
    return cfg, rules2, "seq_sp: residual-stream sequence sharded over model"


def int8kv(cfg: ModelConfig, rules: AxisRules, model_size: int = 16):
    return (dataclasses.replace(cfg, kv_quant=True), rules,
            "int8kv: quantized KV cache")


def microbatches(k: int):
    def f(cfg, rules, model_size: int = 16):
        return cfg, rules, f"mb{k}: microbatch override"
    f.mb_override = k
    return f


def chunk(size: int):
    """Larger flash chunks: K/V re-read bytes scale ~ (s/chunk)."""
    def f(cfg: ModelConfig, rules: AxisRules, model_size: int = 16):
        return dataclasses.replace(cfg, attn_chunk=size), rules, f"chunk{size}"
    return f


VARIANTS: Dict[str, Callable] = {
    "chunk2k": chunk(2048),
    "chunk4k": chunk(4096),
    "head_pad": head_pad,
    "seq_sp": seq_sp,
    "int8kv": int8kv,
    "mb2": microbatches(2),
    "mb4": microbatches(4),
    "mb16": microbatches(16),
}


def apply_variants(names, cfg, rules, model_size: int = 16):
    """Apply a chain of variants; returns (cfg, rules, notes,
    mb_override)."""
    notes, mb = [], None
    for name in names:
        fn = VARIANTS[name]
        cfg, rules, note = fn(cfg, rules, model_size)
        notes.append(note)
        mb = getattr(fn, "mb_override", mb)
    return cfg, rules, notes, mb

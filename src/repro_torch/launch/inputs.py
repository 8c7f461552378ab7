"""Meta-tensor stand-ins for every model input: the port's counterpart of
``repro.launch.inputs``.

``input_specs(cfg, shape)`` returns (dict of meta tensors, dict of
logical axes) for the batch of the given input shape: the shapes and
dtypes of the JAX package's ``ShapeDtypeStruct``s, allocation-free.  The
dry run reckons their bytes and traces the step on them; a test
materializes them with zeros.

Decode shapes describe ``serve_step`` inputs: ONE new token per request
plus the KV cache of ``seq_len``; train/prefill describe the full batch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.config import ModelConfig, ShapeConfig
from repro_torch.nn.param import DTYPES, axes_tree, tree_map

_DTYPES = {**DTYPES, "int32": torch.int32}


def _meta(shape, dtype):
    return torch.empty(shape, dtype=_DTYPES[dtype], device="meta")


def _media_specs(cfg: ModelConfig, b: int):
    """Stub modality frontend outputs: patch/frame embeddings of the right
    shape, as if produced by the ViT / conv feature extractor."""
    specs, axes = {}, {}
    if cfg.family == "vlm":
        t, dm = cfg.cross_attn.num_media_tokens, cfg.cross_attn.media_dim
        specs["media_embeds"] = _meta((b, t, dm), cfg.dtype)
        axes["media_embeds"] = ("batch", "media", None)
    if cfg.family == "audio":
        t, dm = cfg.cross_attn.num_media_tokens, cfg.cross_attn.media_dim
        specs["frames"] = _meta((b, t, dm), cfg.dtype)
        axes["frames"] = ("batch", "media", None)
    return specs, axes


def cache_specs(model, batch: int, cache_len: int, window: int):
    """(tree of meta tensors, tree of logical axes) of ``model``'s cache,
    each leaf in its spec's dtype or bf16."""
    spec = model.cache_spec(batch, cache_len, window)
    metas = tree_map(lambda p: _meta(p.shape, p.dtype or "bfloat16"), spec)
    return metas, axes_tree(spec)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[dict, dict]:
    """Batch-side inputs only (params/opt/cache handled by the dry run)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": _meta((b, s), "int32"),
                 "labels": _meta((b, s), "int32")}
        axes = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
    elif shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), "int32")}
        axes = {"tokens": ("batch", "seq")}
    else:  # decode: ONE new token per request
        specs = {"tokens": _meta((b, 1), "int32"),
                 "positions": _meta((b,), "int32")}
        axes = {"tokens": ("batch", None), "positions": ("batch",)}
    m_specs, m_axes = _media_specs(cfg, b)
    specs.update(m_specs)
    axes.update(m_axes)
    return specs, axes

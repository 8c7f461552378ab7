"""Model registry: family -> class, and parameter counts over the port's
spec — the port of ``repro.models.registry`` for every family: dense,
MoE, RWKV6 (``ssm``), zamba2 (``hybrid``) and the cross-attention
families (``vlm``, ``audio``)."""
from __future__ import annotations

import math

from repro_torch.core.config import ModelConfig
from repro_torch.nn.param import is_param

def get_model(cfg: ModelConfig):
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.rwkv6 import RWKV6LM
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.models.vision_lm import VisionLM
    from repro_torch.models.zamba2 import Zamba2LM

    if cfg.family == "ssm":
        return RWKV6LM(cfg)
    if cfg.family == "hybrid":
        return Zamba2LM(cfg)
    if cfg.family == "vlm":
        return VisionLM(cfg)
    if cfg.family == "audio":
        return EncDecLM(cfg)
    return TransformerLM(cfg)  # dense + moe


def _spec_counts(spec, path=()):
    """(total, expert, embed) parameter counts of a Param spec tree: expert
    leaves lie under a key starting ``we_``, embedding leaves under a key
    ``embed``, ``tok`` or ``head``."""
    if is_param(spec):
        n = math.prod(spec.shape)
        expert = any(k.startswith("we_") for k in path)
        embed = any(k in ("embed", "tok", "head") for k in path)
        return n, n * expert, n * embed
    total = expert = embed = 0
    for k in sorted(spec):
        t, e, m = _spec_counts(spec[k], path + (k,))
        total, expert, embed = total + t, expert + e, embed + m
    return total, expert, embed


def analytic_param_count(cfg: ModelConfig, active_only: bool = False,
                         non_embedding: bool = False) -> int:
    """All parameters; ``active_only``: an MoE model's experts counted at
    k of E; ``non_embedding``: without the embedding table and head."""
    total, expert, embed = _spec_counts(get_model(cfg).param_spec())
    n = total
    if active_only and cfg.moe is not None:
        k, E = cfg.moe.num_experts_per_token, cfg.moe.num_experts
        n = total - expert + expert * k / E
    if non_embedding:
        n -= embed
    return int(n)

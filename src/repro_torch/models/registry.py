"""Model registry: family -> class, and parameter counts over the port's
spec — the port of ``repro.models.registry`` for every family: dense,
MoE, RWKV6 (``ssm``), zamba2 (``hybrid``) and the cross-attention
families (``vlm``, ``audio``)."""
from __future__ import annotations

import math

from repro_torch.core.config import ModelConfig
from repro_torch.nn.param import is_param

def get_model(cfg: ModelConfig, mesh_cfg=None, rules=None):
    """The model of ``cfg``: on a mesh (``mesh_cfg`` and its ``rules``)
    one rank's, whose leaves take the local shapes; a family or rule the
    executed sharded path does not take raises
    (``transformer.check_executed``)."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.rwkv6 import RWKV6LM
    from repro_torch.models.transformer import TransformerLM, check_executed
    from repro_torch.models.vision_lm import VisionLM
    from repro_torch.models.zamba2 import Zamba2LM

    if cfg.family in ("vlm", "audio"):
        if mesh_cfg is not None:  # the cross families take no mesh yet
            check_executed(cfg, mesh_cfg, rules)
        return (VisionLM if cfg.family == "vlm" else EncDecLM)(cfg)
    cls = {"ssm": RWKV6LM, "hybrid": Zamba2LM}.get(cfg.family, TransformerLM)
    return cls(cfg, mesh_cfg, rules)  # dense and moe: TransformerLM


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

"""Model registry: family -> class, and parameter counts over the port's
spec — the port of ``repro.models.registry`` for the dense and RWKV6
families."""
from __future__ import annotations

from repro_torch.core.config import ModelConfig
from repro_torch.nn.param import param_count

#: families the JAX package runs that the port does not run yet
UNPORTED = {"moe": "the MoE transformer (nn/moe.py)",
            "hybrid": "zamba2 (nn/ssm.py)",
            "vlm": "the cross-attention families (models/vision_lm.py)",
            "audio": "the cross-attention families (models/encdec.py)"}


def get_model(cfg: ModelConfig):
    from repro_torch.models.rwkv6 import RWKV6LM
    from repro_torch.models.transformer import TransformerLM

    family = "moe" if cfg.moe is not None else cfg.family
    if family in UNPORTED:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet — "
            f"{UNPORTED[family]} (ROADMAP.md, \"Modules still to port\")")
    if family == "ssm":
        return RWKV6LM(cfg)
    return TransformerLM(cfg)


def analytic_param_count(cfg: ModelConfig) -> int:
    return param_count(get_model(cfg).param_spec())

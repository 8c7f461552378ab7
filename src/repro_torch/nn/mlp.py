"""Feed-forward blocks, gated (SwiGLU/GeGLU) and plain: the port of
``repro.nn.mlp``; every projection runs K3 through ``dense``."""
from __future__ import annotations

from repro_torch.core.config import ModelConfig
from repro_torch.nn.linear import dense, linear_spec


def mlp_spec(cfg: ModelConfig, d_ff: int = 0) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_gated:
        return {
            "w_gate": linear_spec(d, f, "embed", "ff"),
            "w_up": linear_spec(d, f, "embed", "ff"),
            "w_down": linear_spec(f, d, "ff", "embed"),
        }
    return {
        "w_up": linear_spec(d, f, "embed", "ff", bias=True),
        "w_down": linear_spec(f, d, "ff", "embed", bias=True),
    }


def mlp_apply(params, x, cfg: ModelConfig):
    if cfg.mlp_gated:
        g = dense(params["w_gate"], x, act=cfg.act)
        u = dense(params["w_up"], x)
        return dense(params["w_down"], g * u)
    return dense(params["w_down"], dense(params["w_up"], x, act=cfg.act))

"""Feed-forward blocks, gated (SwiGLU/GeGLU) and plain: the port of
``repro.nn.mlp``; every projection runs K3 through ``dense``.  On a mesh
``w_gate``/``w_up`` are column-parallel (their input through ``column_input``)
and ``w_down`` row-parallel over "ff"."""
from __future__ import annotations

from repro_torch.core.config import ModelConfig
from repro_torch.nn.linear import column_input, dense, linear_spec
from repro_torch.sharding.ctx import shard_act


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
    x = column_input(x, "ff")  # gate and up are column-parallel
    if cfg.mlp_gated:
        g = dense(params["w_gate"], x, act=cfg.act)
        u = dense(params["w_up"], x)
        h = shard_act(g * u, ("batch", "seq", "ff"))
    else:
        h = shard_act(dense(params["w_up"], x, act=cfg.act),
                      ("batch", "seq", "ff"))
    return shard_act(dense(params["w_down"], h, k_axis="ff"),
                     ("batch", "seq_res", "embed_act"))

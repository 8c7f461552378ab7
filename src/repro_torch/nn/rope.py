"""Rotary position embeddings (half-split convention, llama-style): the
port of ``repro.nn.rope``."""
from __future__ import annotations

import torch


def rope_angles(positions, head_dim: int, theta: float):
    """positions [...,] -> (cos, sin) of shape [..., head_dim/2], fp32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    ang = positions.float()[..., None] * freqs  # [..., half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., seq, heads, head_dim]; positions broadcastable to [..., seq].

    Uses the split-halves rotation (x1, x2) -> (x1*c - x2*s, x2*c + x1*s)
    in fp32, cast back to x's dtype.
    """
    cos, sin = rope_angles(positions, x.shape[-1], theta)  # [..., seq, half]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)

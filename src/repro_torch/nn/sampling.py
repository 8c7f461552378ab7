"""Token sampling, greedy / temperature / top-k, on fp32 logits: the port
of ``repro.nn.sampling``.  The draw takes an explicit ``torch.Generator``;
it cannot give the tokens ``jax.random`` gives for the same seed."""
from __future__ import annotations

import torch


def sample(logits, generator: torch.Generator, temperature: float = 0.0,
           top_k: int = 0):
    """logits: [b, V] fp32 -> tokens [b] int64.  A categorical draw by the
    Gumbel-max rule (as ``jax.random.categorical``), with the noise from
    ``generator`` on its own device."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
        logits = torch.where(logits < kth, torch.full_like(logits, -1e30),
                             logits)
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).to(logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)

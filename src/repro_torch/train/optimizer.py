"""AdamW with fp32 moments and global-norm clipping: the port of
``repro.train.optimizer``.

The moments are described as ``Param`` trees, as in the JAX package, and
with ``zero1`` each moment's spec keeps the JAX package's annotation of
its largest dp-divisible replicated axis ("zero"); the single-card
trainer shards nothing and only records it.  Unlike the JAX package, the
update writes the new parameters and moments in place, into the trees the
model's parameters alias (``nn.param.ParamTree``), under ``no_grad``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.nn.param import Param, tree_leaves, tree_map


def _zero1_axes(p: Param, dp_size: int, dp_logical=("batch", "zero")) -> Param:
    """Shard the largest still-replicated axis over the dp axes."""
    if any(a in dp_logical for a in p.axes):
        return p  # already dp-sharded somewhere (e.g. FSDP'd "embed")
    best, best_size = -1, 0
    for i, (ax, size) in enumerate(zip(p.axes, p.shape)):
        if ax is None and size % dp_size == 0 and size > best_size:
            best, best_size = i, size
    if best < 0:
        return p
    axes = tuple("zero" if i == best else a for i, a in enumerate(p.axes))
    return Param(p.shape, axes, p.init, p.scale, p.dtype)


def adamw_init_spec(param_spec, zero1: bool = True, dp_size: int = 1,
                    fsdp: bool = False, moment_dtype: str = "float32") -> dict:
    """Moment specs mirroring the parameter spec, as the JAX package's
    (``fsdp``: "embed" already dp-sharded, so ZeRO-1 adds no second dp
    axis)."""
    dp_logical = ("batch", "zero", "embed") if fsdp else ("batch", "zero")

    def moment(p: Param) -> Param:
        m = Param(p.shape, p.axes, init="zeros", dtype=moment_dtype)
        return (_zero1_axes(m, dp_size, dp_logical)
                if zero1 and dp_size > 1 else m)

    return {"m": tree_map(moment, param_spec),
            "v": tree_map(moment, param_spec),
            "step": Param((), (), init="zeros", dtype="int32")}


def adamw_init(params) -> dict:
    """fp32 zero moments beside ``params``, and a 0-d int32 step."""
    dev = tree_leaves(params)[0].device

    def zeros(t):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), t)

    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sum of squares, summed leaf by leaf in the JAX
    package's (sorted key) order."""
    total = 0
    for x in tree_leaves(tree):
        total = total + x.float().square().sum()
    return torch.sqrt(total)


def lr_schedule(step, tcfg: TrainConfig) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in fp32."""
    step = step.float()
    warm = torch.clamp(step / max(tcfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp(
        (step - tcfg.warmup_steps)
        / max(tcfg.total_steps - tcfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * cos


@torch.no_grad()
def adamw_update(grads, opt_state, params, tcfg: TrainConfig
                 ) -> Tuple[dict, dict, dict]:
    """(params, opt_state, metrics), both trees updated in place.  The JAX
    package's rules: clip by ``min(1, grad_clip / max(norm, 1e-9))``, bias
    correction, weight decay on leaves with ``ndim >= 2`` added to the
    update before ``p - lr * u``, the fp32 update cast once to the
    parameter's dtype."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                       max=1.0)
    lr = lr_schedule(step, tcfg)
    b1, b2, eps = tcfg.b1, tcfg.b2, tcfg.eps
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(opt_state["m"]),
                          tree_leaves(opt_state["v"])):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if p.dim() >= 2:  # no weight decay on norms/biases/scalars
            u = u + tcfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}

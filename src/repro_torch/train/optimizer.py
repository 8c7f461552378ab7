"""AdamW with fp32 moments and global-norm clipping: the port of
``repro.train.optimizer``.

The moments are described as ``Param`` trees, as in the JAX package, and
with ``zero1`` each moment's spec keeps the JAX package's annotation of
its largest dp-divisible replicated axis ("zero").  Unlike the JAX
package, the update writes the new parameters and moments in place, into
the trees the model's parameters alias (``nn.param.ParamTree``), under
``no_grad``.

On a mesh a rank holds its shards (:func:`shard_plan`, one
:class:`LeafShard` a leaf): a moment's ZeRO-1 shard of a data-replicated
leaf, or the FSDP'd leaf's own shard.  :func:`adamw_init` makes the local
moments, :func:`global_norm` sums each leaf's squares over the axes its
gradient shard is cut over, in rank order, and adds the leaves in the
JAX package's order, and :func:`adamw_update` updates each parameter's
ZeRO shard and gathers the replicated leaf back over the data axes.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core.config import MeshConfig, TrainConfig
from repro_torch.nn.param import DTYPES, Param, tree_leaves, tree_map
from repro_torch.sharding.collectives import (axis_index, gather_over,
                                              sum_over)
from repro_torch.sharding.rules import (AxisRules, entry_axes, local_shape,
                                        logical_to_spec)

#: the mesh axes a batch is split over
DATA_AXES = ("pod", "data")


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


class LeafShard(NamedTuple):
    """What a rank holds of one leaf's gradient and moments on a mesh.

    ``kind``: ``"own"``, the backward's gradient is already the rank's
    whole share (the leaf FSDP'd over the data axes, whose gather's
    adjoint summed it, or no data axis cuts the mesh); ``"scatter"``, the
    gradient is summed over ``axes`` onto the moment's ZeRO-1 shard along
    ``dim``; ``"sum"``, summed over ``axes`` whole (no dimension divides).
    ``shape``: the local moment's shape; ``norm_axes``: the mesh axes the
    moment shard is cut over (its squares are summed over them)."""
    kind: str
    dim: Optional[int]
    axes: Tuple[str, ...]
    shape: Tuple[int, ...]
    norm_axes: Tuple[str, ...]
    dtype: str = "float32"


def _cut(entry, mesh_cfg: MeshConfig) -> Tuple[str, ...]:
    return tuple(a for a in entry_axes(entry) if mesh_cfg.size(a) > 1)


def shard_plan(param_spec, mesh_cfg: MeshConfig, rules: AxisRules
               ) -> List[LeafShard]:
    """One :class:`LeafShard` a leaf of ``param_spec`` (the whole model's,
    stacked), in the tree's leaf order, for a rank of ``mesh_cfg`` under
    ``rules``: the moments of ``adamw_init_spec(zero1=True, dp_size,
    fsdp)``, FSDP on where the rules cut "embed", bf16 moments above 100 B
    parameters, as the JAX dry run's."""
    fsdp = dict(rules.table).get("embed") is not None
    n = sum(math.prod(p.shape) for p in tree_leaves(param_spec))
    opt = adamw_init_spec(param_spec, zero1=True, dp_size=mesh_cfg.dp_size,
                          fsdp=fsdp,
                          moment_dtype="bfloat16" if n > 100e9 else "float32")
    dp = tuple(a for a in DATA_AXES if a in mesh_cfg.axes
               and mesh_cfg.size(a) > 1)
    out = []
    for p, m in zip(tree_leaves(param_spec), tree_leaves(opt["m"])):
        pspec = logical_to_spec(p.axes, mesh_cfg.axes, rules)
        mspec = logical_to_spec(m.axes, mesh_cfg.axes, rules)
        shape = local_shape(m.shape, mspec, mesh_cfg)
        norm = tuple(a for a in mesh_cfg.axes
                     if any(a in _cut(e, mesh_cfg) for e in mspec))
        fsdp_cut = any(set(_cut(e, mesh_cfg)) & set(dp) for e in pspec)
        zero = [d for d, (a, b) in enumerate(zip(pspec, mspec)) if a != b]
        if fsdp_cut or not dp:
            leaf = LeafShard("own", None, (), shape, norm, m.dtype)
        elif zero:
            leaf = LeafShard("scatter", zero[0], _cut(mspec[zero[0]],
                                                      mesh_cfg),
                             shape, norm, m.dtype)
        else:
            leaf = LeafShard("sum", None, dp, shape, norm, m.dtype)
        out.append(leaf)
    return out


def reduce_grads(grads, plan: Sequence[LeafShard]):
    """The gradient tree ``grads`` (a rank's, in the parameters' local
    shapes) with each data-replicated leaf summed over the data axes in
    rank order: onto its ZeRO-1 shard (``sum_scatter_over``), or whole."""
    from repro_torch.sharding.collectives import sum_scatter_over

    leaves = []
    for g, e in zip(tree_leaves(grads), plan):
        if e.kind == "scatter":
            g = sum_scatter_over(e.axes, g, e.dim)
        elif e.kind == "sum":
            g = sum_over(e.axes, g)
        leaves.append(g)
    it = iter(leaves)
    return tree_map(lambda _: next(it), grads)


def adamw_init(params, plan: Optional[Sequence[LeafShard]] = None) -> dict:
    """Zero moments beside ``params`` (fp32), or with ``plan`` (a rank's
    :func:`shard_plan`) in its local shapes and types, and a 0-d int32
    step."""
    dev = tree_leaves(params)[0].device
    if plan is None:
        def zeros(t):
            return tree_map(lambda x: torch.zeros(
                x.shape, dtype=torch.float32, device=x.device), t)
    else:
        def zeros(t):
            it = iter(plan)
            return tree_map(lambda x: (lambda e: torch.zeros(
                e.shape, dtype=DTYPES[e.dtype], device=x.device))(next(it)),
                t)

    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, plan: Optional[Sequence[LeafShard]] = None
                ) -> torch.Tensor:
    """sqrt of the fp32 sum of squares, summed leaf by leaf in the JAX
    package's (sorted key) order.  With ``plan`` (``tree`` a rank's
    gradient shards) each leaf's sum is first summed over its
    ``norm_axes`` in rank order (one exchange of a vector a set of axes,
    the minor axis first), so every element counts once and every rank
    holds the same bits."""
    sums = [x.float().square().sum() for x in tree_leaves(tree)]
    if plan is not None:
        groups = {}
        for i, e in enumerate(plan):
            groups.setdefault(e.norm_axes, []).append(i)
        for axes, idx in groups.items():
            if not axes:
                continue
            vec = torch.stack([sums[i] for i in idx])
            for a in reversed(axes):
                vec = sum_over(a, vec)
            for j, i in enumerate(idx):
                sums[i] = vec[j]
    total = 0
    for x in sums:
        total = total + x
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
def adamw_update(grads, opt_state, params, tcfg: TrainConfig,
                 plan: Optional[Sequence[LeafShard]] = None
                 ) -> Tuple[dict, dict, dict]:
    """(params, opt_state, metrics), both trees updated in place.  The JAX
    package's rules: clip by ``min(1, grad_clip / max(norm, 1e-9))``, bias
    correction, weight decay on leaves with ``ndim >= 2`` added to the
    update before ``p - lr * u``, the fp32 update cast once to the
    parameter's dtype.  With ``plan`` (a rank's :func:`shard_plan`;
    ``grads`` reduced by :func:`reduce_grads`) a ZeRO-1 leaf's shard is
    updated and gathered back over the data axes, in rank order."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads, plan)
    clip = torch.clamp(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                       max=1.0)
    lr = lr_schedule(step, tcfg)
    b1, b2, eps = tcfg.b1, tcfg.b2, tcfg.eps
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    leaves = zip(tree_leaves(params), tree_leaves(grads),
                 tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]),
                 plan or [None] * len(tree_leaves(params)))
    for p, g, m, v, e in leaves:
        whole = p
        if e is not None and e.kind == "scatter":
            n = m.shape[e.dim]
            p = whole.narrow(e.dim, axis_index(e.axes) * n, n)
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        if whole.dim() >= 2:  # no weight decay on norms/biases/scalars
            u = u + tcfg.weight_decay * p.float()
        p.copy_(p.float() - lr * u)
        if p is not whole:
            whole.copy_(gather_over(e.axes, p, e.dim))
    opt_state["step"].copy_(step)
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


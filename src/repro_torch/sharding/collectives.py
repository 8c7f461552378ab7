"""The collectives of the sharded path, which GSPMD inserts in the JAX
package, each a ``torch.autograd.Function``.

* :func:`sum_over` gathers every rank's partial over a mesh axis and sums
  the parts **in rank order** on every rank, so every rank holds the same
  bits on any backend and the sum's order is fixed by the mesh's shape:
  no reduction of the path is one whose order the backend picks (an
  ``all_reduce``'s is).
* :func:`gather_over` concatenates the ranks' shards along a dimension.
* :func:`sum_scatter_over` gives each rank its slice of the rank-ordered
  sum (a reduce-scatter): ``all_to_all_single`` where the group's backend
  takes it, else a gather, the sum in rank order and a slice.
* :func:`copy_to` is the identity, whose backward sums over the axis.
* :func:`max_over` is the elementwise max over the ranks, without a
  gradient.

Each takes one mesh axis or several at once (the cache's sequence cut
over ``("data", "model")``): the ranks over several axes are ordered
row-major, the major axis first.

**The adjoints depend on what lies downstream on the axis.**  Over
"model" (tensor parallel) every rank computes the same loss, so a
cotangent arrives replicated: ``sum_over``'s adjoint is the identity and
``gather_over``'s is this rank's own slice.  Over a data axis ("data",
"pod") each rank's cotangent comes from its own batch: ``sum_over``'s
adjoint sums the cotangents and ``gather_over``'s is
``sum_scatter_over``, summed in rank order.  ``copy_to``'s adjoint is
``sum_over`` and ``sum_scatter_over``'s is ``gather_over`` on either.
Where each rank uses only its own part of a result that is whole on every
rank (zamba2's projection, a norm's sum of squares over the ranks'
channels), the cotangents over "model" differ too: ``gather_over(...,
parts=True)`` then sums them onto the shards, and ``copy_to`` after a
``sum_over`` sums them.

All read the mesh from the active context (``sharding.ctx``); with no
context, or over an axis of size 1, they return their input and exchange
nothing.  Given a meta tensor (the dry run's trace) they count the call
and return a meta tensor of the result's shape, without a collective.

A gloo group takes CUDA tensors only for ``all_reduce`` and
``broadcast``, so on a gloo group a CUDA tensor's exchange stages through
pinned host memory; the choice follows the group's backend.  On gloo a
gather is one ``broadcast`` from each rank in rank order: between two
processes on one host gloo's ``all_gather`` moved 0.24-0.26 GB/s and the
broadcasts 0.58 (``tools/gloo_gather_probe.py``, 300-MB bf16 parts).

:data:`COUNTS` counts the calls and the bytes by collective and mesh
axis (the dry run reads it), a backward's under ``"<op>.bwd"``.
``bytes`` are what one rank receives from the others: (n - 1) times its
own part's bytes (for ``sum_scatter_over`` a part is 1/n of its input).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.sharding import ctx as _ctx

Axes = Union[str, Sequence[str]]

#: (collective, mesh axes) -> {"calls": n, "bytes": b} since the last reset
COUNTS: Dict[Tuple[str, Tuple[str, ...]], Dict[str, int]] = {}

#: mesh axes over which every rank computes the same loss, so that a
#: cotangent arrives replicated (the others carry a batch of their own)
REPLICATED_LOSS_AXES = ("model",)

#: backends whose ``all_to_all_single`` ``sum_scatter_over`` uses (gloo's
#: on host tensors); another gathers, sums and slices
ALL_TO_ALL_BACKENDS = ("nccl", "gloo")


def reset_counts() -> None:
    COUNTS.clear()


def counts_by_name() -> Dict[str, Dict[str, int]]:
    """``COUNTS`` keyed ``"sum_over/model"``, for printing."""
    return {f"{op}/{'+'.join(axes)}": dict(v)
            for (op, axes), v in sorted(COUNTS.items())}


def _axes(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _size(c, axes: Tuple[str, ...]) -> int:
    n = 1
    for a in axes:
        n *= c.mesh_cfg.size(a)
    return n


def _record(op: str, axes: Tuple[str, ...], part_bytes: int, n: int) -> None:
    rec = COUNTS.setdefault((op, axes), {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += (n - 1) * part_bytes


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


def _group(c, axes: Tuple[str, ...]):
    """The process group over ``axes`` that holds this rank: the mesh's own
    where one axis of more than one device remains, else a group over the
    product of those axes, made at its first use and kept on the mesh
    (every rank of the world makes every such group, in the same order,
    as ``new_group`` asks).  Its group ranks run row-major over ``axes``,
    the major axis first: the global ranks of a ``DeviceMesh`` are
    row-major over its axes, and ``new_group`` sorts them."""
    live = tuple(a for a in axes if c.mesh_cfg.size(a) > 1)
    if len(live) == 1:
        return c.mesh.get_group(live[0])
    groups = c.mesh.__dict__.setdefault("_groups_over_axes", {})
    if live not in groups:
        import torch.distributed as dist

        order = [c.mesh_cfg.axes.index(a) for a in live]
        if order != sorted(order):
            raise ValueError(f"the mesh axes {live} out of the mesh's "
                             f"order {c.mesh_cfg.axes}")
        rest = [d for d, a in enumerate(c.mesh_cfg.axes) if a not in live]
        # the other axes first, then the group's flattened: a row a group
        rows = c.mesh.mesh.permute(*rest, *order).reshape(-1,
                                                         _size(c, live))
        for row in rows.tolist():
            group = dist.new_group(row)
            if dist.get_rank() in row:
                groups[live] = group
    return groups[live]


def _index(c, axes: Tuple[str, ...]) -> int:
    """This rank's index along ``axes`` (row-major)."""
    i = 0
    for a in axes:
        i = i * c.mesh_cfg.size(a) + c.coords[a]
    return i


def _staged(x, group) -> bool:
    import torch.distributed as dist

    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _pinned(x):
    return torch.empty(x.shape, dtype=x.dtype, pin_memory=True)


def _host(x):
    host = _pinned(x)
    host.copy_(x)
    return host


def _gather_parts(x, group, n: int) -> List[torch.Tensor]:
    """Every rank's ``x`` over ``group``, in rank order (this rank's part
    ``x`` itself)."""
    import torch.distributed as dist

    x = x.contiguous()
    if dist.get_backend(group) != "gloo":
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return parts
    staged = _staged(x, group)
    send = _host(x) if staged else x
    me = dist.get_rank(group)
    parts = [send if j == me else (_pinned(send) if staged
                                   else torch.empty_like(send))
             for j in range(n)]
    for j, part in enumerate(parts):
        dist.broadcast(part, src=dist.get_global_rank(group, j),
                       group=group)
    if staged:
        return [x if j == me else p.to(x.device)
                for j, p in enumerate(parts)]
    return parts


def _ordered_sum(parts):
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _sum(c, axes, x, op):
    n = _size(c, axes)
    _record(op, axes, _nbytes(x), n)
    if x.device.type == "meta":
        return torch.empty_like(x)
    return _ordered_sum(_gather_parts(x, _group(c, axes), n))


def _gather(c, axes, x, dim, op):
    n = _size(c, axes)
    _record(op, axes, _nbytes(x), n)
    if x.device.type == "meta":
        shape = list(x.shape)
        shape[dim] *= n
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return torch.cat(_gather_parts(x, _group(c, axes), n), dim=dim)


def _own_slice(c, axes, x, dim):
    n = _size(c, axes)
    size = x.shape[dim] // n
    return x.narrow(dim, _index(c, axes) * size, size).contiguous()


def _sum_scatter(c, axes, x, dim, op):
    import torch.distributed as dist

    n = _size(c, axes)
    if x.shape[dim] % n:
        raise ValueError(f"sum_scatter_over: dimension {dim} of "
                         f"{tuple(x.shape)} does not divide into {n}")
    _record(op, axes, _nbytes(x) // n, n)
    if x.device.type == "meta":
        shape = list(x.shape)
        shape[dim] //= n
        return torch.empty(shape, dtype=x.dtype, device="meta")
    group = _group(c, axes)
    if dist.get_backend(group) not in ALL_TO_ALL_BACKENDS:
        return _own_slice(c, axes, _ordered_sum(_gather_parts(x, group, n)),
                          dim)
    # rank j's slice r lands in row j of rank r's output: rows in rank order
    send = x.movedim(dim, 0).contiguous()
    staged = _staged(send, group)
    if staged:
        send = _host(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        recv = recv.to(x.device)
    parts = recv.reshape(n, send.shape[0] // n, *send.shape[1:]).unbind(0)
    return _ordered_sum(parts).movedim(0, dim).contiguous()


def _replicated(axes) -> bool:
    return all(a in REPLICATED_LOSS_AXES for a in axes)


def _active(axis: Axes):
    """(context, axes) where ``axis`` cuts the mesh into more than one
    part, else (None, axes)."""
    c = _ctx.current()
    axes = _axes(axis)
    if c is None or _size(c, axes) == 1:
        return None, axes
    return c, axes


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axes):
        ctx.c, ctx.axes = c, axes
        return _sum(c, axes, x, "sum_over")

    @staticmethod
    def backward(ctx, dy):
        if _replicated(ctx.axes):
            return dy, None, None
        return _sum(ctx.c, ctx.axes, dy, "sum_over.bwd"), None, None


class _GatherOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axes, dim, parts):
        ctx.c, ctx.axes, ctx.dim, ctx.parts = c, axes, dim, parts
        return _gather(c, axes, x, dim, "gather_over")

    @staticmethod
    def backward(ctx, dy):
        if _replicated(ctx.axes) and not ctx.parts:
            dx = _own_slice(ctx.c, ctx.axes, dy, ctx.dim)  # no exchange
        else:
            dx = _sum_scatter(ctx.c, ctx.axes, dy, ctx.dim,
                              "gather_over.bwd")
        return dx, None, None, None, None


class _SumScatterOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axes, dim):
        ctx.c, ctx.axes, ctx.dim = c, axes, dim
        return _sum_scatter(c, axes, x, dim, "sum_scatter_over")

    @staticmethod
    def backward(ctx, dy):
        return (_gather(ctx.c, ctx.axes, dy, ctx.dim,
                        "sum_scatter_over.bwd"), None, None, None)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, c, axes):
        ctx.c, ctx.axes = c, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _sum(ctx.c, ctx.axes, dy, "copy_to.bwd"), None, None


def sum_over(axis: Axes, x):
    """The sum of every rank's ``x`` over mesh ``axis``, added in rank
    order (``((x_0 + x_1) + x_2) + ...``) on every rank."""
    c, axes = _active(axis)
    if c is None:
        return x
    return _SumOver.apply(x, c, axes)


def gather_over(axis: Axes, x, dim: int, *, parts: bool = False):
    """Every rank's shard ``x`` over mesh ``axis``, concatenated along
    ``dim`` in rank order.  ``parts``: each rank uses only a part of the
    whole (zamba2's gathered projection: its own heads' columns), so the
    ranks' cotangents differ even over "model"; the adjoint is then
    ``sum_scatter_over`` on any axis."""
    c, axes = _active(axis)
    if c is None:
        return x
    return _GatherOver.apply(x, c, axes, dim % x.dim(), parts)


def sum_scatter_over(axis: Axes, x, dim: int):
    """This rank's slice along ``dim`` (its index over ``axis``) of the
    sum of every rank's ``x``, added in rank order: the slice of
    :func:`sum_over`'s result, bit for bit."""
    c, axes = _active(axis)
    if c is None:
        return x
    return _SumScatterOver.apply(x, c, axes, dim % x.dim())


def copy_to(axis: Axes, x):
    """``x`` itself, entering a region whose ranks over ``axis`` each
    compute a part from it (the column-parallel products): its backward
    sums the parts' cotangents over ``axis`` in rank order."""
    c, axes = _active(axis)
    if c is None:
        return x
    return _CopyTo.apply(x, c, axes)


def axis_index(axis: Axes) -> int:
    """This rank's index over mesh ``axis`` (row-major over several) under
    the active context; 0 without one."""
    c = _ctx.current()
    return 0 if c is None else _index(c, _axes(axis))


def max_over(axis: Axes, x):
    """The elementwise max of every rank's ``x`` over ``axis`` (the same
    on every rank, whatever the order); no gradient."""
    c, axes = _active(axis)
    x = x.detach()
    if c is None:
        return x
    n = _size(c, axes)
    _record("max_over", axes, _nbytes(x), n)
    if x.device.type == "meta":
        return torch.empty_like(x)
    parts = _gather_parts(x, _group(c, axes), n)
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out

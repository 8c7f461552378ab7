"""The collectives of the sharded path, which GSPMD inserts in the JAX
package.

* :func:`sum_over` gathers every rank's partial over a mesh axis and sums
  the parts **in rank order** on every rank, so every rank holds the same
  bits on any backend and the sum's order is fixed by the mesh's shape:
  no reduction of the path is one whose order the backend picks (an
  ``all_reduce``'s is).
* :func:`gather_over` concatenates the ranks' shards along a dimension.

Both read the mesh from the active context (``sharding.ctx``); with no
context, or over an axis of size 1, they return their input and exchange
nothing.  Given a meta tensor (the dry run's trace) they count the call
and return a meta tensor of the result's shape, without a collective.

A gloo group takes CUDA tensors only for ``all_reduce`` and
``broadcast``, so on a gloo group a CUDA tensor's gather stages through
pinned host memory; the choice follows the group's backend.

:data:`COUNTS` counts the calls and the bytes by collective and mesh
axis (the dry run reads it).  ``bytes`` are what one rank receives from
the others: (n - 1) times its own part's bytes.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from repro_torch.sharding import ctx as _ctx

Axes = Union[str, Sequence[str]]

#: (collective, mesh axes) -> {"calls": n, "bytes": b} since the last reset
COUNTS: Dict[Tuple[str, Tuple[str, ...]], Dict[str, int]] = {}


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


def _record(op: str, axes: Tuple[str, ...], x, n: int) -> None:
    rec = COUNTS.setdefault((op, axes), {"calls": 0, "bytes": 0})
    rec["calls"] += 1
    rec["bytes"] += (n - 1) * x.numel() * x.element_size()


def _group(c, axes: Tuple[str, ...]):
    if len(axes) != 1:
        raise NotImplementedError(
            f"a collective over the mesh axes {axes} at once")
    return c.mesh.get_group(axes[0])


def _gather_parts(x, group, n: int) -> List[torch.Tensor]:
    """Every rank's ``x`` over ``group``, in rank order."""
    import torch.distributed as dist

    x = x.contiguous()
    if x.device.type == "cuda" and dist.get_backend(group) == "gloo":
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return [p.to(x.device) for p in parts]
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return parts


def sum_over(axis: Axes, x):
    """The sum of every rank's ``x`` over mesh ``axis``, added in rank
    order (``((x_0 + x_1) + x_2) + ...``) on every rank."""
    c = _ctx.current()
    axes = _axes(axis)
    if c is None or _size(c, axes) == 1:
        return x
    n = _size(c, axes)
    _record("sum_over", axes, x, n)
    if x.device.type == "meta":
        return torch.empty_like(x)
    parts = _gather_parts(x, _group(c, axes), n)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def gather_over(axis: Axes, x, dim: int):
    """Every rank's shard ``x`` over mesh ``axis``, concatenated along
    ``dim`` in rank order."""
    c = _ctx.current()
    axes = _axes(axis)
    if c is None or _size(c, axes) == 1:
        return x
    n = _size(c, axes)
    _record("gather_over", axes, x, n)
    if x.device.type == "meta":
        shape = list(x.shape)
        shape[dim] *= n
        return torch.empty(shape, dtype=x.dtype, device="meta")
    return torch.cat(_gather_parts(x, _group(c, axes), n), dim=dim)

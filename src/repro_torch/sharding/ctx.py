"""The sharding context: the port's counterpart of ``repro.sharding.ctx``.

In the JAX package, ``activation_sharding(mesh_axes, rules)`` installs a
context under which ``shard_act(x, logical_axes)`` pins a global array's
sharding for GSPMD.  The port holds each rank's shard as a tensor of its
own, so there is nothing to pin: under a context, ``shard_act`` checks
that ``x``'s local shape is the global shape divided as the rules say,
for every logical axis whose global size the context was given, and
raises where it is not.  With no context it is the identity.

The context also tells the model code which shard of a logical axis its
rank holds (:func:`shard_of`, and :func:`shard_rows` for the rows of a
cut dimension: the cache's sequence): the sharded embedding, the
row-parallel products, the logits, the cache and the MoE block's experts
read it, and the collectives (``sharding.collectives``) read its mesh.
The MoE block also reads the mesh's data size (:func:`data_size`) and how
a rank's rows make up its token groups (:func:`moe_groups`).  With no
context every axis is whole, and the model runs as on one card.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.config import MeshConfig
from repro_torch.sharding.rules import (AxisRules, entry_axes,
                                        logical_to_spec, shard_index, shards)


@dataclass(frozen=True)
class Sharding:
    """What the model code of one rank sees: the mesh (a ``DeviceMesh``
    with dim names, or None where nothing is exchanged), its config, the
    rules, this rank's coordinate on each mesh axis, and the global sizes
    of the logical axes ``shard_act`` checks."""
    mesh: object
    mesh_cfg: MeshConfig
    rules: AxisRules
    coords: Mapping[str, int]
    sizes: Mapping[str, int] = field(default_factory=dict)

    def spec(self, logical_axes: Sequence[Optional[str]]):
        return logical_to_spec(logical_axes, self.mesh_cfg.axes, self.rules)


_CTX: contextvars.ContextVar[Optional[Sharding]] = contextvars.ContextVar(
    "activation_sharding", default=None)


def mesh_config_of(mesh) -> MeshConfig:
    """The ``MeshConfig`` of a ``DeviceMesh`` with dim names."""
    return MeshConfig(tuple(int(s) for s in mesh.mesh.shape),
                      tuple(mesh.mesh_dim_names))


@contextlib.contextmanager
def activation_sharding(mesh, rules: AxisRules,
                        sizes: Optional[Mapping[str, int]] = None):
    """Run the model code inside as one rank of ``mesh`` (a ``DeviceMesh``
    with dim names) under ``rules``; ``sizes``: global sizes of logical
    axes for ``shard_act``'s check."""
    cfg = mesh_config_of(mesh)
    coords = dict(zip(cfg.axes, (int(c) for c in mesh.get_coordinate())))
    token = _CTX.set(Sharding(mesh, cfg, rules, coords, dict(sizes or {})))
    try:
        yield
    finally:
        _CTX.reset(token)


def current() -> Optional[Sharding]:
    return _CTX.get()


@contextlib.contextmanager
def resized(**sizes: int):
    """Run the code inside with the active context's global sizes
    ``sizes`` in place of its own (zamba2's shared block: rows of 2 ·
    d_model, ``embed_act``); nothing with no context."""
    ctx = _CTX.get()
    if ctx is None:
        yield
        return
    token = _CTX.set(dataclasses.replace(ctx, sizes={**ctx.sizes, **sizes}))
    try:
        yield
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def installed(sharding: Optional[Sharding]):
    """Run the code inside with ``sharding`` (a :func:`current`, or None)
    active: a rematted unit's recompute, which autograd runs on its own
    thread for CUDA tensors, where the forward's context is not set."""
    token = _CTX.set(sharding)
    try:
        yield
    finally:
        _CTX.reset(token)


def shard_of(logical: str) -> Tuple[int, int, Tuple[str, ...]]:
    """(this rank's shard index, the shard count, the mesh axes) of the
    logical axis ``logical`` under the active rules; (0, 1, ()) with no
    context or where the axis is whole."""
    ctx = _CTX.get()
    if ctx is None:
        return 0, 1, ()
    entry = ctx.spec((logical,))[0]
    n = shards(entry, ctx.mesh_cfg)
    if n == 1:
        return 0, 1, ()
    return (shard_index(entry, ctx.coords, ctx.mesh_cfg), n,
            entry_axes(entry))


def shard_rows(logical: str, local: int) -> Tuple[int, int, Tuple[str, ...]]:
    """(the offset of this rank's rows in the whole dimension, the whole
    dimension's size, the mesh axes) of a dimension that the logical axis
    ``logical`` cuts, of which this rank holds ``local`` rows: the rank at
    index r over the entry's axes (row-major, the major axis first, as
    ``local_slice`` carves) holds rows [r * local, (r + 1) * local);
    (0, local, ()) with no context or where the axis is whole."""
    r, n, axes = shard_of(logical)
    return r * local, n * local, axes


def data_size() -> int:
    """The data-parallel size of the active mesh (its "pod" times its
    "data"): the ``dp_size`` the JAX package's step is given on that mesh,
    by which the MoE block groups its tokens; 1 with no context."""
    ctx = _CTX.get()
    return 1 if ctx is None else ctx.mesh_cfg.dp_size


def moe_groups(dp_size: int) -> Tuple[int, Tuple[str, ...]]:
    """How this rank runs the MoE block's token groups of a call whose
    JAX ``dp_size`` is ``dp_size``: (the ``dp_size`` to route its own rows
    with, the mesh axes its rows are cut over).

    Where the rules cut "batch" over n ranks, the JAX call's tokens divide
    into ``dp_size`` groups (a batch is cut only where dp divides it) and
    the rank's rows are ``dp_size / n`` of them, whole: it routes them with
    ``dp_size / n`` and the aux losses' means are taken over the axes.
    Where "batch" is whole (a batch that dp does not divide, ``long_500k``'s
    one row), every rank holds the same tokens and runs all the groups
    itself: ``(dp_size, ())``."""
    _, n, axes = shard_of("batch")
    if n == 1:
        return dp_size, ()
    if dp_size % n:
        raise ValueError(f"the MoE block's dp_size {dp_size} over a batch "
                         f"cut {n} ways")
    return dp_size // n, axes


def shard_act(x, logical_axes: Sequence[Optional[str]]):
    """Check that activation ``x`` is this rank's shard of the logical
    axes under the active rules (its size along each axis the context
    knows the global size of, divided by that axis's shard count);
    identity when no context is installed."""
    ctx = _CTX.get()
    if ctx is None or len(logical_axes) != x.dim():
        return x
    for dim, (name, entry) in enumerate(zip(logical_axes,
                                            ctx.spec(logical_axes))):
        if name not in ctx.sizes:
            continue
        want, n = ctx.sizes[name], shards(entry, ctx.mesh_cfg)
        if want % n or x.shape[dim] != want // n:
            raise ValueError(
                f"shard_act: dimension {dim} ({name!r}) of "
                f"{tuple(x.shape)} is {x.shape[dim]}, not {want} / {n} "
                f"(spec {ctx.spec(logical_axes)})")
    return x


def global_sizes(cfg, batch: int) -> Dict[str, int]:
    """The global sizes of the logical axes of ``cfg``'s activations at
    ``batch`` rows, for ``activation_sharding``'s ``sizes``."""
    return {"batch": batch, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "ff": cfg.d_ff,
            "vocab": cfg.padded_vocab, "embed_act": cfg.d_model}

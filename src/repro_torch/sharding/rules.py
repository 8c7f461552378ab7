"""Logical-axis sharding rules: the port's copy of ``repro.sharding.rules``.

Model code annotates parameters and activations with *logical* axis names
("embed", "heads", "ff", "experts", ...).  A single table maps logical
names to physical mesh axes, so changing the distribution strategy is a
one-line edit here, never a model-code edit.

Physical axes: "pod", "data", "model".  A spec is a plain tuple with one
entry a dimension: ``None`` (replicated), a mesh axis name, or a tuple of
mesh axis names (the dimension split over their product, the first axis
major) — the entries of JAX's ``PartitionSpec``, so ``tuple(P)`` of the
JAX package's spec equals the port's.

The port holds each rank's shard as a tensor of its own: :func:`local_shape`
gives a shard's shape and :func:`local_slice` carves it out of a whole
tensor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.core.config import MeshConfig

Spec = Tuple[object, ...]

# Logical axis -> physical mesh axis (or tuple of axes, or None=replicated).
_DEFAULT_TABLE: Dict[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "seq_res": None,  # residual-stream sequence axis (Megatron-SP variant
    #                   maps it to "model"; attention regions keep "seq")
    "kv_seq": None,  # switched to ("pod","data") for tiny-batch long context
    "embed_act": None,
    # params
    "embed": None,  # d_model rows of projections
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",  # MoE shard_mode="expert"
    "expert_ff": "model",  # MoE shard_mode="tensor"
    "ssm_inner": "model",  # mamba/rwkv expanded inner dim
    "media": None,
    "layers": None,  # stacked leading layer axis
    "zero": ("pod", "data"),  # ZeRO-1 optimizer-state sharding axis
    "fsdp": None,  # flipped to ("pod","data") for very large models
    "none": None,
}


@dataclass(frozen=True)
class AxisRules:
    table: Tuple[Tuple[str, object], ...] = tuple(sorted(_DEFAULT_TABLE.items()))

    def lookup(self, name: Optional[str]) -> object:
        if name is None:
            return None
        d = dict(self.table)
        if name not in d:
            raise KeyError(f"unknown logical axis {name!r}")
        return d[name]

    def replace(self, **kv) -> "AxisRules":
        d = dict(self.table)
        d.update(kv)
        return AxisRules(tuple(sorted(d.items())))


DEFAULT_RULES = AxisRules()


def _filter_axes(entry: object, mesh_axes: Sequence[str]) -> object:
    """Drop physical axes not present in the current mesh (e.g. 'pod' on the
    single-pod mesh)."""
    if entry is None:
        return None
    if isinstance(entry, tuple):
        kept = tuple(a for a in entry if a in mesh_axes)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return entry if entry in mesh_axes else None


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    mesh_axes: Sequence[str],
    rules: AxisRules = DEFAULT_RULES,
) -> Spec:
    """Map a tuple of logical axis names to a spec for this mesh."""
    return tuple(_filter_axes(rules.lookup(n), mesh_axes)
                 for n in logical_axes)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def spec_tree(logical_tree, mesh_axes, rules: AxisRules = DEFAULT_RULES):
    """Map a tree (nested dicts) of logical-axis tuples to a tree of specs."""
    if _is_axes(logical_tree):
        return logical_to_spec(logical_tree, mesh_axes, rules)
    return {k: spec_tree(logical_tree[k], mesh_axes, rules)
            for k in sorted(logical_tree)}


def batch_spec(mesh_axes: Sequence[str], rules: AxisRules = DEFAULT_RULES
               ) -> Spec:
    """Sharding of a [batch, seq, ...] activation."""
    return logical_to_spec(("batch", "seq"), mesh_axes, rules)


def kv_cache_spec(
    batch: int,
    num_kv_heads: int,
    dp_size: int,
    model_size: int,
    mesh_axes: Sequence[str],
    rules: AxisRules = DEFAULT_RULES,
) -> Spec:
    """Choose KV-cache sharding: [batch, seq, kv_heads, head_dim].

    - batch >= dp  : shard batch over dp; heads over model if divisible,
                     else shard the sequence over model.
    - batch <  dp  : (long_500k b=1) shard the *sequence* over dp, heads over
                     model if divisible.

    The JAX package exports it and lays out no cache by it; neither does
    the port: a model's cache leaves are cut by their logical axes
    (``TransformerLM.init_cache``), as the JAX dry run shards them.
    """
    dp = _filter_axes(rules.lookup("batch"), mesh_axes)
    model = _filter_axes(rules.lookup("heads"), mesh_axes)
    heads_ok = model is None or (num_kv_heads % max(model_size, 1) == 0)
    if batch >= dp_size and batch % max(dp_size, 1) == 0:
        if heads_ok:
            return (dp, None, model, None)
        return (dp, model, None, None)
    # tiny batch: shard sequence over dp
    if heads_ok:
        return (None, dp, model, None)
    if model is None or dp is None:
        return (None, dp, None, None)
    # the dp axes then "model", one flat entry (JAX's PartitionSpec refuses
    # the nested tuple its rule builds on the multi-pod mesh)
    return (None, entry_axes(dp) + (model,), None, None)


def entry_axes(entry: object) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def shards(entry: object, mesh_cfg: MeshConfig) -> int:
    """How many shards one spec entry cuts its dimension into."""
    n = 1
    for a in entry_axes(entry):
        n *= mesh_cfg.size(a)
    return n


def local_shape(shape: Sequence[int], spec: Spec,
                mesh_cfg: MeshConfig) -> Tuple[int, ...]:
    """A rank's shard shape of a ``shape`` tensor sharded as ``spec``;
    raises ValueError where a sharded dimension does not divide, and
    where a mesh axis of more than one device cuts two dimensions (JAX
    refuses such a spec; FSDP's "embed" meets itself so in a [d, d] leaf
    whose axes are both "embed", rwkv6's ``chan/wr``)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for a shape {tuple(shape)}")
    cut = [a for e in spec for a in entry_axes(e) if mesh_cfg.size(a) > 1]
    if len(cut) != len(set(cut)):
        raise ValueError(f"spec {spec} names a mesh axis twice")
    out = []
    for dim, entry in zip(shape, spec):
        n = shards(entry, mesh_cfg)
        if dim % n:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide into {n} shards ({spec})")
        out.append(dim // n)
    return tuple(out)


def shard_index(entry: object, coords: Mapping[str, int],
                mesh_cfg: MeshConfig) -> int:
    """The index of the rank at ``coords`` (mesh axis -> its index) among
    the shards of one spec entry: row-major over the entry's axes."""
    i = 0
    for a in entry_axes(entry):
        i = i * mesh_cfg.size(a) + coords[a]
    return i


def local_slice(tensor, spec: Spec, mesh_cfg: MeshConfig,
                coords: Mapping[str, int]):
    """The shard of ``tensor`` (whole, sharded as ``spec``) that the rank at
    ``coords`` holds: a view, narrowed dimension by dimension."""
    sizes = local_shape(tuple(tensor.shape), spec, mesh_cfg)
    out = tensor
    for d, (entry, n) in enumerate(zip(spec, sizes)):
        if entry is not None:
            out = out.narrow(d, shard_index(entry, coords, mesh_cfg) * n, n)
    return out


def local_spec(spec, mesh_cfg: MeshConfig, rules: AxisRules = DEFAULT_RULES):
    """A tree of ``nn.param.Param`` with each leaf's shape replaced by a
    rank's shard shape under ``rules`` on ``mesh_cfg``."""
    if isinstance(spec, dict):
        return {k: local_spec(spec[k], mesh_cfg, rules) for k in sorted(spec)}
    return spec._replace(shape=local_shape(
        spec.shape, logical_to_spec(spec.axes, mesh_cfg.axes, rules),
        mesh_cfg))

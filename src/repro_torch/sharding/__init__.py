"""The port's sharding layer: logical-axis rules (``rules``), their
adaptation to an arch, mesh and shape (``auto``), the activation
context (``ctx``) and the collectives the sharded path calls
(``collectives``)."""
from repro_torch.sharding.rules import (
    AxisRules,
    DEFAULT_RULES,
    batch_spec,
    kv_cache_spec,
    local_shape,
    local_slice,
    logical_to_spec,
    spec_tree,
)

__all__ = [
    "AxisRules",
    "DEFAULT_RULES",
    "batch_spec",
    "kv_cache_spec",
    "local_shape",
    "local_slice",
    "logical_to_spec",
    "spec_tree",
]

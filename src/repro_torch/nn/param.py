"""Parameter descriptors: the port's copy of ``repro.nn.param``.

A :class:`Param` records a tensor's shape, logical axes and initializer.
Modules build trees of Params (nested dicts); :func:`init_tree`
materializes a tree on an explicit ``torch.Generator`` with the JAX
package's init rules, and :class:`ParamTree` holds one as an
``nn.Module`` whose items read like the dicts of the JAX package
(``params["attn"]["wq"]["w"]``).  The two packages draw different
numbers from the same seed, so weights cross between them through
``repro_torch.models.common.params_from_jax``, never through the seed.

A loaded leaf is a frozen parameter aliasing the tree's tensor (or entry
``index`` of a stacked leaf), so a trainer (``train/step.py``) can make
the leaves trainable and point each one's ``.grad`` at the matching view
of a stacked gradient buffer: autograd then accumulates in place, and the
gradients come out as a tree with the JAX package's keys and shapes.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
from torch import nn

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16, "int8": torch.int8}


class Param(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed | fan_in
    scale: float = 1.0
    dtype: Optional[str] = None

    def check(self) -> "Param":
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)
        return self


def is_param(x: Any) -> bool:
    return isinstance(x, Param)


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a nested dict, in sorted key order (the
    order in which JAX flattens a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _initialize(p: Param, gen: torch.Generator, default_dtype: str):
    dtype = DTYPES[p.dtype or default_dtype]
    dev = gen.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=dev)
    if p.init in ("normal", "embed"):
        std = p.scale
    elif p.init == "fan_in":
        fan_in = p.shape[0] if len(p.shape) >= 2 else max(p.shape[0], 1)
        # stacked / expert leading dims do not contribute to fan-in
        if len(p.shape) == 3:
            fan_in = p.shape[1]
        std = p.scale / math.sqrt(fan_in)
    else:
        raise ValueError(f"unknown init {p.init!r}")
    if math.prod(p.shape) <= DRAW_LIMIT:
        x = torch.randn(p.shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (std * x).to(dtype)
    out = torch.empty(p.shape, dtype=dtype, device=dev)
    _draw_sliced(out, std, gen)
    return out


#: the most elements a leaf draws in one fp32 ``randn``.  A larger leaf is
#: drawn slice by slice along its leading (stacked) axis, each slice
#: scaled in place and written into the leaf, so its draw costs one fp32
#: slice beside the leaf, not two fp32 copies of it (qwen3-moe-30b-a3b's
#: stacked experts hold 9.66 G elements, 48 slices of 201 M).  It lies
#: above the largest leaf of the models drawn whole so far, gemma2-2b's
#: embedding (256000 x 2304 = 590 M elements), whose draws stay as they
#: were, bit for bit.
DRAW_LIMIT = 1 << 30


def _draw_sliced(out: torch.Tensor, std: float, gen: torch.Generator):
    for sl in out:
        if sl.numel() <= DRAW_LIMIT or sl.dim() == 1:
            x = torch.randn(sl.shape, generator=gen, device=sl.device,
                            dtype=torch.float32)
            sl.copy_(x.mul_(std))
        else:
            _draw_sliced(sl, std, gen)


def init_tree(spec, generator: torch.Generator,
              default_dtype: str = "bfloat16"):
    """Materialize a tree of Params into tensors on ``generator``'s
    device, one draw per leaf (per slice past ``DRAW_LIMIT``) in the JAX
    package's leaf order."""
    return tree_map(lambda p: _initialize(p.check(), generator,
                                          default_dtype), spec)


def stack_spec(spec, n: int, axis_name: Optional[str] = "layers"):
    """Prepend a stacked (layer) dimension of size `n` to every Param."""
    return tree_map(lambda p: Param((n,) + p.shape, (axis_name,) + p.axes,
                                    p.init, p.scale, p.dtype), spec)


class ParamTree(nn.Module):
    """The parameters of a spec tree as an ``nn.Module``: a Param leaf is
    an ``nn.Parameter`` (created on the meta device until :meth:`load`
    gives it a tensor), a dict a child ``ParamTree``.  Items read as the
    JAX package's dicts do: ``params["w"]``, ``"b" in params``,
    ``params.get("b")``."""

    def __init__(self, spec: dict, default_dtype: str):
        super().__init__()
        for k in sorted(spec):
            v = spec[k]
            if is_param(v):
                t = torch.empty(v.shape, dtype=DTYPES[v.dtype or default_dtype],
                                device="meta")
                self.register_parameter(k, nn.Parameter(t, requires_grad=False))
            else:
                self.add_module(k, ParamTree(v, default_dtype))

    def __getitem__(self, k: str):
        if k in self._parameters:
            return self._parameters[k]
        return self._modules[k]

    def __contains__(self, k: str) -> bool:
        return k in self._parameters or k in self._modules

    def get(self, k: str, default=None):
        return self[k] if k in self else default

    def load(self, tree: dict, index: Optional[int] = None) -> None:
        """Take the tensors of ``tree`` (same keys; with ``index``, entry
        ``index`` of each leaf's leading, stacked axis) as parameters,
        without a copy."""
        if set(tree) != set(self._parameters) | set(self._modules):
            raise ValueError(f"parameter tree keys {sorted(tree)} != "
                             f"{sorted(set(self._parameters) | set(self._modules))}")
        for k, v in tree.items():
            if k in self._modules:
                self._modules[k].load(v, index)
                continue
            t = v if index is None else v[index]
            old = self._parameters[k]
            if tuple(t.shape) != tuple(old.shape) or t.dtype != old.dtype:
                raise ValueError(f"parameter {k!r}: got {tuple(t.shape)} "
                                 f"{t.dtype}, expected {tuple(old.shape)} "
                                 f"{old.dtype}")
            self._parameters[k] = nn.Parameter(t, requires_grad=False)

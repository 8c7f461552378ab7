"""Shared model plumbing — blocks, cache specs, the Model API and the
weight converter: the port of ``repro.models.common``.

The JAX package keeps a model's layers stacked on a leading axis and runs
them under one ``lax.scan``; the port holds one ``ParamTree`` a layer
unit in an ``nn.ModuleList`` and runs them in a Python loop.  Parameter
*trees* keep the JAX layout (nested dicts, units stacked on a leading
``[n_scan]`` axis), so a tree made by :func:`init_tree` or carried over
from the JAX package by :func:`params_from_jax` loads into a model with
``BaseModel.load_tree`` without a copy.  The KV cache stays stacked
(``[n_scan, batch, S, kvh, hd]`` leaves) and the layers write into views
of it in place.  The sharding annotations of the JAX package have no
counterpart on one card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.nn.attention import attention_apply, attention_spec
from repro_torch.nn.mlp import mlp_apply, mlp_spec
from repro_torch.nn.moe import moe_apply, moe_spec
from repro_torch.nn.norm import (layernorm_apply, layernorm_spec,
                                 rmsnorm_apply, rmsnorm_spec)
from repro_torch.nn.param import (DTYPES, Param, init_tree, is_param,
                                  tree_map)

#: the batch axis of every cache leaf: [n_scan, batch, S, kvh, hd] for a
#: KV cache, [layers, batch, ...] for an RWKV state
CACHE_BATCH_AXIS = 1


# ---------------------------------------------------------------------------
# Norm dispatch
# ---------------------------------------------------------------------------


def norm_spec(cfg: ModelConfig, dim: int = 0) -> dict:
    dim = dim or cfg.d_model
    if cfg.norm_kind == "layernorm":
        return layernorm_spec(dim)
    return rmsnorm_spec(dim)


def norm_apply(params, x, cfg: ModelConfig):
    if cfg.norm_kind == "layernorm":
        return layernorm_apply(params, x, cfg.norm_eps)
    return rmsnorm_apply(params, x, cfg.norm_eps, plus_one=cfg.rms_plus_one)


# ---------------------------------------------------------------------------
# Standard pre-norm transformer block (dense or MoE)
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, use_moe: bool = False, cross: bool = False,
               d_in: int = 0) -> dict:
    """A pre-norm block; ``cross=True``: its attention reads K/V from a
    context of width ``d_in`` (default d_model), and the fp32 tanh gates
    of llama-3.2-vision's cross layers scale its two residuals."""
    spec = {
        "ln_attn": norm_spec(cfg),
        "attn": attention_spec(cfg, cross=cross, kv_dim=d_in or None),
        "ln_mlp": norm_spec(cfg),
        "mlp": moe_spec(cfg) if use_moe else mlp_spec(cfg),
    }
    if cfg.post_block_norms:
        spec["ln_attn_post"] = norm_spec(cfg)
        spec["ln_mlp_post"] = norm_spec(cfg)
    if cross:
        spec["gate_attn"] = Param((1,), (None,), init="zeros", dtype="float32")
        spec["gate_mlp"] = Param((1,), (None,), init="zeros", dtype="float32")
    return spec


def _gated(y, params, name: str, cross: bool):
    """``y * tanh(gate)`` in y's dtype where the block attends to a
    context (``cross``) and has the gate, else ``y``."""
    if cross and name in params:
        return y * torch.tanh(params[name]).to(y.dtype)
    return y


def block_apply(params, x, cfg: ModelConfig, *, window: int = 0,
                positions=None, mode: str = "full",
                cache: Optional[dict] = None, context=None,
                use_moe: bool = False, dp_size: int = 1,
                moe_mode: str = "train"):
    """(the block's output, its aux: the MoE block's, else ``{}``); its
    k/v go into ``cache`` in place.  The MoE block runs in ``decode`` in
    a decode step, else in ``moe_mode`` (``train`` or ``prefill``).  With
    a ``context`` the attention is cross-attention without RoPE, and each
    residual is scaled by its gate's tanh (``gate_attn``, ``gate_mlp``)."""
    aux: dict = {}
    h = norm_apply(params["ln_attn"], x, cfg)
    a = attention_apply(params["attn"], h, cfg, window=window,
                        positions=positions, mode=mode, cache=cache,
                        context=context, use_rope=context is None)
    if cfg.post_block_norms:
        a = norm_apply(params["ln_attn_post"], a, cfg)
    x = x + _gated(a, params, "gate_attn", context is not None)
    h = norm_apply(params["ln_mlp"], x, cfg)
    if use_moe:
        m, aux = moe_apply(params["mlp"], h, cfg, dp_size=dp_size,
                           mode="decode" if mode == "decode" else moe_mode)
    else:
        m = mlp_apply(params["mlp"], h, cfg)
    if cfg.post_block_norms:
        m = norm_apply(params["ln_mlp_post"], m, cfg)
    return x + _gated(m, params, "gate_mlp", context is not None), aux


def layer_call(remat: bool):
    """How a model calls a layer unit, ``call(fn, *args)``: with ``remat``
    while grad is enabled, under ``torch.utils.checkpoint`` (non-reentrant:
    the unit's activations are dropped after its forward and recomputed in
    the backward), as the JAX package's ``remat="full"`` in train mode;
    else a plain call."""
    if remat and torch.is_grad_enabled():
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False,
                                            preserve_rng_state=False)
    return lambda fn, *args: fn(*args)


def _sum_aux(a1: dict, a2: dict) -> dict:
    """Two blocks' aux losses added, as the JAX package's pair unit adds
    them before the scan's accumulation."""
    return {k: a1.get(k, 0.0) + a2.get(k, 0.0) for k in set(a1) | set(a2)
            if k.endswith("loss")}


#: the aux losses summed over the layers (``expert_fraction`` is not)
AUX_LOSSES = ("load_balance_loss", "router_z_loss")


def _zero_aux(device) -> dict:
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_LOSSES}


def _accumulate_aux(acc: dict, aux: dict) -> dict:
    out = dict(acc)
    for k in AUX_LOSSES:
        if aux and k in aux:
            out[k] = acc[k] + aux[k]
    return out


# ---------------------------------------------------------------------------
# KV-cache specs (as Param trees so the init machinery is reused)
# ---------------------------------------------------------------------------


def kv_cache_param(cfg: ModelConfig, batch: int, cache_len: int,
                   stacked: int = 0, dtype: str = "bfloat16") -> dict:
    """The KV cache of ``stacked`` layers (0: one, unstacked): bf16 ``k``
    and ``v`` [.., batch, S, kvh, hd], or with ``cfg.kv_quant`` int8
    ``k``/``v`` and fp16 ``k_scale``/``v_scale`` [.., batch, S, kvh]; every
    leaf's batch on ``CACHE_BATCH_AXIS`` when stacked."""
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    if stacked:
        shape = (stacked,) + shape
        axes = ("layers",) + axes
    if cfg.kv_quant:
        s_shape, s_axes = shape[:-1], axes[:-1]
        return {
            "k": Param(shape, axes, init="zeros", dtype="int8"),
            "k_scale": Param(s_shape, s_axes, init="zeros", dtype="float16"),
            "v": Param(shape, axes, init="zeros", dtype="int8"),
            "v_scale": Param(s_shape, s_axes, init="zeros", dtype="float16"),
        }
    return {
        "k": Param(shape, axes, init="zeros", dtype=dtype),
        "v": Param(shape, axes, init="zeros", dtype=dtype),
    }


def cross_cache_param(cfg: ModelConfig, batch: int, stacked: int) -> dict:
    """The bf16 cross K/V of ``stacked`` layers: [stacked, batch, t, kvh,
    hd] each, ``t`` the media (or frame) count of the config."""
    shape = (stacked, batch, cfg.cross_attn.num_media_tokens,
             cfg.num_kv_heads, cfg.head_dim)
    axes = ("layers", "batch", "media", "kv_heads", None)
    return {n: Param(shape, axes, init="zeros", dtype="bfloat16")
            for n in ("k", "v")}


def cache_index(cache, i: int):
    """Layer ``i``'s views of a stacked cache tree."""
    return None if cache is None else tree_map(lambda t: t[i], cache)


def cache_slot(cache, i: int):
    """Batch row ``i`` of every leaf (``CACHE_BATCH_AXIS``), as views of
    width 1."""
    return tree_map(lambda t: t.narrow(CACHE_BATCH_AXIS, i, 1), cache)


# ---------------------------------------------------------------------------
# Model API
# ---------------------------------------------------------------------------


class BaseModel(nn.Module):
    """A model: its parameter spec, its parameters (on the meta device
    until :meth:`init` or :meth:`load_tree`), forward / prefill / decode.
    The model runs on the device its parameters lie on."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg

    # -- parameters ----------------------------------------------------------
    def param_spec(self) -> dict:
        raise NotImplementedError

    def load_tree(self, tree: dict) -> "BaseModel":
        """Take a parameter tree in the JAX package's layout."""
        raise NotImplementedError

    def init(self, generator: torch.Generator) -> "BaseModel":
        """Random parameters by the JAX package's init rules, drawn from
        ``generator`` on its device."""
        return self.load_tree(init_tree(self.param_spec(), generator,
                                        self.cfg.param_dtype))

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # -- compute -------------------------------------------------------------
    def cache_spec(self, batch: int, cache_len: int, window: int = 0) -> dict:
        raise NotImplementedError

    def init_cache(self, batch: int, cache_len: int, window: int = 0,
                   device=None) -> dict:
        """A zero cache, each leaf in its spec's dtype or bf16 (the JAX
        package's default): bf16 KV caches, fp32 RWKV states.  On the
        model's device unless ``device`` is given."""
        dev = torch.device(device) if device is not None else self.device
        return tree_map(
            lambda p: torch.zeros(p.shape, dtype=DTYPES[p.dtype or "bfloat16"],
                                  device=dev),
            self.cache_spec(batch, cache_len, window))


# ---------------------------------------------------------------------------
# Weights from the JAX package
# ---------------------------------------------------------------------------


def _to_tensor(arr) -> torch.Tensor:
    a = np.array(arr, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes: exact, through the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The JAX package's parameter tree for ``cfg`` (nested dicts of numpy
    arrays, units stacked on a leading ``[n_scan]`` axis, gemma's units
    ``{"local", "global"}``, the VLM's self layers stacked twice, ``[n_groups,
    n_self, ...]``) as a tree of tensors on ``device`` that the
    port's model of ``cfg`` loads with ``load_tree``: ``cuda`` unless the
    caller asks for another (``resolve_device``; with no GPU and no device
    it raises, after the tree's keys and shapes are checked).  bf16
    leaves are carried bit for bit, fp32 ones (gates, biases, norms)
    exactly; every leaf's shape is checked against the port's spec."""
    from repro_torch.models.registry import get_model

    spec = get_model(cfg).param_spec()

    def walk(s, t, path):
        if is_param(s):
            x = _to_tensor(t)
            if tuple(x.shape) != tuple(s.shape):
                raise ValueError(f"{path}: shape {tuple(x.shape)}, the port's "
                                 f"spec has {tuple(s.shape)}")
            return x
        if not isinstance(t, dict) or set(t) != set(s):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            raise ValueError(f"{path}: keys {got}, expected {sorted(s)}")
        return {k: walk(s[k], t[k], f"{path}/{k}") for k in sorted(s)}

    host = walk(spec, tree, "params")
    dev = resolve_device(device)
    return tree_map(lambda x: x.to(dev), host)


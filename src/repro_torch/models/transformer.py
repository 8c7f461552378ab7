"""Decoder-only transformer LM, dense and MoE: the port of
``repro.models.transformer``.

Covers internlm2 / qwen1.5 / starcoder2 (uniform layers), gemma2
(alternating local/global attention, softcaps, post-block norms), whose
layer unit is a (local, global) *pair*, and grok-1 / qwen3-moe, whose
blocks' feed-forward is the MoE block (``nn/moe.py``): ``train`` or
``prefill`` capacity in :meth:`TransformerLM.forward` (its ``mode``),
worst-case capacity in :meth:`TransformerLM.decode_step`.

Built with a mesh's config and rules (``TransformerLM(cfg, mesh_cfg,
rules)``), the model holds one rank's shards: its ``ParamTree``s take the
local shapes (:func:`shard_params` or :func:`shard_init` carve them),
:meth:`TransformerLM.init_cache` makes the local cache, and
``forward``/``decode_step`` run on them under
``sharding.ctx.activation_sharding`` — tensor parallel over "model" (q, k,
v, gate and up column-parallel; o and down row-parallel; the vocab of the
embedding and the head cut; the MoE block's experts, or each expert's ff
axis, cut: ``nn/moe.py``), the batch over "data", the residual stream
replicated over "model".  :func:`check_executed` names what this path
does not take yet, and raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.core.config import MeshConfig, ModelConfig
from repro_torch.models.common import (BaseModel, _accumulate_aux,
                                       _sum_aux, _zero_aux, block_apply,
                                       block_spec, cache_index,
                                       kv_cache_param, layer_call,
                                       norm_apply, norm_spec)
from repro_torch.nn.embedding import embed_tokens, embedding_spec, lm_logits
from repro_torch.nn.param import (ParamTree, _initialize, is_param,
                                  stack_spec)
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.collectives import gather_over
from repro_torch.sharding.rules import (AxisRules, entry_axes, local_slice,
                                        logical_to_spec, shards)


class TransformerLM(BaseModel):
    """Dense or MoE decoder-only LM: ``embed``, ``layers`` (an
    ``nn.ModuleList`` of ``n_scan`` units) and ``ln_f``."""

    def __init__(self, cfg: ModelConfig,
                 mesh_cfg: Optional[MeshConfig] = None,
                 rules: Optional[AxisRules] = None):
        super().__init__(cfg, mesh_cfg, rules)
        self.use_moe = cfg.moe is not None
        self.pair = cfg.local_global_interval == 2
        assert cfg.local_global_interval in (0, 2), "only k=2 alternation"
        if self.pair:
            assert cfg.num_layers % 2 == 0
        self.n_scan = cfg.num_layers // (2 if self.pair else 1)
        if mesh_cfg is not None:
            check_executed(cfg, mesh_cfg, rules)
        dt = cfg.param_dtype
        self._fsdp = {k: fsdp_plan(v, mesh_cfg, rules) for k, v in (
            ("embed", embedding_spec(cfg)), ("ln_f", norm_spec(cfg)),
            ("unit", self._unit_spec()))}
        spec = self._local(self.param_spec())
        self.embed = ParamTree(spec["embed"], dt)
        self.layers = nn.ModuleList(
            ParamTree(self._local(self._unit_spec()), dt)
            for _ in range(self.n_scan))
        self.ln_f = ParamTree(spec["ln_f"], dt)

    # -- params ---------------------------------------------------------------
    def _unit_spec(self) -> dict:
        if self.pair:
            return {"local": block_spec(self.cfg, self.use_moe),
                    "global": block_spec(self.cfg, self.use_moe)}
        return block_spec(self.cfg, self.use_moe)

    def param_spec(self) -> dict:
        return {
            "embed": embedding_spec(self.cfg),
            "layers": stack_spec(self._unit_spec(), self.n_scan),
            "ln_f": norm_spec(self.cfg),
        }

    def load_tree(self, tree: dict) -> "TransformerLM":
        self.embed.load(tree["embed"])
        for i, unit in enumerate(self.layers):
            unit.load(tree["layers"], i)
        self.ln_f.load(tree["ln_f"])
        return self

    # -- windows --------------------------------------------------------------
    def _windows(self, window_override: int) -> Tuple[int, int]:
        """(local_window, global_window) per unit."""
        cfg = self.cfg
        if self.pair:
            return cfg.sliding_window, window_override
        return cfg.sliding_window or window_override, 0

    def _unit(self, unit, x, c_i, lw, gw, kw):
        """One layer unit (a local/global pair for gemma2) -> (its output,
        its blocks' aux losses summed); its FSDP'd leaves gathered here,
        inside the remat, so that the backward's recompute gathers them
        again and no whole weight outlives its unit."""
        unit = fsdp_gather(unit, self._fsdp["unit"])
        if self.pair:
            blocks = [(unit[k], w, None if c_i is None else c_i[k])
                      for k, w in (("local", lw), ("global", gw))]
        else:
            blocks = [(unit, lw, c_i)]
        aux: dict = {}
        for params, window, c in blocks:
            x, a = block_apply(params, x, self.cfg, window=window, cache=c,
                               **kw)
            aux = _sum_aux(aux, a) if self.pair else a
        return x, aux

    def _layers(self, x, positions, mode, cache, lw, gw, moe_mode="train",
                aux=None, dp_size=None):
        """(the final norm of the last block's output, ``aux`` plus the
        blocks' aux losses; None stays None: a decode step sums none).  A
        forward in train mode without a cache remats each unit.  The MoE
        blocks group their tokens by ``dp_size``: the JAX call's, by
        default the active mesh's data size (1 without one)."""
        kw = dict(positions=positions, mode=mode, use_moe=self.use_moe,
                  moe_mode=moe_mode,
                  dp_size=shard_ctx.data_size() if dp_size is None
                  else dp_size)
        call = layer_call(mode == "full" and moe_mode == "train"
                          and cache is None)
        for i, unit in enumerate(self.layers):
            x, a = call(self._unit, unit, x, cache_index(cache, i), lw, gw,
                        kw)
            if aux is not None:
                aux = _accumulate_aux(aux, a)
        return norm_apply(fsdp_gather(self.ln_f, self._fsdp["ln_f"]), x,
                          self.cfg), aux

    # -- forward (prefill) ------------------------------------------------------
    def forward(self, batch: dict, mode: str = "train", *,
                window_override: int = 0, cache=None, dp_size=None):
        """batch: {"tokens": [b, s], "positions": optional [b, s]} ->
        (fp32 logits [b, s, V] at every position, aux), or with ``cache``
        (logits, cache, aux): the prompt's k/v written into ``cache`` in
        place.  ``mode`` (``train`` or ``prefill``) sets the MoE blocks'
        capacity and ``dp_size`` their token groups (the JAX package's
        argument; by default the active mesh's data size, 1 without one);
        aux holds the MoE losses summed over the blocks (zeros for a
        dense model), as the JAX package's."""
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        embed = fsdp_gather(self.embed, self._fsdp["embed"])
        x = embed_tokens(embed, tokens, self.cfg,
                         scale_by_dim=self.cfg.rms_plus_one)
        lw, gw = self._windows(window_override)
        x, aux = self._layers(x, positions, "full", cache, lw, gw, mode,
                              _zero_aux(x.device), dp_size)
        # training takes the rank's vocab slice (train.step.cross_entropy)
        logits = lm_logits(embed, x, self.cfg, gather=mode != "train")
        if cache is not None:
            return logits, cache, aux
        return logits, aux

    # -- caches ----------------------------------------------------------------
    def cache_spec(self, batch: int, cache_len: int, window: int = 0) -> dict:
        lw, gw = self._windows(window)

        def clen(w):
            return min(cache_len, w) if w > 0 else cache_len

        if self.pair:
            return {
                "local": kv_cache_param(self.cfg, batch, clen(lw),
                                        stacked=self.n_scan),
                "global": kv_cache_param(self.cfg, batch, clen(gw),
                                         stacked=self.n_scan),
            }
        return kv_cache_param(self.cfg, batch, clen(lw), stacked=self.n_scan)

    # -- decode ------------------------------------------------------------------
    def decode_step(self, tokens, positions, cache, *, window: int = 0,
                    dp_size=None):
        """tokens [b, 1], positions [b] -> (logits [b, 1, V], cache), the
        new k/v written into ``cache`` in place; ``dp_size`` as in
        :meth:`forward`."""
        embed = fsdp_gather(self.embed, self._fsdp["embed"])
        x = embed_tokens(embed, tokens, self.cfg,
                         scale_by_dim=self.cfg.rms_plus_one)
        lw, gw = self._windows(window)
        x, _ = self._layers(x, positions, "decode", cache, lw, gw,
                            dp_size=dp_size)
        return lm_logits(embed, x, self.cfg), cache


# ---------------------------------------------------------------------------
# Tensor parallelism: what the executed path takes, and the rank's shards
# ---------------------------------------------------------------------------

#: a rule the executed path does not take yet, where it cuts an axis: the
#: logical axis and what it names
UNSUPPORTED = (
    ("seq_res", "seq_sp's residual-stream sequence ('seq_res')"),
)


def check_executed(cfg: ModelConfig, mesh_cfg: MeshConfig,
                   rules: AxisRules) -> None:
    """Raise NotImplementedError, naming the rule, where ``cfg`` on
    ``mesh_cfg`` under ``rules`` needs what the executed sharded path (the
    dense, MoE, ssm and hybrid families' train step, prefill and decode,
    tensor parallel over "model", data parallel over "data", FSDP's
    "embed" gathered unit by unit, q heads cut over whole kv heads, the
    cache cut by sequence over any of its axes, the MoE block's experts or
    each expert's ff axis over "model" with the capacity of a data group,
    the RWKV6 and Mamba2 heads over "model" with their "ssm_inner"
    projections) does not take yet; every spec is still reckoned by the
    dry run."""
    def cut(axis):
        entry = logical_to_spec((axis,), mesh_cfg.axes, rules)[0]
        return entry, shards(entry, mesh_cfg)

    if cfg.cross_attn is not None:
        raise NotImplementedError(
            f"the {cfg.family} family's 'media' (the cross-attention "
            f"context) on a mesh: not in the executed path yet")
    if cfg.ssm is not None or cfg.rwkv is not None:
        entry, n = cut("embed")
        if n > 1:  # rwkv6's chan/wr [d, d] would name its axes twice
            raise NotImplementedError(
                f"FSDP's 'embed' over {entry_axes(entry)} for the "
                f"{cfg.family} family on the mesh {mesh_cfg.shape}: not in "
                f"the executed path yet")
        (h_entry, h), (s_entry, i) = cut("heads"), cut("ssm_inner")
        if (h > 1 or i > 1) and entry_axes(h_entry) != entry_axes(s_entry):
            raise NotImplementedError(
                f"the {cfg.family} family's 'heads' over "
                f"{entry_axes(h_entry)} ({h} shards) and 'ssm_inner' over "
                f"{entry_axes(s_entry)} ({i}) on the mesh {mesh_cfg.shape}: "
                f"the executed path cuts a rank's heads with their inner "
                f"dimension")
    for axis, what in UNSUPPORTED:
        entry, n = cut(axis)
        if n > 1:
            raise NotImplementedError(
                f"{what} over {entry_axes(entry)} on the mesh "
                f"{mesh_cfg.shape}: not in the executed path yet")
    heads, kv = cut("heads")[1], cut("kv_heads")[1]
    if kv > 1 and heads != kv:
        raise NotImplementedError(
            f"kv heads in {kv} shards and q heads in {heads}: the executed "
            f"path cuts the kv heads only as the q heads")


#: the mesh axes a batch is split over: FSDP's "embed" cuts a leaf over them
DATA_AXES = ("pod", "data")


def fsdp_plan(spec, mesh_cfg: Optional[MeshConfig], rules: AxisRules):
    """For each leaf of ``spec`` (a tree of ``Param``), the (dimension,
    mesh axes) that the data axes cut under ``rules`` on ``mesh_cfg``
    (FSDP's "embed"), or None; a subtree none of whose leaves is cut, and
    a mesh without one, give None."""
    if mesh_cfg is None:
        return None
    if is_param(spec):
        for dim, entry in enumerate(logical_to_spec(spec.axes,
                                                    mesh_cfg.axes, rules)):
            axes = entry_axes(entry)
            if (axes and all(a in DATA_AXES for a in axes)
                    and shards(entry, mesh_cfg) > 1):
                return dim, axes
        return None
    plan = {k: fsdp_plan(v, mesh_cfg, rules) for k, v in spec.items()}
    return plan if any(v is not None for v in plan.values()) else None


def fsdp_gather(params, plan):
    """``params`` (a ``ParamTree`` or a dict) with every leaf that
    ``plan`` (:func:`fsdp_plan`'s) cuts gathered over its data axes, as a
    dict; ``params`` itself where ``plan`` is None.  Each gather's adjoint
    sums the data ranks' gradients onto the rank's shard, in rank order."""
    if plan is None:
        return params
    if isinstance(plan, tuple):
        dim, axes = plan
        return gather_over(axes, params, dim)
    return {k: fsdp_gather(params[k], plan.get(k)) for k in _keys(params)}


def _keys(params):
    if isinstance(params, dict):
        return list(params)
    return list(params._parameters) + list(params._modules)


def _spec(cfg: ModelConfig) -> dict:
    """The whole parameter spec of ``cfg``'s model, any family."""
    from repro_torch.models.registry import get_model

    return get_model(cfg).param_spec()


def _carve(spec, full, mesh, rules: AxisRules, device, path=""):
    """The rank's tree: ``full(path, p)`` gives each leaf whole, one at a
    time, and only its local slice is kept (a copy on ``device``)."""
    from repro_torch.sharding.ctx import mesh_config_of

    m = mesh_config_of(mesh)
    coords = dict(zip(m.axes, (int(c) for c in mesh.get_coordinate())))

    def walk(s, p):
        if is_param(s):
            whole = full(p, s)
            spec_ = logical_to_spec(s.axes, m.axes, rules)
            return local_slice(whole, spec_, m, coords).to(
                whole.device if device is None else device, copy=True)
        return {k: walk(s[k], f"{p}/{k}") for k in sorted(s)}

    return walk(spec, path)


def shard_params(cfg: ModelConfig, tree: dict, mesh, rules: AxisRules,
                 device=None) -> dict:
    """The rank's shards of the whole parameter tree ``tree`` (the JAX
    package's layout: ``params_from_jax``'s, ``init_tree``'s) on ``mesh``
    under ``rules``, leaf by leaf: each local slice is copied to
    ``device`` (the leaf's own by default) as it is cut.  The model of
    ``get_model(cfg, mesh_cfg, rules)`` loads the result."""
    spec = _spec(cfg)

    def full(path, p):
        t = tree
        for k in path.strip("/").split("/"):
            t = t[k]
        return t

    return _carve(spec, full, mesh, rules, device)


def shard_init(cfg: ModelConfig, generator: torch.Generator, mesh,
               rules: AxisRules) -> dict:
    """The rank's shards of the tree ``init_tree`` draws from
    ``generator`` (the same draws in the same order), each leaf drawn
    whole on the generator's device and cut at once: no whole tree is
    ever held."""
    spec = _spec(cfg)
    return _carve(spec, lambda path, p: _initialize(
        p.check(), generator, cfg.param_dtype), mesh, rules,
        generator.device)


def shard_opt_state(cfg: ModelConfig, opt: dict, mesh, rules: AxisRules,
                    device=None) -> dict:
    """The rank's shards of a whole optimizer tree ``opt`` (``{"m", "v",
    "step"}``, the JAX package's layout: numpy or tensors) on ``mesh``
    under ``rules``: each moment cut as ``adamw_init_spec(zero1=True,
    dp_size, fsdp)`` specifies it (``optimizer.shard_plan``'s shapes), FSDP
    on where the rules cut "embed"; the step whole."""
    from repro_torch.models.common import _to_tensor
    from repro_torch.sharding.ctx import mesh_config_of
    from repro_torch.train.optimizer import adamw_init_spec

    m = mesh_config_of(mesh)
    spec = _spec(cfg)
    mspec = adamw_init_spec(spec, zero1=True, dp_size=m.dp_size,
                            fsdp=dict(rules.table).get("embed") is not None)

    def full(tree):
        def get(path, p):
            t = tree
            for k in path.strip("/").split("/"):
                t = t[k]
            return t if isinstance(t, torch.Tensor) else _to_tensor(t)
        return get

    out = {part: _carve(mspec[part], full(opt[part]), mesh, rules, device)
           for part in ("m", "v")}
    step = opt["step"]
    step = step if isinstance(step, torch.Tensor) else _to_tensor(step)
    out["step"] = step.to(torch.int32).to(
        device if device is not None else step.device, copy=True)
    return out


def unshard(spec, tree: dict, mesh_cfg: MeshConfig, rules: AxisRules) -> dict:
    """The whole tree of a rank's shards ``tree`` (laid out as the
    ``Param`` tree ``spec``: a model's ``param_spec()``, or the moments
    of ``adamw_init_spec``), each cut dimension gathered over its mesh
    axes; run it on every rank at once, under the mesh's
    ``activation_sharding``."""
    def walk(s, t):
        if is_param(s):
            for dim, entry in enumerate(logical_to_spec(s.axes, mesh_cfg.axes,
                                                        rules)):
                if shards(entry, mesh_cfg) > 1:
                    t = gather_over(entry_axes(entry), t, dim)
            return t
        return {k: walk(s[k], t[k]) for k in sorted(s)}

    with torch.no_grad():
        return walk(spec, tree)

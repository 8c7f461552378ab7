"""Llama-3.2-Vision style VLM decoder — the port of
``repro.models.vision_lm``: self-attention layers with a gated
cross-attention layer every ``cross_attn.interval`` layers.

The vision frontend is a stub, as in the JAX package:
``batch["media_embeds"]`` carries precomputed patch embeddings [b,
n_media, media_dim]; only the projector and the language decoder run.
The cross layers' K/V are computed once, in the prefill, and cached for
decode.

The parameter tree keeps JAX's layout: ``layers`` = ``{"self": [n_groups,
n_self, ...], "cross": [n_groups, ...]}``.  The port holds one
``ParamTree`` a layer, self layer ``j`` of group ``g`` loaded from entry
``[g][j]``.  The cache keeps every leaf's batch on ``CACHE_BATCH_AXIS``:
the self cache is ``[n_groups * n_self, b, S, kvh, hd]`` (layer ``g *
n_self + j``), where JAX stacks it ``[n_groups, n_self, b, ...]``, and
the cross cache is ``[n_groups, b, t, kvh, hd]`` in bf16 whatever the
model's dtype, as JAX rounds it.  A prefill computes each cross layer's
k/v once and writes the rounded copy into the cache; the layer's own
attention reads the unrounded k/v, as JAX's does.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.models.common import (BaseModel, _gated, _zero_aux,
                                       block_apply, block_spec, cache_index,
                                       cross_cache_param, kv_cache_param,
                                       layer_call, norm_apply, norm_spec)
from repro_torch.nn.attention import cross_attention_cached
from repro_torch.nn.embedding import embed_tokens, embedding_spec, lm_logits
from repro_torch.nn.linear import dense, linear_spec
from repro_torch.nn.mlp import mlp_apply
from repro_torch.nn.param import ParamTree, stack_spec, tree_map

#: (mean, std) of the normal ``vision_redraw`` draws the cross layers'
#: gates from: tanh(gate) about 0.76, away from the init's 0
GATE_REDRAW = (1.0, 0.25)


class VisionLM(BaseModel):
    """``embed``, ``projector``, ``self_layers`` (an ``nn.ModuleList`` of
    ``n_groups * n_self`` blocks), ``cross_layers`` (one gated cross block
    a group) and ``ln_f``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        interval = cfg.cross_attn.interval
        assert interval > 1 and cfg.num_layers % interval == 0
        self.n_groups = cfg.num_layers // interval
        self.n_self = interval - 1
        dt = cfg.param_dtype
        spec = self.param_spec()
        self.embed = ParamTree(spec["embed"], dt)
        self.projector = ParamTree(spec["projector"], dt)
        self.self_layers = nn.ModuleList(
            ParamTree(block_spec(cfg), dt)
            for _ in range(self.n_groups * self.n_self))
        self.cross_layers = nn.ModuleList(
            ParamTree(self._cross_spec(), dt) for _ in range(self.n_groups))
        self.ln_f = ParamTree(spec["ln_f"], dt)

    # -- params ---------------------------------------------------------------
    def _cross_spec(self) -> dict:
        return block_spec(self.cfg, cross=True, d_in=self.cfg.d_model)

    def param_spec(self) -> dict:
        cfg = self.cfg
        unit = {"self": stack_spec(block_spec(cfg), self.n_self,
                                   axis_name=None),
                "cross": self._cross_spec()}
        return {
            "embed": embedding_spec(cfg),
            "projector": linear_spec(cfg.cross_attn.media_dim, cfg.d_model,
                                     "media", "embed", bias=True),
            "layers": stack_spec(unit, self.n_groups),
            "ln_f": norm_spec(cfg),
        }

    def load_tree(self, tree: dict) -> "VisionLM":
        self.embed.load(tree["embed"])
        self.projector.load(tree["projector"])
        for g in range(self.n_groups):
            group = tree_map(lambda t: t[g], tree["layers"]["self"])
            for j in range(self.n_self):
                self.self_layers[g * self.n_self + j].load(group, j)
            self.cross_layers[g].load(tree["layers"]["cross"], g)
        self.ln_f.load(tree["ln_f"])
        return self

    # -- caches ----------------------------------------------------------------
    def cache_spec(self, batch: int, cache_len: int, window: int = 0) -> dict:
        S = min(cache_len, window) if window > 0 else cache_len
        return {"self": kv_cache_param(self.cfg, batch, S,
                                       stacked=self.n_groups * self.n_self),
                "cross": cross_cache_param(self.cfg, batch, self.n_groups)}

    # -- compute --------------------------------------------------------------
    def _self_layers(self, g, x, *, window, positions, mode, cache):
        for j in range(self.n_self):
            i = g * self.n_self + j
            x, _ = block_apply(self.self_layers[i], x, self.cfg,
                               window=window, positions=positions, mode=mode,
                               cache=cache_index(cache, i))
        return x

    def _cross_prefill(self, g, x, media, positions, cache):
        """Group ``g``'s gated cross layer against ``media``; with a
        ``cache`` (the layer's cross views) its k/v go there, in bf16."""
        x, _ = block_apply(self.cross_layers[g], x, self.cfg,
                           positions=positions, mode="full", context=media,
                           cache=cache)
        return x

    def _group(self, g, x, media, window, positions, self_c, cross_c):
        """Group ``g`` in full mode: its self layers, then its cross layer
        (the JAX package's scan unit, rematted in train mode)."""
        x = self._self_layers(g, x, window=window, positions=positions,
                              mode="full", cache=self_c)
        return self._cross_prefill(g, x, media, positions, cross_c)

    def forward(self, batch: dict, mode: str = "train", *,
                window_override: int = 0, cache=None):
        """batch: {"tokens": [b, s], "media_embeds": [b, t, media_dim]} ->
        (fp32 logits [b, s, V], aux), or with ``cache`` (logits, cache,
        aux): the prompt's self k/v and each group's cross k/v (bf16)
        written into ``cache`` in place.  Every layer runs in full mode,
        as in the JAX package; aux is zeros."""
        cfg = self.cfg
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        media = dense(self.projector, batch["media_embeds"])
        x = embed_tokens(self.embed, tokens, cfg)
        window = cfg.sliding_window or window_override
        self_c = None if cache is None else cache["self"]
        cross_c = None if cache is None else cache["cross"]
        call = layer_call(mode == "train" and cache is None)
        for g in range(self.n_groups):
            x = call(self._group, g, x, media, window, positions, self_c,
                     cache_index(cross_c, g))
        x = norm_apply(self.ln_f, x, cfg)
        logits = lm_logits(self.embed, x, cfg)
        aux = _zero_aux(logits.device)
        if cache is not None:
            return logits, cache, aux
        return logits, aux

    def _cross_decode(self, g, x, cache):
        """Group ``g``'s cross layer in a decode step, as the JAX package
        writes it: norm, attention against the cached media K/V, gate,
        norm, MLP, gate (no post-block norms)."""
        cfg, unit = self.cfg, self.cross_layers[g]
        h = norm_apply(unit["ln_attn"], x, cfg)
        a = cross_attention_cached(unit["attn"], h, cache["k"], cache["v"],
                                   cfg)
        x = x + _gated(a, unit, "gate_attn", True)
        h = norm_apply(unit["ln_mlp"], x, cfg)
        m = mlp_apply(unit["mlp"], h, cfg)
        return x + _gated(m, unit, "gate_mlp", True)

    def decode_step(self, tokens, positions, cache, *, window: int = 0):
        """tokens [b, 1], positions [b] -> (logits [b, 1, V], cache), the
        new self k/v written into ``cache`` in place; the cross caches are
        read only."""
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, cfg)
        w = cfg.sliding_window or window
        for g in range(self.n_groups):
            x = self._self_layers(g, x, window=w, positions=positions,
                                  mode="decode", cache=cache["self"])
            x = self._cross_decode(g, x, cache_index(cache["cross"], g))
        x = norm_apply(self.ln_f, x, cfg)
        return lm_logits(self.embed, x, cfg), cache


def vision_redraw(tree: dict, generator: torch.Generator) -> None:
    """Make a VLM parameter tree (JAX layout) one whose cross path shows,
    in place, on ``generator``'s device:

    * the cross layers' ``gate_attn`` and ``gate_mlp`` (zeros at init, so
      tanh(gate) = 0 and the cross path adds nothing) drawn from
      N(``GATE_REDRAW``);
    * the self layers' matrices ``[n_groups, n_self, d_in, d_out]``,
      which the init's fan-in rule (the JAX package's, kept) draws at std
      1/sqrt(n_groups), scaled to std 1/sqrt(d_in).  At full width they
      would otherwise swamp the gated residual (std 0.354 against
      0.0156).

    Tests and ``chip_smoke.py`` apply it before both packages get the
    tree; ``init_tree`` itself keeps JAX's rule."""
    mean, std = GATE_REDRAW
    cross = tree["layers"]["cross"]
    for name in ("gate_attn", "gate_mlp"):
        t = cross[name]
        t.copy_(mean + std * torch.randn(t.shape, generator=generator,
                                         device=t.device,
                                         dtype=torch.float32))

    def rescale(t):
        if t.dim() == 4:
            for sl in t:  # a group at a time: no fp32 copy of the leaf
                sl.mul_(math.sqrt(t.shape[0] / t.shape[2]))
        return t

    tree_map(rescale, tree["layers"]["self"])

"""Decoder-only transformer LM, dense and MoE: the port of
``repro.models.transformer``.

Covers internlm2 / qwen1.5 / starcoder2 (uniform layers), gemma2
(alternating local/global attention, softcaps, post-block norms), whose
layer unit is a (local, global) *pair*, and grok-1 / qwen3-moe, whose
blocks' feed-forward is the MoE block (``nn/moe.py``): ``train`` or
``prefill`` capacity in :meth:`TransformerLM.forward` (its ``mode``),
worst-case capacity in :meth:`TransformerLM.decode_step`.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.models.common import (BaseModel, _accumulate_aux,
                                       _sum_aux, _zero_aux, block_apply,
                                       block_spec, cache_index,
                                       kv_cache_param, layer_call,
                                       norm_apply, norm_spec)
from repro_torch.nn.embedding import embed_tokens, embedding_spec, lm_logits
from repro_torch.nn.param import ParamTree, stack_spec


class TransformerLM(BaseModel):
    """Dense or MoE decoder-only LM: ``embed``, ``layers`` (an
    ``nn.ModuleList`` of ``n_scan`` units) and ``ln_f``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        self.use_moe = cfg.moe is not None
        self.pair = cfg.local_global_interval == 2
        assert cfg.local_global_interval in (0, 2), "only k=2 alternation"
        if self.pair:
            assert cfg.num_layers % 2 == 0
        self.n_scan = cfg.num_layers // (2 if self.pair else 1)
        dt = cfg.param_dtype
        spec = self.param_spec()
        self.embed = ParamTree(spec["embed"], dt)
        self.layers = nn.ModuleList(ParamTree(self._unit_spec(), dt)
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
        its blocks' aux losses summed)."""
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
                aux=None):
        """(the final norm of the last block's output, ``aux`` plus the
        blocks' aux losses; None stays None: a decode step sums none).  A
        forward in train mode without a cache remats each unit."""
        kw = dict(positions=positions, mode=mode, use_moe=self.use_moe,
                  moe_mode=moe_mode)
        call = layer_call(mode == "full" and moe_mode == "train"
                          and cache is None)
        for i, unit in enumerate(self.layers):
            x, a = call(self._unit, unit, x, cache_index(cache, i), lw, gw,
                        kw)
            if aux is not None:
                aux = _accumulate_aux(aux, a)
        return norm_apply(self.ln_f, x, self.cfg), aux

    # -- forward (prefill) ------------------------------------------------------
    def forward(self, batch: dict, mode: str = "train", *,
                window_override: int = 0, cache=None):
        """batch: {"tokens": [b, s], "positions": optional [b, s]} ->
        (fp32 logits [b, s, V] at every position, aux), or with ``cache``
        (logits, cache, aux): the prompt's k/v written into ``cache`` in
        place.  ``mode`` (``train`` or ``prefill``) sets the MoE blocks'
        capacity; aux holds the MoE losses summed over the blocks (zeros
        for a dense model), as the JAX package's."""
        tokens = batch["tokens"]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device)[None, :]
        x = embed_tokens(self.embed, tokens, self.cfg,
                         scale_by_dim=self.cfg.rms_plus_one)
        lw, gw = self._windows(window_override)
        x, aux = self._layers(x, positions, "full", cache, lw, gw, mode,
                              _zero_aux(x.device))
        logits = lm_logits(self.embed, x, self.cfg)
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
    def decode_step(self, tokens, positions, cache, *, window: int = 0):
        """tokens [b, 1], positions [b] -> (logits [b, 1, V], cache), the
        new k/v written into ``cache`` in place."""
        x = embed_tokens(self.embed, tokens, self.cfg,
                         scale_by_dim=self.cfg.rms_plus_one)
        lw, gw = self._windows(window)
        x, _ = self._layers(x, positions, "decode", cache, lw, gw)
        return lm_logits(self.embed, x, self.cfg), cache

"""Zamba2 hybrid: a Mamba2 backbone and one *shared* attention block — the
port of ``repro.models.zamba2``.

``num_layers`` Mamba2 blocks (``nn/ssm.py``) run in groups of
``shared_attn_every``; after each group the shared transformer block runs
on ``concat(hidden, original_embedding)`` at width 2·d_model, and its
output is projected back to d_model (``shared_out``), scaled by the
invocation's fp32 layerscale and added to the residual.  The blocks left
over after the last group (``mamba_tail``) follow the last invocation.

The JAX package stacks the Mamba blocks, reshapes them to [groups,
group] and scans each group; the port holds one ``ParamTree`` a block in
an ``nn.ModuleList`` and runs block ``gi·group + j`` in a Python loop.
The cache stays stacked and mixes two kinds of leaf: fp32 ``conv`` rows
and SSD ``state``s a Mamba block, and a bf16 KV cache a shared-block
invocation (``shared_kv``, [groups, batch, S, kvh, hd]); every leaf has
its batch on ``CACHE_BATCH_AXIS``.  The blocks write into views of it in
place.  A prompt runs the chunked SSD scan and, on the card, K10 in every
invocation; every projection runs K3.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.models.common import (BaseModel, _zero_aux, block_apply,
                                       block_spec, cache_index,
                                       kv_cache_param, layer_call, norm_apply,
                                       norm_spec)
from repro_torch.nn.embedding import embed_tokens, embedding_spec, lm_logits
from repro_torch.nn.linear import dense, linear_spec
from repro_torch.nn.param import Param, ParamTree, stack_spec
from repro_torch.nn.ssm import ssm_apply, ssm_dims, ssm_spec


class Zamba2LM(BaseModel):
    """``embed``, ``mamba`` (an ``nn.ModuleList`` of one unit a block:
    ``ln``, ``ssm``), ``mamba_tail`` (likewise, maybe empty), ``shared``
    (the wide block), ``shared_out``, ``layerscale`` and ``ln_f``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        every = cfg.shared_attn_every
        assert every > 0
        self.n_groups = cfg.num_layers // every  # shared-block invocations
        self.group = every
        self.n_tail = cfg.num_layers - self.n_groups * every
        # the shared block operates at width 2*d_model
        self.wide_cfg = dataclasses.replace(
            cfg, d_model=2 * cfg.d_model, moe=None, ssm=None,
            shared_attn_every=0)
        dt = cfg.param_dtype
        spec = self.param_spec()
        self.embed = ParamTree(spec["embed"], dt)
        self.mamba = nn.ModuleList(ParamTree(self._mamba_unit(), dt)
                                   for _ in range(self.n_groups * every))
        self.mamba_tail = nn.ModuleList(ParamTree(self._mamba_unit(), dt)
                                        for _ in range(self.n_tail))
        self.shared = ParamTree(spec["shared"], dt)
        self.shared_out = ParamTree(spec["shared_out"], dt)
        self.layerscale = ParamTree({"scale": spec["layerscale"]}, dt)
        self.ln_f = ParamTree(spec["ln_f"], dt)

    # -- params ---------------------------------------------------------------
    def _mamba_unit(self) -> dict:
        return {"ln": norm_spec(self.cfg), "ssm": ssm_spec(self.cfg)}

    def param_spec(self) -> dict:
        cfg = self.cfg
        spec = {
            "embed": embedding_spec(cfg),
            "mamba": stack_spec(self._mamba_unit(),
                                self.n_groups * self.group),
            "shared": block_spec(self.wide_cfg),
            "shared_out": linear_spec(2 * cfg.d_model, cfg.d_model,
                                      "ff", "embed"),
            "layerscale": Param((self.n_groups, cfg.d_model),
                                (None, "embed"), init="ones", dtype="float32"),
            "ln_f": norm_spec(cfg),
        }
        if self.n_tail:
            spec["mamba_tail"] = stack_spec(self._mamba_unit(), self.n_tail)
        return spec

    def load_tree(self, tree: dict) -> "Zamba2LM":
        want = set(self.param_spec())
        if set(tree) != want:
            raise ValueError(f"parameter tree keys {sorted(tree)} != "
                             f"{sorted(want)}")
        self.embed.load(tree["embed"])
        for i, unit in enumerate(self.mamba):
            unit.load(tree["mamba"], i)
        for i, unit in enumerate(self.mamba_tail):
            unit.load(tree["mamba_tail"], i)
        self.shared.load(tree["shared"])
        self.shared_out.load(tree["shared_out"])
        self.layerscale.load({"scale": tree["layerscale"]})
        self.ln_f.load(tree["ln_f"])
        return self

    # -- caches ----------------------------------------------------------------
    def _mamba_cache_unit(self, batch: int, stacked: int) -> dict:
        cfg = self.cfg
        d_inner, h = ssm_dims(cfg)
        n, K = cfg.ssm.d_state, cfg.ssm.d_conv
        c = d_inner + 2 * n
        return {
            "conv": Param((stacked, batch, K - 1, c),
                          ("layers", "batch", None, "ssm_inner"),
                          init="zeros", dtype="float32"),
            "state": Param((stacked, batch, h, cfg.ssm.head_dim, n),
                           ("layers", "batch", "heads", None, None),
                           init="zeros", dtype="float32"),
        }

    def cache_spec(self, batch: int, cache_len: int, window: int = 0) -> dict:
        S = min(cache_len, window) if window > 0 else cache_len
        spec = {
            "mamba": self._mamba_cache_unit(batch,
                                            self.n_groups * self.group),
            "shared_kv": kv_cache_param(self.wide_cfg, batch, S,
                                        stacked=self.n_groups),
        }
        if self.n_tail:
            spec["mamba_tail"] = self._mamba_cache_unit(batch, self.n_tail)
        return spec

    # -- compute --------------------------------------------------------------
    def _mamba_block(self, unit, x, mode, cache):
        h = norm_apply(unit["ln"], x, self.cfg)
        return x + ssm_apply(unit["ssm"], h, self.cfg, mode=mode, cache=cache)

    def _shared_apply(self, x, embeds, gi, *, window, positions, mode, cache):
        """One invocation of the shared wide block; its k/v go into
        ``cache`` in place."""
        wide = torch.cat([x, embeds], dim=-1)
        y, _ = block_apply(self.shared, wide, self.wide_cfg, window=window,
                           positions=positions, mode=mode, cache=cache)
        out = dense(self.shared_out, y)
        scale = self.layerscale["scale"][gi].to(out.dtype)
        return x + out * scale

    def _run(self, x, embeds, *, mode, positions, window, cache,
             remat=False):
        mamba_c = None if cache is None else cache["mamba"]
        call = layer_call(remat and cache is None)
        shared = (lambda xx, ee, gi: self._shared_apply(
            xx, ee, gi, window=window, positions=positions, mode=mode,
            cache=None))
        for gi in range(self.n_groups):
            for j in range(self.group):
                i = gi * self.group + j
                x = call(self._mamba_block, self.mamba[i], x, mode,
                         cache_index(mamba_c, i))
            if cache is None:
                x = call(shared, x, embeds, gi)
            else:
                x = self._shared_apply(
                    x, embeds, gi, window=window, positions=positions,
                    mode=mode, cache=cache_index(cache["shared_kv"], gi))
        tail_c = None if cache is None else cache.get("mamba_tail")
        for i, unit in enumerate(self.mamba_tail):
            x = call(self._mamba_block, unit, x, mode,
                     cache_index(tail_c, i))
        x = norm_apply(self.ln_f, x, self.cfg)
        return lm_logits(self.embed, x, self.cfg)

    def forward(self, batch: dict, mode: str = "train", *,
                window_override: int = 0, cache=None):
        """batch: {"tokens": [b, s]} -> (fp32 logits [b, s, V], aux), or
        with ``cache`` (logits, cache, aux): the prompt's conv rows, final
        SSD states and k/v written into ``cache`` in place.  Whatever
        ``mode`` is, the Mamba blocks run the chunked scan and the shared
        block its full attention, as in the JAX package; in train mode each
        Mamba block and each shared invocation is rematted; aux is
        zeros."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        embeds = embed_tokens(self.embed, tokens, self.cfg)
        window = self.cfg.sliding_window or window_override
        logits = self._run(embeds, embeds, mode="full", positions=positions,
                           window=window, cache=cache,
                           remat=mode == "train")
        aux = _zero_aux(logits.device)
        if cache is not None:
            return logits, cache, aux
        return logits, aux

    def decode_step(self, tokens, positions, cache, *, window: int = 0):
        """tokens [b, 1], positions [b] -> (logits [b, 1, V], cache), the
        new conv rows, states and k/v written into ``cache`` in place."""
        embeds = embed_tokens(self.embed, tokens, self.cfg)
        w = self.cfg.sliding_window or window
        logits = self._run(embeds, embeds, mode="decode",
                           positions=positions, window=w, cache=cache)
        return logits, cache

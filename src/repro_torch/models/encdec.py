"""Encoder-decoder transformer (the SeamlessM4T-v2 text/speech backbone) —
the port of ``repro.models.encdec``.

The modality frontend is a stub, as in the JAX package: ``batch["frames"]``
carries precomputed frame embeddings [b, n_frames, media_dim].  The
encoder is bidirectional, with RoPE; the decoder interleaves causal
self-attention, cross-attention to the encoder output and an MLP.  The
cross K/V are computed once a sequence, in the prefill, and cached in
bf16 whatever the model's dtype, as JAX rounds them; the prefill's own
cross-attention reads the unrounded k/v.

Every prefill attention runs K10 (the encoder's and the cross-attention
non-causal, the decoder's self-attention causal), every projection K3; a
decode step's attention is plain PyTorch.  The port holds one
``ParamTree`` a layer in two ``nn.ModuleList``s; the cache keeps JAX's
layout, ``{"self": [L, b, S, kvh, hd], "cross": [L, b, t, kvh, hd]}``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.models.common import (BaseModel, _zero_aux, block_spec,
                                       cache_index, cross_cache_param,
                                       kv_cache_param, layer_call, norm_apply,
                                       norm_spec)
from repro_torch.nn.attention import (attention_apply, attention_spec,
                                      cross_attention_cached)
from repro_torch.nn.embedding import embed_tokens, embedding_spec, lm_logits
from repro_torch.nn.linear import dense, linear_spec
from repro_torch.nn.mlp import mlp_apply, mlp_spec
from repro_torch.nn.param import ParamTree, stack_spec


class EncDecLM(BaseModel):
    """``embed``, ``frontend``, ``encoder`` (an ``nn.ModuleList`` of
    pre-norm blocks), ``ln_enc``, ``decoder`` (of ``{ln_self, self,
    ln_cross, cross, ln_mlp, mlp}`` units) and ``ln_f``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        assert cfg.num_encoder_layers > 0
        dt = cfg.param_dtype
        spec = self.param_spec()
        self.embed = ParamTree(spec["embed"], dt)
        self.frontend = ParamTree(spec["frontend"], dt)
        self.encoder = nn.ModuleList(ParamTree(block_spec(cfg), dt)
                                     for _ in range(cfg.num_encoder_layers))
        self.ln_enc = ParamTree(spec["ln_enc"], dt)
        self.decoder = nn.ModuleList(ParamTree(self._dec_unit(), dt)
                                     for _ in range(cfg.num_layers))
        self.ln_f = ParamTree(spec["ln_f"], dt)

    # -- params ---------------------------------------------------------------
    def _dec_unit(self) -> dict:
        cfg = self.cfg
        return {
            "ln_self": norm_spec(cfg),
            "self": attention_spec(cfg),
            "ln_cross": norm_spec(cfg),
            "cross": attention_spec(cfg, cross=True),
            "ln_mlp": norm_spec(cfg),
            "mlp": mlp_spec(cfg),
        }

    def param_spec(self) -> dict:
        cfg = self.cfg
        return {
            "embed": embedding_spec(cfg),
            "frontend": linear_spec(cfg.cross_attn.media_dim, cfg.d_model,
                                    "media", "embed", bias=True),
            "encoder": stack_spec(block_spec(cfg), cfg.num_encoder_layers),
            "ln_enc": norm_spec(cfg),
            "decoder": stack_spec(self._dec_unit(), cfg.num_layers),
            "ln_f": norm_spec(cfg),
        }

    def load_tree(self, tree: dict) -> "EncDecLM":
        self.embed.load(tree["embed"])
        self.frontend.load(tree["frontend"])
        for i, unit in enumerate(self.encoder):
            unit.load(tree["encoder"], i)
        self.ln_enc.load(tree["ln_enc"])
        for i, unit in enumerate(self.decoder):
            unit.load(tree["decoder"], i)
        self.ln_f.load(tree["ln_f"])
        return self

    # -- caches ----------------------------------------------------------------
    def cache_spec(self, batch: int, cache_len: int, window: int = 0) -> dict:
        S = min(cache_len, window) if window > 0 else cache_len
        L = self.cfg.num_layers
        return {"self": kv_cache_param(self.cfg, batch, S, stacked=L),
                "cross": cross_cache_param(self.cfg, batch, L)}

    # -- encoder -----------------------------------------------------------------
    def _enc_layer(self, unit, x, positions):
        """One bidirectional encoder block: RoPE on, no causal mask, no
        post-block norms (the JAX package's ``body_bi``)."""
        cfg = self.cfg
        h = norm_apply(unit["ln_attn"], x, cfg)
        x = x + attention_apply(unit["attn"], h, cfg, causal=False,
                                positions=positions, mode="full")
        h = norm_apply(unit["ln_mlp"], x, cfg)
        return x + mlp_apply(unit["mlp"], h, cfg)

    def encode(self, frames, remat=False):
        """frames [b, t, media_dim] -> the encoder's output [b, t, d]; with
        ``remat`` each layer is rematted while grad is enabled."""
        x = dense(self.frontend, frames)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        call = layer_call(remat)
        for unit in self.encoder:
            x = call(self._enc_layer, unit, x, positions)
        return norm_apply(self.ln_enc, x, self.cfg)

    # -- decoder -----------------------------------------------------------------
    def _dec_layer(self, unit, x, *, enc_out, positions, window, mode, cache):
        """One decoder layer.  ``mode="full"``: cross-attention to
        ``enc_out``, its k/v into ``cache["cross"]`` (bf16) when there is a
        cache; ``"decode"``: cross-attention against ``cache["cross"]``."""
        cfg = self.cfg
        h = norm_apply(unit["ln_self"], x, cfg)
        x = x + attention_apply(unit["self"], h, cfg, window=window,
                                positions=positions, mode=mode,
                                cache=None if cache is None
                                else cache["self"])
        h = norm_apply(unit["ln_cross"], x, cfg)
        if mode == "decode":
            c = cache["cross"]
            a = cross_attention_cached(unit["cross"], h, c["k"], c["v"], cfg)
        else:
            a = attention_apply(unit["cross"], h, cfg, context=enc_out,
                                mode="full", cache=None if cache is None
                                else cache["cross"])
        x = x + a
        h = norm_apply(unit["ln_mlp"], x, cfg)
        return x + mlp_apply(unit["mlp"], h, cfg)

    def _decode_stack(self, x, *, enc_out, positions, window, mode, cache,
                      remat=False):
        call = layer_call(remat and cache is None)
        for i, unit in enumerate(self.decoder):
            x = call(lambda u, xx, c: self._dec_layer(
                u, xx, enc_out=enc_out, positions=positions, window=window,
                mode=mode, cache=c), unit, x, cache_index(cache, i))
        x = norm_apply(self.ln_f, x, self.cfg)
        return lm_logits(self.embed, x, self.cfg)

    # -- public API -----------------------------------------------------------------
    def forward(self, batch: dict, mode: str = "train", *,
                window_override: int = 0, cache=None):
        """batch: {"tokens": [b, s], "frames": [b, t, media_dim]} -> (fp32
        logits [b, s, V], aux), or with ``cache`` (logits, cache, aux): the
        prompt's self k/v and every layer's cross k/v (bf16) written into
        ``cache`` in place.  Every layer runs in full mode, as in the JAX
        package; aux is zeros."""
        tokens = batch["tokens"]
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device)[None, :]
        remat = mode == "train" and cache is None
        enc_out = self.encode(batch["frames"], remat)
        x = embed_tokens(self.embed, tokens, self.cfg)
        window = self.cfg.sliding_window or window_override
        logits = self._decode_stack(x, enc_out=enc_out, positions=positions,
                                    window=window, mode="full", cache=cache,
                                    remat=remat)
        aux = _zero_aux(logits.device)
        if cache is not None:
            return logits, cache, aux
        return logits, aux

    def decode_step(self, tokens, positions, cache, *, window: int = 0):
        """tokens [b, 1], positions [b] -> (logits [b, 1, V], cache), the
        new self k/v written into ``cache`` in place; the cross caches are
        read only."""
        x = embed_tokens(self.embed, tokens, self.cfg)
        w = self.cfg.sliding_window or window
        logits = self._decode_stack(x, enc_out=None, positions=positions,
                                    window=w, mode="decode", cache=cache)
        return logits, cache

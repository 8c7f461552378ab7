"""RWKV6 (Finch) language model, attention-free with an O(1) state per
request: the port of ``repro.models.rwkv6``.

The JAX package stacks the layers and scans them; the port holds one
``ParamTree`` a layer in an ``nn.ModuleList`` and runs them in a Python
loop.  The cache stays stacked (``[layers, batch, ...]`` fp32 leaves:
each mix's last token and each layer's WKV state) and the layers write
into views of it in place.  A prompt runs the chunked WKV (K11 on the
card) in every layer; a decode step the per-timestep recurrence.
"""
from __future__ import annotations

from torch import nn

from repro_torch.core.config import ModelConfig
from repro_torch.models.common import (BaseModel, cache_index, layer_call,
                                       norm_apply, norm_spec)
from repro_torch.nn.embedding import embed_tokens, embedding_spec, lm_logits
from repro_torch.nn.param import Param, ParamTree, stack_spec
from repro_torch.nn.rwkv import (rwkv_channel_apply, rwkv_channel_spec,
                                 rwkv_dims, rwkv_time_apply, rwkv_time_spec)


class RWKV6LM(BaseModel):
    """``embed``, ``ln0``, ``layers`` (an ``nn.ModuleList`` of one unit a
    layer: ``ln1``, ``time``, ``ln2``, ``chan``) and ``ln_f``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__(cfg)
        dt = cfg.param_dtype
        spec = self.param_spec()
        self.embed = ParamTree(spec["embed"], dt)
        self.ln0 = ParamTree(spec["ln0"], dt)
        self.layers = nn.ModuleList(ParamTree(self._unit_spec(), dt)
                                    for _ in range(cfg.num_layers))
        self.ln_f = ParamTree(spec["ln_f"], dt)

    # -- params ---------------------------------------------------------------
    def _unit_spec(self) -> dict:
        cfg = self.cfg
        return {"ln1": norm_spec(cfg), "time": rwkv_time_spec(cfg),
                "ln2": norm_spec(cfg), "chan": rwkv_channel_spec(cfg)}

    def param_spec(self) -> dict:
        return {
            "embed": embedding_spec(self.cfg),
            "ln0": norm_spec(self.cfg),
            "layers": stack_spec(self._unit_spec(), self.cfg.num_layers),
            "ln_f": norm_spec(self.cfg),
        }

    def load_tree(self, tree: dict) -> "RWKV6LM":
        self.embed.load(tree["embed"])
        self.ln0.load(tree["ln0"])
        for i, unit in enumerate(self.layers):
            unit.load(tree["layers"], i)
        self.ln_f.load(tree["ln_f"])
        return self

    # -- compute --------------------------------------------------------------
    def _layer(self, unit, x, mode, c_i):
        cfg = self.cfg
        h = norm_apply(unit["ln1"], x, cfg)
        x = x + rwkv_time_apply(unit["time"], h, cfg, mode=mode,
                                cache=None if c_i is None else c_i["time"])
        h = norm_apply(unit["ln2"], x, cfg)
        return x + rwkv_channel_apply(
            unit["chan"], h, cfg, cache=None if c_i is None else c_i["chan"])

    def _run(self, tokens, mode, cache, remat=False):
        cfg = self.cfg
        x = embed_tokens(self.embed, tokens, cfg)
        x = norm_apply(self.ln0, x, cfg)
        call = layer_call(remat and cache is None)
        for i, unit in enumerate(self.layers):
            x = call(self._layer, unit, x, mode, cache_index(cache, i))
        x = norm_apply(self.ln_f, x, cfg)
        return lm_logits(self.embed, x, cfg)

    def forward(self, batch: dict, mode: str = "train", *,
                window_override: int = 0, cache=None):
        """batch: {"tokens": [b, s]} -> (fp32 logits [b, s, V], aux), or
        with ``cache`` (logits, cache, aux): the prompt's last tokens and
        final states written into ``cache`` in place.  The body always runs
        in full (chunked) mode, as in the JAX package, each layer rematted
        in train mode; ``window_override`` is accepted and ignored (no
        attention)."""
        logits = self._run(batch["tokens"], "full", cache,
                           remat=mode == "train")
        if cache is not None:
            return logits, cache, {}
        return logits, {}

    def cache_spec(self, batch: int, cache_len: int, window: int = 0) -> dict:
        d, h = rwkv_dims(self.cfg)
        e = self.cfg.rwkv.head_dim
        n = self.cfg.num_layers

        def leaf(*shape):
            return Param((n, batch) + shape,
                         ("layers", "batch") + (None,) * len(shape),
                         init="zeros", dtype="float32")

        return {"time": {"last": leaf(d), "state": leaf(h, e, e)},
                "chan": {"last": leaf(d)}}

    def decode_step(self, tokens, positions, cache, *, window: int = 0):
        """tokens [b, 1] -> (logits [b, 1, V], cache), the new last tokens
        and states written into ``cache`` in place; ``positions`` and
        ``window`` are accepted and ignored (the state carries the past)."""
        return self._run(tokens, "decode", cache), cache

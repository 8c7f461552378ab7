"""Token embedding and LM head (optionally tied): the port of
``repro.nn.embedding``.  The table is padded to ``cfg.padded_vocab`` and
the padding is masked out of the logits."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.nn.attention import NEG_INF, softcap
from repro_torch.nn.param import Param


def embedding_spec(cfg: ModelConfig) -> dict:
    spec = {
        "tok": Param((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                     init="embed", scale=0.02)
    }
    if not cfg.tie_embeddings:
        spec["head"] = Param((cfg.d_model, cfg.padded_vocab),
                             ("embed", "vocab"), init="fan_in")
    return spec


def embed_tokens(params, tokens, cfg: ModelConfig, scale_by_dim: bool = False):
    """The table's rows at ``tokens``, through ``F.embedding``: the values
    of the gather ``params["tok"][tokens]``, with a backward that sums a
    row's gradients in a fixed order on the card (the gather's
    accumulating ``index_put_`` does not)."""
    x = F.embedding(tokens, params["tok"])
    if scale_by_dim:  # gemma convention, the scale in the activation dtype
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def lm_logits(params, x, cfg: ModelConfig):
    """fp32 logits.  The head is a plain product (the JAX package leaves
    it to XLA, outside any Pallas kernel)."""
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["tok"].t())
    else:
        logits = torch.matmul(x, params["head"])
    logits = softcap(logits.float(), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return logits

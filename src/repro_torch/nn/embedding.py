"""Token embedding and LM head (optionally tied): the port of
``repro.nn.embedding``.  The table is padded to ``cfg.padded_vocab`` and
the padding is masked out of the logits.

On a mesh whose rules cut "vocab" (``sharding.ctx``), a rank holds a
slice of the table's rows and of the head's columns.  The lookup gives
its own rows and -0.0 for ids outside them, and ``sum_over`` adds the
ranks' rows: exactly one rank holds each id, and x + (-0.0) is x for
every x, so the sum is the whole table's gather bit for bit.  The logits
are the local vocab slice, softcapped and masked by global index, then
gathered over the ranks, but in training, whose cross entropy takes the
slices (``train.step.cross_entropy``); the head's input enters through
``nn.linear.column_input``.  Both adjoints of a tied ``tok``, the
lookup's and the head's, add into the rank's shard."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.nn.attention import NEG_INF, softcap
from repro_torch.nn.linear import column_input
from repro_torch.nn.param import Param
from repro_torch.sharding.collectives import gather_over, sum_over
from repro_torch.sharding.ctx import shard_act, shard_of


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
    i, n, axes = shard_of("vocab")
    if n > 1:
        rows = params["tok"].shape[0]
        local = tokens - i * rows
        inside = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), params["tok"])
        x = sum_over(axes, x.masked_fill(~inside[..., None], -0.0))
    else:
        x = F.embedding(tokens, params["tok"])
    if scale_by_dim:  # gemma convention, the scale in the activation dtype
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    if x.dim() == 3:
        x = shard_act(x, ("batch", "seq_res", "embed_act"))
    return x


def lm_logits(params, x, cfg: ModelConfig, gather: bool = True):
    """fp32 logits.  The head is a plain product (the JAX package leaves
    it to XLA, outside any Pallas kernel).  ``gather=False`` (training:
    the vocab-parallel cross entropy, ``train.step``) returns the rank's
    vocab slice."""
    x = column_input(x, "vocab")
    if cfg.tie_embeddings:
        logits = torch.matmul(x, params["tok"].t())
    else:
        logits = torch.matmul(x, params["head"])
    if logits.dim() == 3:
        logits = shard_act(logits, ("batch", "seq", "vocab"))
    logits = softcap(logits.float(), cfg.logit_softcap)
    i, n, axes = shard_of("vocab")
    cols = logits.shape[-1]
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(i * cols, (i + 1) * cols,
                           device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, NEG_INF)
    return gather_over(axes, logits, dim=-1) if gather else logits

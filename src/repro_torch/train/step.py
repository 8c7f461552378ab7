"""Train-step builder: loss, gradients, the optimizer update — the port of
``repro.train.step``.

The model holds its parameters as views of a parameter tree in the JAX
layout (``nn.param.ParamTree``).  ``make_train_step``'s step takes that
tree: it makes the model's leaves trainable and points each one's
``.grad`` at the matching view of a zeroed gradient buffer of the tree's
stacked shape, so one ``backward`` leaves the gradients as a tree with
the JAX package's keys and shapes, then ``adamw_update`` writes the new
parameters in place.  The forward runs in train mode (each layer unit
rematted); K3's gradients run on K3, K10's and K11's backwards are plain
PyTorch (``kernels/*/ops.py``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.models.common import AUX_LOSSES
from repro_torch.nn.param import DTYPES, tree_leaves, tree_map
from repro_torch.train.optimizer import adamw_update


def cross_entropy(logits, labels, vocab_size: int) -> torch.Tensor:
    """Mean CE over all tokens.  logits fp32 [b, s, V_padded]; labels [b, s].

    The gold logit is a gather; the JAX package takes a masked sum (a
    gather would all-gather its vocab-sharded logits), which on one device
    adds only zeros to it, so the two agree exactly."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - gold).mean()


def make_loss_fn(model, *, window_override: int = 0) -> Callable:
    """``loss_fn(batch) -> (loss, metrics)``: the model's train-mode
    forward, CE, and the MoE aux losses added (zeros for other families,
    as the JAX package's layer scan emits them)."""
    cfg = model.cfg

    def loss_fn(batch):
        logits, aux = model(batch, mode="train",
                            window_override=window_override)
        ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
        loss = ce
        metrics = {"ce": ce}
        for k in AUX_LOSSES:
            a = aux.get(k, torch.zeros((), device=ce.device))
            loss = loss + a
            metrics[k] = a
        metrics["loss"] = loss
        return loss, metrics

    return loss_fn


def _grad_views(model, leaves, grads):
    """(parameter, its gradient view) for every parameter of ``model``: the
    view of ``grads[i]`` at the place the parameter takes in ``leaves[i]``
    (the tensor itself, or an entry of a stacked leaf), or None where a
    parameter lies in no leaf."""
    out = []
    for p in model.parameters():
        view = None
        for t, g in zip(leaves, grads):
            start = t.data_ptr()
            off = p.data_ptr() - start
            if (t.device == p.device and t.dtype == p.dtype
                    and 0 <= off < t.numel() * t.element_size()):
                view = g.as_strided(p.shape, p.stride(),
                                    g.storage_offset()
                                    + off // t.element_size())
                break
        out.append((p, view))
    return out


def bind_grads(model, params, buffers: dict) -> dict:
    """Make the model's parameters, views of ``params`` (loaded into it
    first if they are not), trainable, with each ``.grad`` the matching
    view of a zeroed buffer of its tree leaf's shape and dtype; returns
    the buffers as a tree shaped like ``params``.  ``buffers`` keeps them,
    and the views, from step to step."""
    leaves = tree_leaves(params)
    key = (tuple(id(t) for t in leaves),
           tuple(id(p) for p in model.parameters()))
    if buffers.get("key") != key:
        buffers.clear()
        grads = [torch.zeros_like(t) for t in leaves]
        views = _grad_views(model, leaves, grads)
        if any(v is None for _, v in views):
            model.load_tree(params)
            views = _grad_views(model, leaves, grads)
        if any(v is None for _, v in views):
            raise ValueError("the model's parameters are not views of the "
                             "tree the train step was given")
        buffers.update(key=key, grads=grads, views=views)
    else:
        for g in buffers["grads"]:
            g.zero_()
    for p, view in buffers["views"]:
        p.requires_grad_(True)
        p.grad = view
    it = iter(buffers["grads"])
    return tree_map(lambda _: next(it), params)


def make_train_step(model, tcfg: TrainConfig, *, window_override: int = 0,
                    microbatches: int = 1,
                    grad_acc_dtype: str = "float32") -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the trees updated in place.  With ``microbatches > 1`` the
    batch is split as the JAX package splits it (``reshape(b // k, k,
    ...)``, microbatch ``i`` its column ``i``), the gradients are
    accumulated in ``grad_acc_dtype`` and the gradients and metrics
    divided by k."""
    loss_fn = make_loss_fn(model, window_override=window_override)
    buffers: dict = {}

    def grads_of(params, batch):
        grads = bind_grads(model, params, buffers)
        loss, metrics = loss_fn(batch)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            metrics, grads = grads_of(params, batch)
        else:
            k = microbatches
            acc_dt = DTYPES[grad_acc_dtype]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            metrics = None
            for i in range(k):
                mb = {}
                for name, x in batch.items():
                    assert x.shape[0] % k == 0, (x.shape[0], k)
                    mb[name] = x.reshape(x.shape[0] // k, k,
                                         *x.shape[1:])[:, i].contiguous()
                m_i, g_i = grads_of(params, mb)
                for a, g in zip(tree_leaves(grads), tree_leaves(g_i)):
                    a.add_(g.to(acc_dt))
                metrics = m_i if metrics is None else {
                    n: metrics[n] + m_i[n] for n in metrics}
            for a in tree_leaves(grads):
                a.div_(k)
            metrics = {n: v / k for n, v in metrics.items()}
        train_step.grads = grads
        params, opt_state, opt_metrics = adamw_update(grads, opt_state,
                                                      params, tcfg)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    #: the gradient tree of the last step (the buffers the next one zeroes)
    train_step.grads = None
    return train_step


def default_microbatches(tokens: int, dp_size: int,
                         max_local_tokens: int = 8_192) -> int:
    """Pick the accumulation factor so each device sees <= max_local_tokens
    activations at a time; must divide the per-shard batch."""
    return max(1, -(-tokens // (dp_size * max_local_tokens)))

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

Under a mesh's ``activation_sharding`` (``launch.dryrun._build_step``)
the same step runs on one rank's shards and computes what JAX's
GSPMD-lowered step computes: the rank's microbatch ``i`` is its shard of
JAX's microbatch ``i`` (the strided split of the local batch), the loss
it differentiates is its local mean over the data ranks' count, so that
the data-replicated leaves' gradients summed over "data" in rank order
(``optimizer.reduce_grads``, onto their ZeRO-1 shards) are JAX's mean
over the global batch, and an FSDP'd leaf's comes summed from its
gather's adjoint; the cross entropy is vocab-parallel, and the metrics
are averaged over the data ranks.  The MoE aux losses are the whole
batch's on every data rank (``nn/moe.py`` sums their statistics over
the data ranks, and the adjoint of that sum adds the ranks' cotangents),
so the rank's loss takes them whole beside its local CE, as the
unsharded step does.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.config import TrainConfig
from repro_torch.models.common import AUX_LOSSES
from repro_torch.nn.param import DTYPES, tree_leaves, tree_map
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.collectives import max_over, sum_over
from repro_torch.train.optimizer import adamw_update, reduce_grads, shard_plan


def cross_entropy(logits, labels, vocab_size: int) -> torch.Tensor:
    """Mean CE over all tokens.  logits fp32 [b, s, V_padded]; labels [b, s].

    The gold logit is a gather; the JAX package takes a masked sum (a
    gather would all-gather its vocab-sharded logits), which on one device
    adds only zeros to it, so the two agree exactly.

    Where the active sharding cuts "vocab", ``logits`` is the rank's vocab
    slice and the CE is vocab-parallel, with no gather of the logits: the
    max through ``max_over``, the sum of exps and the gold logit (the
    rank's own where the label lies in its slice, else 0) through
    ``sum_over``, each added in rank order."""
    i, n, axes = shard_ctx.shard_of("vocab")
    if n == 1:
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return (lse - gold).mean()
    cols = logits.shape[-1]
    m = max_over(axes, logits.amax(dim=-1))
    lse = m + torch.log(sum_over(axes, torch.exp(
        logits - m[..., None]).sum(dim=-1)))
    local = labels.long() - i * cols
    inside = (local >= 0) & (local < cols)
    gold = logits.gather(-1, local.clamp(0, cols - 1)[..., None])[..., 0]
    gold = sum_over(axes, torch.where(inside, gold, 0.0))
    return (lse - gold).mean()


def make_loss_fn(model, *, window_override: int = 0,
                 dp_size: Optional[int] = None) -> Callable:
    """``loss_fn(batch) -> (loss, metrics)``: the model's train-mode
    forward, CE, and the MoE aux losses added (zeros for other families,
    as the JAX package's layer scan emits them).  ``dp_size``: the JAX
    package's argument, the MoE blocks' token groups (a transformer's
    default: the active mesh's data size, 1 without one).  On a mesh the
    aux losses are the whole batch's on every rank (``nn/moe.py``)."""
    cfg = model.cfg
    kw = {} if dp_size is None else {"dp_size": dp_size}

    def loss_fn(batch):
        logits, aux = model(batch, mode="train",
                            window_override=window_override, **kw)
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
    (the tensor itself, or an entry of a stacked leaf: the same storage,
    from the leaf's offset on; on meta tensors too, whose ``data_ptr`` is
    their offset alone), or None where a parameter lies in no leaf."""
    out = []
    for p in model.parameters():
        view = None
        store = p.untyped_storage()._cdata
        for t, g in zip(leaves, grads):
            off = p.storage_offset() - t.storage_offset()
            if (t.device == p.device and t.dtype == p.dtype
                    and t.untyped_storage()._cdata == store
                    and 0 <= off < t.numel()):
                view = g.as_strided(p.shape, p.stride(),
                                    g.storage_offset() + off)
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
                    microbatches: int = 1, grad_acc_dtype: str = "float32",
                    dp_size: Optional[int] = None) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, the trees updated in place.  With ``microbatches > 1`` the
    batch is split as the JAX package splits it (``reshape(b // k, k,
    ...)``, microbatch ``i`` its column ``i``), the gradients are
    accumulated in ``grad_acc_dtype`` and the gradients and metrics
    divided by k.

    Under a mesh's ``activation_sharding`` ``params`` and ``opt_state``
    are a rank's shards (``models.transformer.shard_params`` and
    ``shard_opt_state``, or ``optimizer.adamw_init(params,
    train_step.plan())``) and ``batch`` its rows (see the module's
    docstring).  The step is two calls, :func:`accumulate`'s and
    :func:`finish`'s, exposed as ``train_step.accumulate`` (the
    microbatches ``indices`` only: the dry run traces one) and
    ``train_step.finish``.  ``dp_size`` as in :func:`make_loss_fn`."""
    loss_fn = make_loss_fn(model, window_override=window_override,
                           dp_size=dp_size)
    buffers: dict = {}
    plans: dict = {}

    def plan():
        """The rank's ``optimizer.shard_plan`` under the active mesh, or
        None without one."""
        c = shard_ctx.current()
        if c is None:
            return None
        key = (c.mesh_cfg, c.rules)
        if key not in plans:
            plans[key] = shard_plan(model.param_spec(), c.mesh_cfg, c.rules)
        return plans[key]

    def grads_of(params, batch):
        grads = bind_grads(model, params, buffers)
        loss, metrics = loss_fn(batch)
        dp = shard_ctx.shard_of("batch")[1]
        # the local mean over the data ranks: their gradients' sum is the
        # global batch's mean's
        (loss if dp == 1 else loss / dp).backward()
        return {k: v.detach() for k, v in metrics.items()}, grads

    def accumulate(params, batch, indices: Optional[Sequence[int]] = None):
        """(gradients, metrics) of microbatches ``indices`` (all of them
        by default): one microbatch's own, or their sums in
        ``grad_acc_dtype``, not yet divided."""
        k = microbatches
        if k == 1:
            metrics, grads = grads_of(params, batch)
            return grads, metrics
        acc_dt = DTYPES[grad_acc_dtype]
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                               device=p.device), params)
        metrics = None
        for i in range(k) if indices is None else indices:
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
        return grads, metrics

    def finish(params, opt_state, grads, metrics):
        """The data ranks' sums of ``accumulate``'s gradients and metrics,
        divided by the microbatches, and the update."""
        k, shards = microbatches, plan()
        if shards is not None:
            with torch.no_grad():
                grads = reduce_grads(grads, shards)
                _, dp, axes = shard_ctx.shard_of("batch")
                if dp > 1:
                    metrics = {n: sum_over(axes, v) / dp
                               for n, v in metrics.items()}
        if k > 1:
            for a in tree_leaves(grads):
                a.div_(k)
            metrics = {n: v / k for n, v in metrics.items()}
        train_step.grads = grads
        params, opt_state, opt_metrics = adamw_update(
            grads, opt_state, params, tcfg, plan=shards)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    def train_step(params, opt_state, batch):
        grads, metrics = accumulate(params, batch)
        return finish(params, opt_state, grads, metrics)

    #: the gradient tree of the last step (the buffers the next one zeroes)
    train_step.grads = None
    train_step.accumulate = accumulate
    train_step.finish = finish
    train_step.plan = plan
    train_step.microbatches = microbatches
    return train_step


def default_microbatches(tokens: int, dp_size: int,
                         max_local_tokens: int = 8_192) -> int:
    """Pick the accumulation factor so each device sees <= max_local_tokens
    activations at a time; must divide the per-shard batch."""
    return max(1, -(-tokens // (dp_size * max_local_tokens)))

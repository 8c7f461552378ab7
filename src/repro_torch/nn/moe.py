"""Mixture-of-Experts with capacity-bounded sort-based dispatch: the port
of ``repro.nn.moe``.

Tokens are viewed as ``[D, T_l, d]``, ``D`` groups of ``T_l`` tokens
(``_group_count``: the largest divisor of the token count that is at most
``dp_size``).  Routing, the sort and the capacity bound act within a
group, so ``dp_size`` changes which (token, expert) pairs a capacity bound
drops, as in the JAX package.  Within a group:

* the router is an fp32 product (TF32 is off for the port's plain calls,
  PyTorch's default), then an fp32 softmax, ``torch.topk`` and the
  renormalisation of the k chosen probabilities, clamped at 1e-9;
* the capacity of an expert is ``capacity_factor`` in ``train``,
  ``eval_capacity_factor`` in ``prefill`` and ``T_l * k`` in ``decode``;
* dispatch sorts the ``T_l * k`` pairs by expert id, stably, so the pairs
  of one expert keep the order of their flat index ``t * k + j``; a pair
  past its expert's capacity is dropped.  Kept pairs map to rows of an
  ``[E * cap]`` buffer plus the JAX package's sentinel row ``E * cap``,
  which gathers zeros and is never read back;
* the dispatch (token rows into the buffer) and the combine (buffer rows
  back to the pairs) are gathers whose backwards gather as well
  (``_GatherRows``): a token's gradient sums its k buffer rows' in the
  order of its picks, with no atomic add, so a train step gives the same
  bits on the card from run to run, as ROADMAP.md's determinism contract
  asks (``index_select``'s backward is an atomic ``index_add_`` there);
* the experts run as three batched ``torch.matmul`` over the expert axis,
  bf16 operands and a bf16 result for a bf16 model, as the JAX package's
  ``jnp.einsum`` (outside any Pallas kernel, so no kernel of the port);
* the combine scales each pair's expert output by its probability cast
  to x's dtype and sums the k products in fp32 with one cast to x's
  dtype, as ``jnp.sum`` does.

On a mesh (``sharding.ctx``) the block runs what GSPMD makes of the JAX
package's ``shard_act`` pins:

* **groups**: where the rules cut "batch" over the data ranks, a rank's
  rows are whole groups of the JAX call's (``ctx.moe_groups``) and it
  routes them alone; where "batch" is whole, every rank runs all the
  groups.  The routing is computed whole on every model rank: the same
  fp32 bits on each;
* **experts cut** (``shard_mode="expert"``, "experts" over "model"): a
  rank gathers only its own experts' buffer rows, ``[E / m, D * cap,
  d]``, runs its experts, and each (token, pick) pair's expert row comes
  from the one rank that holds it, zeros from the others: ``sum_over``
  the picked rows ``[D, T_l * k, d]`` in rank order gives the whole
  block's rows bit for bit (x + 0 = x), and the combine runs as on one
  card;
* **each expert's ff cut** (``shard_mode="tensor"``, "expert_ff" over
  "model"): gate and up are column-parallel, down row-parallel: K3
  stores each expert's fp32 partial of the bf16 operands, ``sum_over``
  adds the ranks' partials in rank order, and one cast to x's dtype
  follows, the rounding point of ``nn.linear.dense(k_axis=)``;
* the experts' input enters through ``copy_to``, so each rank's part of
  its cotangent is summed over "model"; the router's input does not (the
  router runs whole on every rank, and the picked rows' exchange passes
  the replicated cotangent back), so the router's gradient is the same
  bits on every model rank;
* the aux losses are JAX's over all groups: the expert counts, the mean
  router probabilities and the z-loss summed over the data ranks in rank
  order before the load-balance product (a product of means, not a mean
  of per-group products).

Decode computes all E experts: at the worst-case capacity ``T_l * k`` no
pair drops, so a step's tokens never interact (a request's token does not
depend on which other slots are active), but each expert's rows are
mostly the zero rows of the sentinel, and every expert's weights are read
each step.  A product that reads only the experts holding rows is
ROADMAP.md's queue 2 work.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.common import ACC_DTYPE
from repro_torch.kernels.matmul_fused.ops import matmul_fused
from repro_torch.nn.linear import act_fn
from repro_torch.nn.param import Param
from repro_torch.sharding.collectives import copy_to, sum_over
from repro_torch.sharding.ctx import moe_groups, shard_of


def moe_spec(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    d, f, E = cfg.d_model, moe.d_ff_expert, moe.num_experts
    e_ax = "experts" if moe.shard_mode == "expert" else None
    f_ax = None if moe.shard_mode == "expert" else "expert_ff"
    return {
        "router": Param((d, E), ("embed", None), init="fan_in",
                        dtype="float32"),
        "we_gate": Param((E, d, f), (e_ax, "embed", f_ax), init="fan_in"),
        "we_up": Param((E, d, f), (e_ax, "embed", f_ax), init="fan_in"),
        "we_down": Param((E, f, d), (e_ax, f_ax, "embed"), init="fan_in"),
    }


def moe_redraw(tree: dict, generator: torch.Generator) -> None:
    """Redraw the expert matrices of every MoE layer of a transformer's
    parameter tree (JAX layout: ``layers/mlp/we_*`` stacked ``[layers, E,
    d_in, d_out]``) in place, on ``generator``'s device, at std
    1/sqrt(d_in), a layer at a time.

    The init's fan-in rule (the JAX package's, kept) takes a 4-D leaf's
    first axis as its fan-in, so the stacked experts are drawn at std
    1/sqrt(layers).  At 48 layers the gate's pre-activations stay within
    exp's range; at a model cut to a few layers they reach |x| of a
    hundred, and silu's ``1 / (1 + exp(-x))`` (JAX's form) has a NaN
    gradient there.  ``chip_smoke.py`` (phase 13) applies it to a cut model
    before both sides get the tree; ``init_tree`` itself keeps JAX's
    rule."""
    mlp = tree["layers"]["mlp"]
    for name in ("we_gate", "we_up", "we_down"):
        for t in mlp[name]:
            t.copy_(torch.randn(t.shape, generator=generator,
                                device=t.device, dtype=torch.float32)
                    / math.sqrt(t.shape[-2]))


def _group_count(tokens: int, dp_size: int) -> int:
    """Largest divisor of `tokens` that is <= dp_size (handles tiny decode
    batches where tokens < dp)."""
    d = min(tokens, dp_size)
    while tokens % d:
        d -= 1
    return d


class Routing(NamedTuple):
    """One call's routing, per group ``[D, ...]``."""

    logits: torch.Tensor  # [D, T_l, E] fp32
    probs: torch.Tensor  # [D, T_l, E] fp32
    p_k: torch.Tensor  # [D, T_l, k] renormalised probabilities
    e_k: torch.Tensor  # [D, T_l, k] chosen experts
    cap: int
    order: torch.Tensor  # [D, T_l*k] flat pair index of each sorted entry
    keep: torch.Tensor  # [D, T_l*k] sorted entry kept (within capacity)
    slot: torch.Tensor  # [D, T_l*k] buffer row of each sorted entry


def route(params, x, cfg: ModelConfig, *, dp_size: int = 1,
          mode: str = "train") -> Routing:
    """The router, top-k and the sort-based dispatch of :func:`moe_apply`
    for ``x`` [b, s, d]."""
    moe = cfg.moe
    E, k = moe.num_experts, moe.num_experts_per_token
    b, s, d = x.shape
    D = _group_count(b * s, dp_size)
    T_l = b * s // D
    logits = torch.matmul(x.reshape(D, T_l, d).float(),
                          params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    p_k, e_k = torch.topk(probs, k, dim=-1)
    p_k = p_k / torch.clamp_min(p_k.sum(dim=-1, keepdim=True), 1e-9)
    if mode == "decode":
        cap = T_l * k  # worst case: no pair is ever dropped at decode
    else:
        cf = (moe.capacity_factor if mode == "train"
              else moe.eval_capacity_factor)
        cap = min(max(1, math.ceil(T_l * k * cf / E)), T_l * k)

    sorted_e, order = torch.sort(e_k.reshape(D, T_l * k), dim=-1,
                                 stable=True)
    ids = torch.arange(E, device=x.device).expand(D, E).contiguous()
    starts = torch.searchsorted(sorted_e, ids)  # each expert's first entry
    pos_in_e = (torch.arange(T_l * k, device=x.device)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < cap
    slot = torch.where(keep, sorted_e * cap + pos_in_e, E * cap)
    return Routing(logits, probs, p_k, e_k, cap, order, keep, slot)


def _rows(table, index):
    """``table`` [D, R, d] rows ``index`` [D, n] of each group -> [D, n, d]
    (one ``index_select`` over the flattened groups)."""
    D, R, d = table.shape
    base = torch.arange(D, device=index.device)[:, None] * R
    flat = table.reshape(D * R, d).index_select(0, (index + base).reshape(-1))
    return flat.reshape(D, -1, d)


def _pad_row(table):
    """``table`` [D, R, d] with a zero row ``R`` appended to each group."""
    return torch.cat([table, table.new_zeros((table.shape[0], 1,
                                              table.shape[2]))], dim=1)


class _GatherRows(torch.autograd.Function):
    """``out = _rows(_pad_row(table), index)``: row ``index[g, i]`` of
    group ``g``, the zero row where the index is ``R``.  Its backward
    gathers too, with no ``index_add_``, scatter or atomic: ``readers``
    [D, R, k] lists, for each table row, the output rows that read it
    (``n``, the count of output rows, where fewer than k do), and row
    ``r``'s gradient is the sum of those output rows' gradients taken in
    order ``j = 0 .. k-1``, one fixed order on every device.  (The
    backward of ``index_select`` is an ``index_add_``, whose sum on the
    card is an atomic one in no fixed order.)"""

    @staticmethod
    def forward(ctx, table, index, readers):
        ctx.save_for_backward(readers)
        return _rows(_pad_row(table), index)

    @staticmethod
    def backward(ctx, dout):
        (readers,) = ctx.saved_tensors
        D, R, k = readers.shape
        parts = _rows(_pad_row(dout), readers.reshape(D, R * k)).reshape(
            D, R, k, -1)
        dtable = parts[:, :, 0]
        for j in range(1, k):
            dtable = dtable + parts[:, :, j]
        return dtable, None, None


def experts(params, buf, act: str, partial: bool = False):
    """buf [E, n, d] -> [E, n, d]: expert e's gated feed-forward on its n
    rows, as three batched products over the experts.  ``partial``: the
    weights hold a slice of each expert's ff axis, and the result is the
    fp32 partial of the down product, each expert's on K3's fp32 store of
    the operands as they are (bf16 for a bf16 model)."""
    g = torch.matmul(buf, params["we_gate"])
    u = torch.matmul(buf, params["we_up"])
    h = act_fn(act)(g) * u
    if not partial:
        return torch.matmul(h, params["we_down"])
    return torch.stack([matmul_fused(h[e], params["we_down"][e],
                                     out_dtype=ACC_DTYPE)
                        for e in range(h.shape[0])])


def dispatch_maps(r: Routing, k: int):
    """The dispatch's index maps of a routing, per group: each buffer row's
    source token (``T_l``, the zero row, where the row is empty) and its
    (token, k) pair in flat order (``T_l * k``, the zero row), [D, E *
    cap]; each pair's buffer row (``E * cap``, the sentinel, where it is
    dropped), [D, T_l * k]."""
    D, T_l, E = r.logits.shape
    rows = E * r.cap
    # every dropped entry writes the extra column E * cap, cut off after
    src_map = torch.full((D, rows + 1), T_l, dtype=torch.long,
                         device=r.slot.device)
    src_map.scatter_(1, r.slot, r.order // k)
    pair_of_row = torch.full((D, rows + 1), T_l * k, dtype=torch.long,
                             device=r.slot.device)
    pair_of_row.scatter_(1, r.slot, r.order)
    inv_slot = torch.empty_like(r.slot).scatter_(1, r.order, r.slot)
    return src_map[:, :rows], pair_of_row[:, :rows], inv_slot


def _own_slots(src_map, pair_of_row, inv_slot, first: int, rows: int):
    """The dispatch's maps cut to the buffer rows ``[first, first +
    rows)`` (a rank's experts): those rows' sources and pairs, and each
    pair's row among them (``rows``, the zero row, where another rank's
    expert or no expert holds it)."""
    loc = inv_slot - first
    loc = torch.where((loc >= 0) & (loc < rows), loc, rows)
    return (src_map[:, first:first + rows], pair_of_row[:, first:first + rows],
            loc)


def moe_apply(params, x, cfg: ModelConfig, *, dp_size: int = 1,
              mode: str = "train", aux: bool = True
              ) -> Tuple[torch.Tensor, dict]:
    """x [b, s, d] -> (out [b, s, d] in x's dtype, aux): ``mode`` is
    ``train``, ``prefill`` or ``decode`` (it sets the capacity);
    ``dp_size`` the JAX call's (on a mesh: the mesh's data size, however
    the rank's rows make up its groups); ``aux=False``: no aux losses
    (``{}``), and on a mesh none of their exchanges."""
    moe = cfg.moe
    E, k = moe.num_experts, moe.num_experts_per_token
    b, s, d = x.shape
    groups, data_axes = moe_groups(dp_size)
    r = route(params, x, cfg, dp_size=groups, mode=mode)
    D, T_l, _ = r.logits.shape
    cap = r.cap

    src_map, pair_of_row, inv_slot = dispatch_maps(r, k)
    e_rank, e_ways, e_axes = shard_of("experts")
    _, f_ways, f_axes = shard_of("expert_ff")
    E_l = E // e_ways
    if e_ways > 1:  # the rank's experts' rows alone
        src_map, pair_of_row, inv_slot = _own_slots(
            src_map, pair_of_row, inv_slot, e_rank * E_l * cap, E_l * cap)
    # the experts' input: each model rank's part of its cotangent summed
    xe = copy_to(e_axes or f_axes, x)
    # [E_l, D * cap, d]: the expert axis leads, so each product is one
    # batched matmul over the experts (a view when D == 1).  The dispatch
    # and the combine gather; each one's backward is the other's gather,
    # a token's k buffer rows summed in a fixed order
    buf = _GatherRows.apply(xe.reshape(D, T_l, d), src_map,
                            inv_slot.reshape(D, T_l, k))
    buf = buf.reshape(D, E_l, cap, d).transpose(0, 1).reshape(E_l, D * cap, d)

    if f_ways > 1:  # row-parallel down: the ranks' fp32 partials, one cast
        y = sum_over(f_axes, experts(params, buf, cfg.act, partial=True)
                     ).to(x.dtype)
    else:
        y = experts(params, buf, cfg.act)
    y = y.reshape(E_l, D, cap, d).transpose(0, 1).reshape(D, E_l * cap, d)
    picked = _GatherRows.apply(y, inv_slot, pair_of_row[..., None])
    # each pair's row from the rank that holds its expert, zeros elsewhere
    picked = sum_over(e_axes, picked).reshape(D, T_l, k, d)
    out = (picked * r.p_k.to(picked.dtype)[..., None]).float().sum(dim=2)
    out = out.to(x.dtype).reshape(b, s, d)
    if not aux:
        return out, {}

    # Switch-style load balance: E * sum_e f_e * P_e, f_e counting every
    # top-k pick (dropped or not); the counts are exact in fp32, and unlike
    # torch.bincount the sum never reads the device's data on the host.
    # Over the data ranks: the counts, the mean probabilities and the
    # z-loss summed in rank order, each a mean over every group
    picks = r.e_k.reshape(-1)
    counts = torch.zeros(E, device=x.device).index_add_(
        0, picks, torch.ones(picks.shape, device=x.device))
    P_e = r.probs.mean(dim=(0, 1))
    z = torch.logsumexp(r.logits, dim=-1).square().mean()
    n = 1
    if data_axes:
        n = dp_size // groups
        counts = sum_over(data_axes, counts)
        P_e = sum_over(data_axes, P_e) / n
        z = sum_over(data_axes, z) / n
    f_e = counts / (n * D * T_l)
    return out, {
        "load_balance_loss":
            moe.load_balance_loss * (E * (f_e / k * P_e).sum()),
        "router_z_loss": moe.router_z_loss * z,
        "expert_fraction": f_e / k,
    }


# ---------------------------------------------------------------------------
# Dense reference (tiny shapes only — oracle for tests)
# ---------------------------------------------------------------------------


def moe_reference(params, x, cfg: ModelConfig):
    """O(T·E·d·f) dense mixing, no capacity: every token through every
    expert, weighted by its renormalised top-k gate."""
    moe = cfg.moe
    k = moe.num_experts_per_token
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    logits = xf.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    p_k, e_k = torch.topk(probs, k, dim=-1)
    p_k = p_k / torch.clamp_min(p_k.sum(dim=-1, keepdim=True), 1e-9)
    gate = torch.zeros_like(probs).scatter_(1, e_k, p_k)
    act = act_fn(cfg.act)
    g = torch.einsum("td,edf->tef", xf, params["we_gate"])
    u = torch.einsum("td,edf->tef", xf, params["we_up"])
    y = torch.einsum("tef,efd->ted", act(g) * u, params["we_down"])
    out = torch.einsum("ted,te->td", y, gate.to(y.dtype))
    return out.reshape(b, s, d)

"""Wrapper of the WKV6 chunked kernel (K11, ``csrc/wkv6.cu``): the port of
``repro.kernels.wkv6`` with the contract of ``repro.nn.rwkv._wkv6_chunked``
(an initial state in, the final state out), which is where the model
calls it.

A CPU tensor goes to the plain version; a CUDA tensor launches the kernel
(r, k and v both fp32 or both bf16, logw, u and the state fp32, head
width 64, chunks of at most 64 steps, every tensor 16-byte aligned) or
raises.  One call is three launches on the current stream (the chunks'
own states, the walk of the state over the chunks, the chunks' outputs;
``wkv6_plan`` has their geometry) over one fp32 scratch tensor allocated
here.

Under autograd (grad enabled and an input requiring grad) the call goes
through :class:`Wkv6Fn`, whose backward is plain PyTorch by design
(:func:`wkv6_bwd`): it re-runs the chunked plain version
``wkv6_chunked_ref`` under autograd and takes its gradients for r, k, v,
logw, u and the initial state, as the JAX package's backward is autodiff
through ``_wkv6_chunked``'s scan.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    check_cuda,
    check_cuda_f32,
    sm_count,
    stream_handle,
)
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref

HEAD_DIM = 64       # WK_E in csrc/wkv6.cu
MAX_CHUNK = 64      # WK_LMAX
SUB = 16            # WK_SUB: rows of a sub-chunk
ROW_STRIDE = 68     # WK_P: a row of shared memory, in floats
THREADS = 256       # WK_THREADS: a chunk block
WALK_THREADS = 256  # WK_WALK_THREADS: a walk block
STATE_BLOCKS = 4    # WK_STATE_BLOCKS: chunk-state blocks an SM
OUT_BLOCKS = 2      # WK_OUT_BLOCKS: chunk-output blocks an SM
ALIGN = 16          # bytes: the kernels' vector loads and stores
_NSUB = MAX_CHUNK // SUB
_TILE = MAX_CHUNK * ROW_STRIDE
#: shared memory of a chunk-state block: k, v and the decays
#: (``STATE_SMEM``)
STATE_SMEM = 4 * 3 * _TILE
#: of a chunk-output block: r, k, v, cw_prev (then A), cw and S_prev, then
#: exp(C_q), the three pair factors, u, each row's bonus and the diagonal
#: blocks' entries (``OUT_SMEM``)
OUT_SMEM = 4 * (6 * _TILE + _NSUB * HEAD_DIM + 3 * HEAD_DIM + HEAD_DIM
                + MAX_CHUNK + _NSUB * SUB * SUB)


class Wkv6Plan(NamedTuple):
    """The geometry of one K11 call (``wkv6_plan``)."""
    chunks: int            # chunks of L steps a (batch, head)
    sub_rows: tuple        # (first row, rows) of each sub-chunk of a chunk
    items: int             # (batch, head, chunk) items: blocks of passes 1, 3
    walkers: int           # threads of pass 2, one a state element
    grids: tuple           # blocks of the three launches
    smem: tuple            # dynamic shared memory a block of each, bytes
    waves: float           # items over the output blocks the card holds
    scratch_elems: int     # fp32 elements of the scratch: U, then D
    exps: int              # exps the three passes take
    operations: int        # fp32 operations (an FMA is two), exps included


@functools.lru_cache(maxsize=None)
def wkv6_plan(b: int, s: int, h: int, L: int, sms: int) -> Wkv6Plan:
    """The launch geometry of K11 on ``[b, s, h, 64]`` operands, chunks of
    ``L`` steps, on a card of ``sms`` SMs, and the work it does (counted
    over every block, padding rows included, as the kernels run them)."""
    if not (b >= 1 and s >= 1 and h >= 1 and 1 <= L <= MAX_CHUNK):
        raise ValueError(f"wkv6_plan: b {b}, s {s}, h {h}, L {L}")
    e, lm = HEAD_DIM, MAX_CHUNK
    nc = -(-s // L)
    items = b * h * nc
    walkers = b * h * e * e
    sub_rows = tuple((r0, min(SUB, L - r0)) for r0 in range(0, L, SUB))
    rows = s * b * h  # real rows, which pass 1's product alone runs over
    lower = _NSUB * SUB * (SUB - 1) // 2  # strictly lower diagonal pairs
    # exps per item: exp(cw_L) and k's decays (pass 1); exp(C_q), the pair
    # factors, r's and k's decays, the diagonal pairs (pass 3)
    exps_item = (e + lm * e) + (_NSUB * e + 3 * e + 2 * lm * e
                                + lower * e)
    # operations per item: cw (lm e) and k's decays (3 lm e: a difference,
    # an exp, a product) in pass 1, whose product k'^T v runs over the
    # chunk's real rows alone; cw and cw_prev (2 lm e), the bonus (3 lm e),
    # the diagonal pairs (5 e a pair: a difference, an exp, two products,
    # a sum), r's and k's decays (6 lm e), the six off-diagonal blocks (2 e
    # a pair, 3 of them 3 e: the pair factor), A v over the lower blocks,
    # the inter-chunk term and its scaling (lm e) in pass 3
    off = 6 * SUB * SUB * e * 2 + 3 * SUB * SUB * e
    av = sum((a + 1) * SUB for a in range(_NSUB)) * SUB * e * 2
    per_item = (lm * e + 3 * lm * e
                + 2 * lm * e + 3 * lm * e + 5 * lower * e + 6 * lm * e
                + off + av + 2 * lm * e * e + lm * e)
    ops = items * per_item + 2 * rows * e * e + 2 * walkers * nc
    return Wkv6Plan(
        chunks=nc, sub_rows=sub_rows, items=items, walkers=walkers,
        grids=(items, walkers // WALK_THREADS, items),
        smem=(STATE_SMEM, 0, OUT_SMEM),
        waves=items / (sms * OUT_BLOCKS),
        scratch_elems=items * (e * e + e),
        exps=items * exps_item, operations=ops)


def _launch(r, k, v, logw, u, L, state):
    check_cuda("wkv6", r, k, v)
    check_cuda_f32("wkv6 logw, u, state", logw, u,
                   *([] if state is None else [state]))
    if logw.device != r.device:
        raise ValueError("wkv6: all tensors must be on one CUDA device")
    b, s, h, e = r.shape
    if e != HEAD_DIM or not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"wkv6: the kernel takes head width {HEAD_DIM} and "
                         f"chunks of 1 to {MAX_CHUNK} steps, got {e} and {L}")
    ins = (r, k, v, logw) + (() if state is None else (state,))
    if any(t.data_ptr() % ALIGN for t in ins):
        raise ValueError(f"wkv6: the kernel needs r, k, v, logw and the "
                         f"state {ALIGN}-byte aligned")
    dev = r.device
    plan = wkv6_plan(b, s, h, L, sm_count(dev))
    o = torch.empty_like(r)
    s_out = torch.empty((b, h, e, e), dtype=torch.float32, device=dev)
    scratch = torch.empty(plan.scratch_elems, dtype=torch.float32, device=dev)
    entry = "wkv6_bf16" if r.dtype == torch.bfloat16 else "wkv6_f32"
    rc = getattr(_build.library(), entry)(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), None if state is None else state.data_ptr(),
        o.data_ptr(), s_out.data_ptr(), scratch.data_ptr(), b, s, h, L,
        stream_handle(dev))
    _build.check(rc, entry)
    wkv6.launches += 1
    return o, s_out


def wkv6_bwd(saved, needs, chunk, do, ds):
    """The plain backward of K11: ``wkv6_chunked_ref`` re-run under
    autograd on the saved inputs (r, k, v, logw, u, state), differentiated
    with the cotangents of o and of the final state (either may be None)
    -> the gradients of the inputs ``needs`` flags, None for the others."""
    ins = [None if t is None else t.detach().requires_grad_(need)
           for t, need in zip(saved, needs)]
    with torch.enable_grad():
        o, s_out = wkv6_chunked_ref(*ins[:5], chunk, ins[5])
        pairs = [(t, g) for t, g in ((o, do), (s_out, ds)) if g is not None]
        wrt = [t for t, need in zip(ins, needs) if t is not None and need]
        got = iter(torch.autograd.grad([t for t, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True))
    return [next(got) if t is not None and need else None
            for t, need in zip(ins, needs)]


class Wkv6Fn(torch.autograd.Function):
    """K11 (or its plain version on the CPU) forward; :func:`wkv6_bwd`,
    plain by design, as its backward."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)  # an unused final state: None
        ctx.save_for_backward(r, k, v, logw, u, state)
        if r.device.type == "cuda":
            return _launch(r, k, v, logw, u, min(chunk, r.shape[1]), state)
        return wkv6_chunked_ref(r, k, v, logw, u, chunk, state)

    @staticmethod
    def backward(ctx, do, ds):
        grads = wkv6_bwd(ctx.saved_tensors, ctx.needs_input_grad[:6],
                         ctx.chunk, do, ds)
        return (*grads, None)


def wkv6(r, k, v, logw, u, *, chunk: int, state=None):
    """r, k, v, logw: [b, s, h, e]; u: [h, e]; state: [b, h, e, e] or None
    (zero) -> (o [b, s, h, e] in r's dtype, final state [b, h, e, e] fp32),
    over chunks of ``min(chunk, s)`` steps."""
    b, s, h, e = r.shape
    if (k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape
            or tuple(u.shape) != (h, e) or chunk < 1 or s < 1
            or (state is not None and tuple(state.shape) != (b, h, e, e))):
        raise ValueError(
            f"wkv6: r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, logw {tuple(logw.shape)}, u {tuple(u.shape)}"
            f", state {None if state is None else tuple(state.shape)}, "
            f"chunk {chunk}")
    if r.device.type in ("cpu", "cuda") and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, logw, u, state)):
        return Wkv6Fn.apply(r, k, v, logw, u, state, chunk)
    if r.device.type == "cpu":
        return wkv6_chunked_ref(r, k, v, logw, u, chunk, state)
    if r.device.type == "cuda":
        return _launch(r, k, v, logw, u, min(chunk, s), state)
    raise ValueError(f"wkv6: unsupported device {r.device}")


#: kernel launches since the count was last set to 0
wkv6.launches = 0

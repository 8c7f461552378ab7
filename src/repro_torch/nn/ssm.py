"""Mamba2 (SSD) block — the chunked scan and the O(1)-state decode: the
port of ``repro.nn.ssm``.

The block projects ``[z, x, B, C, dt]`` with ``in_proj`` (K3), runs a
depthwise causal conv of width ``d_conv`` over ``[x, B, C]``, the SSD
recurrence per 64-wide head

    S_t = exp(dt_t A) S_{t-1} + dt_t x_t ⊗ B_t ;  y_t = C_t · S_t + D x_t

and gates, normalises and projects the result back (``out_proj``, K3).
The JAX package computes the conv and the scan with jnp, outside any
Pallas kernel, so both are plain PyTorch here on every device.

A prompt (``mode == "full"``) runs :func:`_ssd_chunked`, the chunked form
of the JAX package, whose intra-chunk products are attention-like and
whose state is carried from chunk to chunk.  Everything that does not
depend on the carried state is computed once for all chunks, as batched
products over the chunk axis; only ``S_c = S_{c-1} exp(cs_L) + Sc`` is a
loop over the chunks (one launch a chunk), and the state term of ``y``
is one batched product after it.  Each element is a sum over the same
terms as the JAX package's.  A decode step runs the one-step recurrence.

Unlike the JAX package, the cache is updated in place: with a cache
(``{"conv": [b, K-1, c], "state": [b, h, p, n]}``, fp32 views of the
model's stacked cache) :func:`ssm_apply` writes the conv's trailing
inputs and the final state into it and returns only its output.  As in
the JAX package, a prompt starts the scan from a zero state and the conv
from the cache's trailing inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.config import ModelConfig
from repro_torch.nn.linear import act_fn, dense, linear_spec
from repro_torch.nn.norm import rmsnorm_apply, rmsnorm_spec
from repro_torch.nn.param import Param


def ssm_dims(cfg: ModelConfig):
    ssm = cfg.ssm
    d_inner = ssm.expand * cfg.d_model
    n_heads = d_inner // ssm.head_dim
    return d_inner, n_heads


def ssm_spec(cfg: ModelConfig) -> dict:
    ssm = cfg.ssm
    d = cfg.d_model
    d_inner, h = ssm_dims(cfg)
    n = ssm.d_state
    # in_proj emits [z, x, B, C, dt]
    return {
        "in_proj": linear_spec(d, 2 * d_inner + 2 * n + h, "embed",
                               "ssm_inner"),
        "conv_w": Param((ssm.d_conv, d_inner + 2 * n), (None, "ssm_inner"),
                        init="fan_in"),
        "conv_b": Param((d_inner + 2 * n,), ("ssm_inner",), init="zeros",
                        dtype="float32"),
        "A_log": Param((h,), (None,), init="zeros", dtype="float32"),
        "D": Param((h,), (None,), init="ones", dtype="float32"),
        "dt_bias": Param((h,), (None,), init="zeros", dtype="float32"),
        "out_norm": rmsnorm_spec(d_inner),
        "out_proj": linear_spec(d_inner, d, "ssm_inner", "embed"),
    }


#: the leaves of ``ssm_spec`` that the init rules leave at zeros or ones,
#: as (mean, std) of a seeded normal to redraw them from for checks: at
#: their init every head decays alike (A = -1, dt = softplus(dt_raw)), the
#: conv has no bias and D is 1, and a scan that mixed up heads would pass
#: the model checks.  A_log ~ N(0, 1) spreads the heads' A over about
#: [-7.4, -0.14] (two std); dt_bias ~ N(-3, 1) puts dt = softplus(dt_raw
#: + dt_bias) near 0.05, so some heads carry their state across chunks and
#: others forget it within one.  ``chip_smoke.py`` (phase 10) and
#: tests/test_torch_{ssm,zamba2}.py use it.
SSM_REDRAW = {"A_log": (0.0, 1.0), "dt_bias": (-3.0, 1.0),
              "conv_b": (0.0, 0.1), "D": (1.0, 0.5)}


def ssm_redraw(tree: dict, generator: torch.Generator) -> None:
    """Redraw ``SSM_REDRAW``'s leaves of every Mamba2 unit of a zamba2
    parameter tree (JAX layout: ``mamba`` and ``mamba_tail`` stacked) in
    place, from ``generator`` on their device."""
    for stack in ("mamba", "mamba_tail"):
        if stack not in tree:
            continue
        for name, (mean, std) in SSM_REDRAW.items():
            t = tree[stack]["ssm"][name]
            t.copy_(mean + std * torch.randn(
                t.shape, generator=generator, device=t.device,
                dtype=torch.float32))


_silu = act_fn("silu")


def _split_proj(proj, cfg: ModelConfig):
    d_inner, h = ssm_dims(cfg)
    n = cfg.ssm.d_state
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * n, h], dim=-1)
    return z, xbc, dt  # xbc = [x, B, C] convolved together


def _causal_conv(xbc, w, b, state=None):
    """Depthwise causal conv over time.  xbc: [b, s, c]; w: [K, c].

    With ``state`` ([b, K-1, c], the trailing inputs of the previous call)
    performs the streaming update; returns (y, new_state), new_state the
    last K-1 rows of the padded input in xbc's dtype.  The taps are summed
    as the JAX package writes them: each product and each partial sum in
    xbc's dtype, tap 0 first, then the bias cast to that dtype (the same
    bits as the JAX package's on the CPU), then silu as ``act_fn`` takes
    it: y times an fp32 sigmoid rounded to y's dtype.  (XLA's CPU backend
    expands a bf16 sigmoid into bf16 exp, add and reciprocal, each
    rounded; the two differ by about one bf16 rounding of the output.)
    """
    K = w.shape[0]
    s = xbc.shape[1]
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[2]))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [b, s+K-1, c]
    y = xp[:, 0:s] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b.to(y.dtype)
    return _silu(y), xp[:, s:]


def _softplus(x):
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
    (no linear branch, unlike ``F.softplus``)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _ssd_chunked(x, dt, A, B, C, chunk: int):
    """x: [b,s,h,p], dt: [b,s,h] (post-softplus, fp32), A: [h] (<0),
    B, C: [b,s,n].  Returns y [b,s,h,p] in x's dtype and the final state
    [b,h,p,n] (fp32), starting from a zero state.

    The JAX package's chunked form (``L = min(chunk, s)``, the sequence
    padded with zero rows to a whole number of chunks: their dt is 0, so
    they decay nothing and add nothing), with the terms that do not
    depend on the carried state computed for all chunks at once.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    L = min(chunk, s)
    pad = (-s) % L
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // L
    xc = x.reshape(b, nc, L, h, p).float()
    dtc = dt.reshape(b, nc, L, h).float()
    Bc = B.reshape(b, nc, L, n).float()
    Cc = C.reshape(b, nc, L, n).float()

    cs = torch.cumsum(dtc * A, dim=2)  # inclusive cumulative log-decay
    scores = Cc @ Bc.transpose(-1, -2)  # [b, nc, L(l), L(m)]
    # decay from step m (exclusive) to step l (inclusive), 0 above the
    # diagonal.  There the exponent is positive and may overflow: it is
    # set to -inf before the exp, not the exp's inf selected away after
    # (the JAX package's ``where``), whose backward multiplies a zero
    # gradient by inf and gives NaN; the values are the same bits
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    M = torch.exp((cs[:, :, :, None, :] - cs[:, :, None, :, :]).masked_fill(
        ~causal[:, :, None], float("-inf")))  # [b, nc, l, m, h]
    W = scores[..., None] * M * dtc[:, :, None, :, :]
    # y[l, h, p] = sum_m W[l, m, h] x[m, h, p], one product per (b, c, h)
    y = (W.permute(0, 1, 4, 2, 3) @ xc.permute(0, 1, 3, 2, 4)
         ).permute(0, 1, 3, 2, 4)  # [b, nc, L, h, p]
    # each chunk's own end state: sum_l x[l] (decay_to_end dt)[l] ⊗ B[l]
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)  # [b, nc, L, h]
    xw = xc * (decay_to_end * dtc)[..., None]
    Sc = xw.permute(0, 1, 3, 4, 2) @ Bc[:, :, None]  # [b, nc, h, p, n]
    # the carried state: the state entering each chunk, one launch a chunk
    decay = torch.exp(cs[:, :, -1, :])  # [b, nc, h]
    S_in = x.new_zeros((nc + 1, b, h, p, n), dtype=torch.float32)
    Sc = Sc.transpose(0, 1).contiguous()
    decay = decay.transpose(0, 1)[..., None, None].contiguous()
    if torch.is_grad_enabled() and (Sc.requires_grad or decay.requires_grad):
        # the same sums out of place, so that autograd can follow them
        states = [S_in[0]]
        for c in range(nc):
            states.append(torch.addcmul(Sc[c], states[c], decay[c]))
        S_in = torch.stack(states)
    else:
        for c in range(nc):
            torch.addcmul(Sc[c], S_in[c], decay[c], out=S_in[c + 1])
    # contribution of the state entering each chunk
    Sp = S_in[:nc].transpose(0, 1).reshape(b, nc, h * p, n)
    ys = (Cc @ Sp.transpose(-1, -2)).reshape(b, nc, L, h, p)
    y = y + ys * torch.exp(cs)[..., None]
    y = y.reshape(b, nc * L, h, p)[:, :s].to(x.dtype)
    return y, S_in[nc]


def ssm_apply(params, x, cfg: ModelConfig, *, mode: str = "full",
              cache: Optional[dict] = None) -> torch.Tensor:
    """x: [b, s, d] -> [b, s, d]; with ``cache`` its ``conv`` and
    ``state`` are overwritten with the conv's trailing inputs and the
    final state.  ``mode`` "full" runs the chunked scan from a zero
    state, "decode" (s == 1) one step from the cache's state."""
    ssm = cfg.ssm
    d_inner, h = ssm_dims(cfg)
    n = ssm.d_state
    p = ssm.head_dim

    proj = dense(params["in_proj"], x)
    z, xbc, dt_raw = _split_proj(proj, cfg)
    dt = _softplus(dt_raw.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])  # [h], negative

    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 conv_state)
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    bsz, s, _ = x.shape
    xh = xs.reshape(bsz, s, h, p)

    if mode == "full":
        y, S = _ssd_chunked(xh, dt, A, B, C, ssm.chunk_size)
    elif mode == "decode":  # s == 1
        S = cache["state"]  # [b, h, p, n]
        dA = torch.exp(dt[:, 0] * A)  # [b, h]
        dBx = torch.einsum("bn,bh,bhp->bhpn", B[:, 0].float(), dt[:, 0],
                           xh[:, 0].float())
        S = S * dA[:, :, None, None] + dBx
        y = torch.einsum("bn,bhpn->bhp", C[:, 0].float(), S)
        y = y[:, None].to(x.dtype)
    else:
        raise ValueError(f"unknown ssm mode {mode!r}")
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["state"].copy_(S)

    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, d_inner)
    y = y * _silu(z)
    y = rmsnorm_apply(params["out_norm"], y, cfg.norm_eps)
    return dense(params["out_proj"], y)


# ---------------------------------------------------------------------------
# Naive per-step recurrence — test oracle
# ---------------------------------------------------------------------------


def ssd_reference(x, dt, A, B, C):
    """Same inputs as _ssd_chunked; the per-timestep recurrence in fp32
    -> (y [b,s,h,p] fp32, final state [b,h,p,n])."""
    b, s, h, p = x.shape
    x, dt, B, C = (t.float() for t in (x, dt, B, C))
    S = x.new_zeros((b, h, p, B.shape[-1]))
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t] * A)  # [b, h]
        S = S * dA[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhpn", B[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhpn->bhp", C[:, t], S))
    return torch.stack(ys, dim=1), S

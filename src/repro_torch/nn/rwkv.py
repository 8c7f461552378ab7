"""RWKV6 ("Finch") time and channel mixing: the port of ``repro.nn.rwkv``.

Time mixing runs the WKV6 recurrence per 64-wide head,

    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t ;  o_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)

with the data-dependent decay ``w_t = exp(-exp(w0 + lora(x)))`` and the
data-dependent token-shift interpolation (ddlerp).  A prompt of more than
one token (``mode == "full"``) runs the chunked form through K11's wrapper,
``repro_torch.kernels.wkv6.ops.wkv6``: the kernel for a CUDA tensor, its
plain version for a CPU tensor.  A decode step and a one-token prompt run
the per-timestep ``wkv6_reference``, plain PyTorch on every device, as in
the JAX package.  Every projection goes through ``dense`` (K3); the ddlerp
and decay LoRA products are plain ``torch.matmul`` in fp32, as the JAX
package leaves them to XLA.

Unlike the JAX package, the cache is updated in place: with a cache
(``{"last": [b, d], "state": [b, h, e, e]}``, fp32 views of the model's
stacked cache) the apply functions write the new token-shift row and
state into it and return only their output.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.config import ModelConfig
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_reference
from repro_torch.nn.linear import dense, linear_spec
from repro_torch.nn.norm import rmsnorm_apply, rmsnorm_spec
from repro_torch.nn.param import Param

_BRANCHES = ("r", "k", "v", "w", "g")


def rwkv_dims(cfg: ModelConfig):
    d = cfg.d_model
    h = d // cfg.rwkv.head_dim
    return d, h


def rwkv_time_spec(cfg: ModelConfig) -> dict:
    r = cfg.rwkv
    d, h = rwkv_dims(cfg)
    nb = len(_BRANCHES)
    return {
        # ddlerp: shared trunk + per-branch head
        "mu": Param((nb, d), (None, "embed"), init="zeros", dtype="float32"),
        "mu_x": Param((d,), ("embed",), init="zeros", dtype="float32"),
        "lora_A": Param((d, nb * r.tokenshift_lora), ("embed", None),
                        init="fan_in", dtype="float32"),
        "lora_B": Param((nb, r.tokenshift_lora, d), (None, None, "embed"),
                        init="zeros", dtype="float32"),
        # decay lora
        "w0": Param((d,), ("embed",), init="zeros", dtype="float32"),
        "w_A": Param((d, r.decay_lora), ("embed", None), init="fan_in",
                     dtype="float32"),
        "w_B": Param((r.decay_lora, d), (None, "embed"), init="zeros",
                     dtype="float32"),
        "u": Param((d,), ("embed",), init="zeros", dtype="float32"),
        "wr": linear_spec(d, d, "embed", "ssm_inner"),
        "wk": linear_spec(d, d, "embed", "ssm_inner"),
        "wv": linear_spec(d, d, "embed", "ssm_inner"),
        "wg": linear_spec(d, d, "embed", "ssm_inner"),
        "wo": linear_spec(d, d, "ssm_inner", "embed"),
        "out_norm": rmsnorm_spec(r.head_dim),
    }


def rwkv_channel_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "mu_k": Param((d,), ("embed",), init="zeros", dtype="float32"),
        "mu_r": Param((d,), ("embed",), init="zeros", dtype="float32"),
        "wk": linear_spec(d, cfg.d_ff, "embed", "ff"),
        "wv": linear_spec(cfg.d_ff, d, "ff", "embed"),
        "wr": linear_spec(d, d, "embed", "embed"),
    }


#: the leaves of the specs above that the init rules leave at zero, as
#: (mean, std) of a seeded normal to redraw them from for checks: at zero
#: every token and channel sees logw = -1 and no bonus, and a K11 that read
#: the wrong channel of the decays or dropped the bonus would pass the
#: model checks.  w0 ~ N(-0.5, 1) spreads exp(w0) over about [0.08, 4.5]
#: (two std), w_B varies it by token.  ``chip_smoke.py`` (phase 8) and
#: tests/test_torch_rwkv.py use it.
RWKV_REDRAW = {"time": {"mu": (0.0, 0.5), "mu_x": (0.0, 0.5),
                        "lora_B": (0.0, 0.05), "w0": (-0.5, 1.0),
                        "w_B": (0.0, 0.05), "u": (0.0, 0.5)},
               "chan": {"mu_k": (0.0, 0.5), "mu_r": (0.0, 0.5)}}


def rwkv_redraw(tree: dict, generator: torch.Generator) -> None:
    """Redraw ``RWKV_REDRAW``'s leaves of an RWKV6 parameter tree (JAX
    layout, layers stacked) in place, from ``generator`` on their device."""
    for part, leaves in RWKV_REDRAW.items():
        for name, (mean, std) in leaves.items():
            t = tree["layers"][part][name]
            t.copy_(mean + std * torch.randn(
                t.shape, generator=generator, device=t.device,
                dtype=torch.float32))


def _token_shift(x, last: Optional[torch.Tensor]):
    """sx_t = x_{t-1} - x_t; ``last`` is the final token of the previous
    segment ([b, d]) for streaming decode, else zero."""
    if last is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        prev = torch.cat([last[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return prev - x


def _ddlerp(params, x, sx):
    """Data-dependent interpolation producing the 5 branch inputs."""
    nb = len(_BRANCHES)
    xf, sxf = x.float(), sx.float()
    base = xf + sxf * params["mu_x"]
    t = torch.tanh(base @ params["lora_A"])  # [b, s, nb * L]
    t = t.reshape(*t.shape[:-1], nb, -1)  # [b, s, nb, L]
    adj = torch.einsum("bsnl,nld->bsnd", t, params["lora_B"])
    mix = params["mu"] + adj  # [b, s, nb, d]
    out = xf[:, :, None, :] + sxf[:, :, None, :] * mix
    return tuple(out[:, :, i].to(x.dtype) for i in range(nb))


def rwkv_time_apply(params, x, cfg: ModelConfig, *,
                    cache: Optional[dict] = None,
                    mode: str = "full") -> torch.Tensor:
    """x: [b, s, d] -> [b, s, d]; with ``cache`` its ``last`` and ``state``
    are overwritten with the segment's last token and final state."""
    d, h = rwkv_dims(cfg)
    e = cfg.rwkv.head_dim
    b, s, _ = x.shape
    last = cache["last"] if cache is not None else None
    sx = _token_shift(x, last)
    xr, xk, xv, xw, xg = _ddlerp(params, x, sx)

    r = dense(params["wr"], xr).reshape(b, s, h, e)
    k = dense(params["wk"], xk).reshape(b, s, h, e)
    v = dense(params["wv"], xv).reshape(b, s, h, e)
    g = dense(params["wg"], xg)
    loww = (params["w0"]
            + torch.tanh(xw.float() @ params["w_A"]) @ params["w_B"])
    logw = -torch.exp(loww).reshape(b, s, h, e)  # log decay < 0
    u = params["u"].reshape(h, e)

    state = cache["state"] if cache is not None else None
    if mode == "full" and s > 1:
        o, S_final = wkv6(r, k, v, logw, u, chunk=cfg.rwkv.chunk_size,
                          state=state)
    else:
        o, S_final = wkv6_reference(r, k, v, logw, u, state)

    o = rmsnorm_apply(params["out_norm"], o, cfg.norm_eps)
    o = o.reshape(b, s, d) * F.silu(g)
    if cache is not None:
        cache["last"].copy_(x[:, -1])
        cache["state"].copy_(S_final)
    return dense(params["wo"], o)


def rwkv_channel_apply(params, x, cfg: ModelConfig,
                       cache: Optional[dict] = None) -> torch.Tensor:
    """The channel mix (squared-relu MLP with a receptance gate); with
    ``cache`` its ``last`` is overwritten with the segment's last token."""
    last = cache["last"] if cache is not None else None
    sx = _token_shift(x, last).float()
    xf = x.float()
    xk = (xf + sx * params["mu_k"]).to(x.dtype)
    xr = (xf + sx * params["mu_r"]).to(x.dtype)
    kk = dense(params["wk"], xk, act="relu")
    kk = kk * kk
    vv = dense(params["wv"], kk)
    rr = torch.sigmoid(dense(params["wr"], xr).float()).to(x.dtype)
    if cache is not None:
        cache["last"].copy_(x[:, -1])
    return rr * vv

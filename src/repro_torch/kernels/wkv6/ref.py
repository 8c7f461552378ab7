"""Plain PyTorch versions of the WKV6 kernel (K11): the chunked form that
the kernel computes and the per-timestep recurrence, the port of
``repro.nn.rwkv._wkv6_chunked`` and ``wkv6_reference``.

    S_t = diag(w_t) S_{t-1} + k_t v_t^T ;  o_t = r_t (S_{t-1} + u ⊙ k_t v_t^T)

r, k, v, logw: [b, s, h, e] (logw = log w_t < 0, fp32); u: [h, e] fp32;
the state [b, h, e, e] fp32 in the layout [key, value].  Both are fp32
inside and cast o once to r's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.common import ACC_DTYPE


def wkv6_chunked_ref(r, k, v, logw, u, chunk: int, state=None):
    """The chunked form, chunks of ``L = min(chunk, s)`` steps -> (o, final
    state).  The sequence is padded to a multiple of L with r = k = v = 0
    and logw = 0 (decay 1), which leave the state as it was.  Within a
    chunk the pairwise decays ``exp(cw_prev_i - cw_j)`` (j < i, at most 1)
    are formed explicitly; across chunks the state is carried."""
    b, s, h, e = r.shape
    L = min(chunk, s)
    pad = (-s) % L
    nc = (s + pad) // L

    def chunks(x):  # [b, s, h, e] -> [b, nc, L, h, e], fp32, zero-padded
        return F.pad(x.to(ACC_DTYPE), (0, 0, 0, 0, 0, pad)).reshape(
            b, nc, L, h, e)

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(logw)
    uf = u.to(ACC_DTYPE)
    strict = torch.ones((L, L), dtype=torch.bool, device=r.device).tril(-1)
    S = (torch.zeros((b, h, e, e), dtype=ACC_DTYPE, device=r.device)
         if state is None else state.to(ACC_DTYPE))
    outs = []
    for c in range(nc):
        r_c, k_c, v_c, w_c = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        cw = torch.cumsum(w_c, dim=1)  # inclusive
        cw_prev = cw - w_c  # exclusive
        # A[i, j] = sum_e r_i k_j exp(cw_prev_i - cw_j), j < i.  The pairs
        # j >= i are selected away in the exponent (exp(-inf) = 0), not
        # after it: there the exponent is positive and may overflow, and
        # an inf times a zero cotangent would make the backward NaN
        expo = cw_prev[:, :, None] - cw[:, None]  # [b,I,J,h,e]
        decay = torch.exp(torch.where(strict[:, :, None, None], expo,
                                      float("-inf")))
        A = torch.einsum("bihe,bijhe,bjhe->bhij", r_c, decay, k_c)
        diag = torch.einsum("bihe,he,bihe->bih", r_c, uf, k_c)
        o = torch.einsum("bhij,bjhe->bihe", A, v_c)
        o = o + diag[..., None] * v_c
        o = o + torch.einsum("bihe,bhef->bihf", r_c * torch.exp(cw_prev), S)
        total = cw[:, -1]  # [b, h, e]
        Sc = torch.einsum("bjhe,bjhf->bhef",
                          k_c * torch.exp(total[:, None] - cw), v_c)
        S = S * torch.exp(total)[..., None] + Sc
        outs.append(o)
    o = torch.cat(outs, dim=1)[:, :s]
    return o.to(r.dtype), S


def wkv6_reference(r, k, v, logw, u, state=None):
    """The per-timestep recurrence (fp32) -> (o, final state): the decode
    step's path and the oracle of the chunked form."""
    b, s, h, e = r.shape
    S = (torch.zeros((b, h, e, e), dtype=ACC_DTYPE, device=r.device)
         if state is None else state.to(ACC_DTYPE))
    uf = u.to(ACC_DTYPE)[None, :, :, None]
    rf, kf, vf, wf = (x.to(ACC_DTYPE) for x in (r, k, v, logw))
    outs = []
    for t in range(s):
        kv = torch.einsum("bhe,bhf->bhef", kf[:, t], vf[:, t])
        outs.append(torch.einsum("bhe,bhef->bhf", rf[:, t], S + uf * kv))
        S = S * torch.exp(wf[:, t])[..., None] + kv
    return torch.stack(outs, dim=1).to(r.dtype), S

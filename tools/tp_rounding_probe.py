"""How far a bf16 model's logits move when only the order of its
row-parallel sums changes, by depth, on the CPU.

    PYTHONPATH=src python tools/tp_rounding_probe.py [--layers 1 2 4 8 16]

A 2-way tensor-parallel o and down projection adds two fp32 partials
(each half of K) and then rounds once to bf16, where the whole product
rounds its one fp32 sum: the same function, summed in another order.
This probe runs qwen1.5-32b's family at d_model 1024 (8 heads of 128,
d_ff 4096, bf16, weights from seed 0) twice on the same 2 x 40-token
prompt — the port as it is, then with every row-parallel product
(``nn.linear.dense`` with ``k_axis``) computed as the two halves' fp32
sum — and prints, for each depth, the largest absolute and the relative
RMS difference of the last position's logits, beside the largest
logit.  What moves them is only which elements round apart in bf16.
One intra-op thread, so that the CPU's own sums keep one order.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core.config import get_arch
from repro_torch.kernels.matmul_fused import ref as mm_ref
from repro_torch.models.registry import get_model
from repro_torch.nn import attention, linear, mlp
from repro_torch.nn.param import init_tree


def halves(params, x, act="none", k_axis=None):
    """``dense`` with a row-parallel product's sum in two fp32 halves."""
    if k_axis is None:
        return linear.dense(params, x, act)
    w = params["w"]
    h = w.shape[0] // 2
    y = x[..., :h].float() @ w[:h].float() + x[..., h:].float() @ w[h:].float()
    if "b" in params:
        y = y + params["b"].float()
    return mm_ref._ACTS[act](y).to(x.dtype)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, nargs="+",
                    default=[1, 2, 4, 8, 16])
    args = ap.parse_args()
    torch.set_num_threads(1)
    tokens = torch.randint(0, 512, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    for layers in args.layers:
        cfg = dataclasses.replace(
            get_arch("qwen1.5-32b").reduced(), num_layers=layers,
            d_model=1024, d_ff=4096, num_heads=8, num_kv_heads=8,
            head_dim=128)
        model = get_model(cfg)
        model.load_tree(init_tree(model.param_spec(),
                                  torch.Generator().manual_seed(0),
                                  "bfloat16"))
        out = {}
        with torch.no_grad():
            for name, fn in (("whole", linear.dense), ("halves", halves)):
                attention.dense = mlp.dense = fn
                try:
                    out[name] = model.forward({"tokens": tokens},
                                              "prefill")[0][:, -1].float()
                finally:
                    attention.dense = mlp.dense = linear.dense
        d = out["halves"] - out["whole"]
        rms = (d.square().mean().sqrt()
               / out["whole"].square().mean().sqrt()).item()
        print(f"{layers} layers: max abs {d.abs().max().item():.4g}, "
              f"relative rms {rms:.4g}, largest logit "
              f"{out['whole'].abs().max().item():.4g}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

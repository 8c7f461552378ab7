"""End-to-end serving example of the PyTorch/CUDA port: serve a small model
with batched requests through the continuous-batching engine, the
counterpart of ``examples/deploy_and_serve.py``.

A reduced gemma2 (local/global attention, softcaps — the full feature
set), seeded weights, and 8 concurrent requests through 4 slots at mixed
temperatures: prefill into a slot, batched decode, slot reuse.  Fully
seeded, so two runs on one device print the same token lists.

Run:  PYTHONPATH=src python examples/deploy_and_serve_torch.py
      PYTHONPATH=src python examples/deploy_and_serve_torch.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.config import get_arch
from repro_torch.kernels.common import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_arch("gemma2-2b").reduced()
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[serve] model={cfg.name}(reduced) params={n_params / 1e6:.1f}M "
          f"slots=4 max_len=128 device={dev}")

    eng = ServingEngine(model, max_batch=4, max_len=128, seed=0, device=dev)
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    for rid in range(8):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=int(rng.integers(4, 16))).tolist()
        eng.submit(Request(rid, prompt,
                           max_new_tokens=int(rng.integers(8, 20)),
                           temperature=0.0 if rid % 2 == 0 else 0.8))
    done = eng.run_until_drained()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in done.values())
    print(f"[serve] {len(done)} requests, {toks} tokens, {dt:.2f} s "
          f"({toks / dt:.1f} tok/s, host clock, first call included)")
    for rid in sorted(done):
        print(f"  req {rid}: {done[rid]}")
    return done


if __name__ == "__main__":
    main()

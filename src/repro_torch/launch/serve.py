"""Serving launcher: run the batched serving engine on a registered arch —
the port of ``repro.launch.serve``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --requests 6 --max-new 16

It runs on ``cuda`` unless ``--device`` names another device
(``--device cpu`` runs the plain versions), and raises when there is no
GPU and no device is named.  As in the JAX package,
``--reduced`` is a flag whose default is already on, so the launcher
always serves the reduced model (ROADMAP.md §3), the MoE archs
(qwen3-moe-30b-a3b, grok-1-314b) and zamba2-1.2b among them.  The
cross-attention archs are refused, as in the JAX package: the engine
passes tokens only, and their models take media or frames through
``forward(batch, mode, cache)`` and ``decode_step``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.config import get_arch
from repro_torch.kernels.common import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serving.engine import Request, ServingEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to serve on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("serve launcher supports text-only archs; drive "
                         "the model's forward(batch, mode, cache) with "
                         "media_embeds or frames, then decode_step")
    device = resolve_device(args.device)
    model = get_model(cfg).init(torch.Generator(device).manual_seed(args.seed))
    eng = ServingEngine(model, max_batch=args.max_batch, max_len=args.max_len,
                        device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 12)).tolist()
        eng.submit(Request(rid, prompt, max_new_tokens=args.max_new))
    done = eng.run_until_drained()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in done.values())
    print(f"[serve] {cfg.name}: {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.1f}s ({total_tokens/dt:.1f} tok/s)")
    for rid in sorted(done):
        print(f"  req {rid}: {done[rid][:12]}{'...' if len(done[rid])>12 else ''}")
    return {"tokens": total_tokens, "seconds": dt, "done": done}


if __name__ == "__main__":
    main()

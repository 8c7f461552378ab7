"""Training launcher: real AdamW steps of a registered arch (full or
``--reduced``) on one device — the port of ``repro.launch.train``.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b \\
      --reduced --steps 50 --batch 8 --seq 128 --ckpt /tmp/ckpt

It runs on ``cuda`` unless ``--device`` names another device (``--device
cpu`` runs the plain versions), and raises when there is no GPU and no
device is named.  The JAX launcher's mesh and sharding context have no
counterpart on one card (ROADMAP.md, queue 1 item 6).  The corpus,
``MarkovLM(vocab)``, is a vocab x vocab float64 matrix (524 GB at
gemma2's 256000), so the launcher is for ``--reduced`` archs, as the JAX
one is.  The vlm and audio families get zero media embeddings or frames,
as the JAX launcher gives them (in the model's dtype: the same zeros).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.config import TrainConfig, get_arch
from repro_torch.kernels.common import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.nn.param import DTYPES, init_tree, tree_leaves
from repro_torch.train.checkpoint import save_checkpoint
from repro_torch.train.data import MarkovLM, batches
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps)
    params = init_tree(model.param_spec(),
                       torch.Generator(device).manual_seed(args.seed),
                       cfg.param_dtype)
    model.load_tree(params)
    opt = adamw_init(params)
    step_fn = make_train_step(model, tcfg, microbatches=args.microbatches)

    lm = MarkovLM(cfg.vocab_size, seed=args.seed)
    floor = lm.entropy()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"[train] {cfg.name} on {device}: {n_params / 1e6:.1f}M params, "
          f"CE floor (markov entropy) = {floor:.3f} nats")

    it = batches(lm, args.batch, args.seq, seed=args.seed + 1)
    history = []
    t0 = time.time()
    for step in range(1, args.steps + 1):
        tokens, labels = next(it)
        batch = {"tokens": torch.from_numpy(tokens).long().to(device),
                 "labels": torch.from_numpy(labels).long().to(device)}
        if cfg.family in ("vlm", "audio"):
            key = "media_embeds" if cfg.family == "vlm" else "frames"
            batch[key] = torch.zeros(
                (args.batch, cfg.cross_attn.num_media_tokens,
                 cfg.cross_attn.media_dim), dtype=DTYPES[cfg.param_dtype],
                device=device)
        params, opt, metrics = step_fn(params, opt, batch)
        if step % args.log_every == 0 or step == 1:
            ce = float(metrics["ce"])
            history.append((step, ce))
            print(f"  step {step:5d}  ce={ce:.4f}  "
                  f"gnorm={float(metrics['grad_norm']):.2f}  "
                  f"({(time.time() - t0) / step:.2f}s/step)", flush=True)
    if args.ckpt:
        save_checkpoint(args.ckpt, params, opt, args.steps,
                        {"arch": cfg.name, "reduced": args.reduced})
        print(f"[train] checkpoint -> {args.ckpt}")
    return {"history": history, "floor": floor}


if __name__ == "__main__":
    main()

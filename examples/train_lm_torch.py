"""End-to-end training driver of the PyTorch/CUDA port: train a small LM
for a few hundred steps on a synthetic Markov corpus whose entropy floor
is known in closed form, then checkpoint and reload — the counterpart of
``examples/train_lm.py``.

The model is a reduced starcoder2 (sliding-window attention + plain-gelu
MLP).  CE should drop from ~ln(V) toward the Markov entropy floor.  It
trains on ``cuda`` unless ``--device`` names another device.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200]
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main
from repro_torch.train.checkpoint import load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="the device to train on (default: cuda)")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    flags = ["--arch", "starcoder2-15b", "--reduced",
             "--steps", str(args.steps), "--batch", "8", "--seq", "128",
             "--lr", "3e-3", "--log-every", "20", "--ckpt", ckpt]
    if args.device:
        flags += ["--device", args.device]
    result = train_main(flags)
    first = result["history"][0][1]
    last = result["history"][-1][1]
    floor = result["floor"]
    print(f"\n[train_lm_torch] ce {first:.3f} -> {last:.3f} "
          f"(floor {floor:.3f}); improvement {first - last:.3f} nats")
    params, opt, step, extra = load_checkpoint(ckpt, device=args.device)
    print(f"[train_lm_torch] checkpoint reloaded: step={step} "
          f"arch={extra['arch']}")
    assert last < first, "training must reduce loss"


if __name__ == "__main__":
    main()

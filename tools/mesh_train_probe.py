"""Phase 17 of ``chip_smoke.py`` alone on the card: gemma2-2b training
data and tensor parallel over a process group.

    python3 tools/mesh_train_probe.py [--json PATH] [--meshes 2x1,1x2,2x2]

Prints the card (``nvidia-smi --query-gpu=name,power.limit``), builds
the kernels, then runs ``chip_smoke.mesh_phase``: 17a (K3's fp32-store
backward at gemma2's 2-way o and down shards), 17b (the 1 x 1 NCCL mesh,
bit for bit against the unsharded port), 17c (each mesh's gloo ranks on
the one card against the unsharded reference; ``--meshes`` picks them)
and 17d (the dry run's ``train_4k`` rows), each failing the run as in the
smoke.  ``--json`` keeps every record.  Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json")
    ap.add_argument("--meshes", help="comma-separated 17c meshes")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    os.environ["MKL_CBWR"] = cs.MKL_CBWR
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this probe needs a GPU")
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    if args.meshes:
        cs.MESH_TRAIN_MESHES = tuple(args.meshes.split(","))
    counters = {"K3": mm_ops.matmul_fused, "K10": attn_ops.flash_attention}
    cases, one, meshes, rows = cs.mesh_phase(
        torch, np, dev, cs.card_peaks(torch.cuda.get_device_name(0)),
        counters, card)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card, "cases": cases, "mesh_one": one,
             "mesh_runs": meshes, "mesh_dryrun": rows}, indent=1,
            default=str))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

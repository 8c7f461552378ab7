"""Phase 20 of ``chip_smoke.py`` alone on the card: "ssm_inner" on a mesh.

    python3 tools/ssm_mesh_probe.py [--json PATH]

Prints the card (``nvidia-smi --query-gpu=name,power.limit``), builds
the kernels, then runs ``chip_smoke.ssm_mesh_phase``: 20a (K11 at a
rank's 16 heads from a state, K3 at rwkv6's and zamba2's 1 x 2 rank
shapes, the row-parallel products on the fp32 store, and K10 at the
shared block's 16 heads over 16), 20b (rwkv6-1.6b served on a 1 x 2 gloo
mesh, its WKV heads and their projections cut over "model"), 20c
(zamba2-1.2b on the same ranks, its SSD heads, in_proj's columns and the
shared block's heads cut) and 20d (a bf16 train step of each on the same
ranks), each failing the run as in the smoke.  ``--json`` keeps the
record.  Needs one CUDA device and nvcc.
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
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    os.environ["MKL_CBWR"] = cs.MKL_CBWR
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this probe needs a GPU")
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import _build

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
    rec = cs.ssm_mesh_phase(torch, F, np, dev,
                            cs.card_peaks(torch.cuda.get_device_name(0)),
                            card)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rec, indent=1, default=str))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Phase 18 of ``chip_smoke.py`` alone on the card: kv-sequence sharding.

    python3 tools/kv_seq_probe.py [--json PATH]

Prints the card (``nvidia-smi --query-gpu=name,power.limit``), builds
the kernels, then runs ``chip_smoke.kv_phase``: 18a (K3 at starcoder2's
8-way shards, K10 at the rank views of starcoder2 and gemma2-2b), 18b
(starcoder2-15b served on a 1 x 8 gloo mesh, the cache cut over
"model"), 18c (gemma2-2b under ``long_500k``'s rules on 2 x 1, the cache
cut over "data"), 18d (gemma2-2b's train step on 1 x 8, q heads cut over
whole kv heads) and 18e (the dry run's dense rows at 16 x 16 and
2 x 16 x 16), each failing the run as in the smoke.  ``--json`` keeps
the record.  Needs one CUDA device and nvcc.
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
    rec = cs.kv_phase(torch, F, np, dev,
                      cs.card_peaks(torch.cuda.get_device_name(0)), card)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(rec, indent=1, default=str))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

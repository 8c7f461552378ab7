"""The unsharded serving path's step times on the card, for one tree of
the port, to set two trees side by side.

    python3 tools/decode_ab.py --src SRC [--json PATH]

Imports ``repro_torch`` from ``SRC`` (the ``src`` directory of a
checkout: this one's, or a parent commit's unpacked beside it), builds
its kernels, and serves through ``chip_smoke.lm_serving_phase`` (the
driver of the smoke's phases 7 and 15, two runs each) gemma2-2b at full
depth and ``chip_smoke.DENSE_ARCHS`` at ``DENSE_CUTS``' depths, weights
drawn from the seed, ``LM_PROMPTS`` into ``LM_MAX_BATCH`` slots of
``LM_MAX_LEN`` rows.  Prints each arch's decode step (median over both
runs, host clock around a synchronized step, as the phases time it) and
its prefills' ms.  Run it once a tree, each in a process of its own,
parent / change / change / parent in one session on one card, and
compare only within it.  Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory whose repro_torch is served")
    ap.add_argument("--json", help="also write the record here")
    args = ap.parse_args()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this tool needs a GPU")
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import ops as attn_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"{src}: {card}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    out = {"src": str(src), "card": card,
           "build_s": time.perf_counter() - t0, "archs": {}}
    counters = {"K3": mm_ops.matmul_fused, "K10": attn_ops.flash_attention}
    per_layer = {cs.LM_ARCH: 7, **cs.K3_DENSE_PER_LAYER}
    for arch in (cs.LM_ARCH,) + cs.DENSE_ARCHS:
        gc.collect()
        torch.cuda.empty_cache()
        model, init_s = cs.build_model(torch, arch, dev,
                                       layers=cs.DENSE_CUTS.get(arch,
                                                                (None,))[0])
        n = model.cfg.num_layers
        k3 = per_layer[arch] * n
        rec = cs.lm_serving_phase(
            torch, np, dev, counters, card, model, init_s,
            {"prefill": {"K3": k3, "K10": n}, "decode": {"K3": k3, "K10": 0}})
        del model
        logs = [x for r in rec["runs"] for x in r["log"]]
        steps = [x["ms"] for x in logs if x["kind"] == "decode"]
        out["archs"][arch] = {
            "layers": n, "step_ms_median": statistics.median(steps),
            "step_ms": steps,
            "prefill_ms": [[x["tokens"], x["ms"]] for x in logs
                           if x["kind"] == "prefill"]}
        print(f"decode_ab {arch} ({n} layers): step median "
              f"{statistics.median(steps):.2f} ms of {len(steps)} "
              f"[{card}]", flush=True)
    print("decode_ab " + json.dumps({k: v for k, v in out.items()
                                     if k != "archs"} | {"median_ms": {
                                         a: r["step_ms_median"]
                                         for a, r in out["archs"].items()}}),
          flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

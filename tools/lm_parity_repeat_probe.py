"""Does the fp32 gemma2-2b prefill of the smoke's phase 7b repeat its bits?

Builds the model phase 7b builds (gemma2-2b at full width, two layers,
float32, weights from seed 0) on the card and on the CPU, and a 64-token
prompt from the same seed.  Then:

1. The first CPU prefill after the build, recorded call by call (the
   kernels' plain versions and the layer functions between them): the
   reference of every later run.
2. ``PREFILLS`` prefills on the card, each into a fresh cache: the logits
   of every run against the first run's bit for bit (the rows that differ
   and the largest difference) and against the CPU's (the largest error,
   its element, and the phase's limit 1e-4 · max(1, max|CPU|)).
3. Every call of the port's kernels in one prefill (K3 through
   ``nn.linear``, K10 through ``nn.attention``) and the head's product
   (``lm_logits``), recorded with its inputs and output, replayed
   ``REPLAYS`` times on the same inputs: the replays whose output is not
   the recorded one bit for bit, by call.
4. ``CPU_PREFILLS`` more CPU prefills, recorded the same way: each run's
   logits against the card's first run (the largest error and its
   element) and against the first CPU prefill bit for bit, with the first
   call whose output differs from the first prefill's and whether its
   inputs were the same.

Every CPU prefill runs in the smoke's fixed order (``chip_smoke.
one_thread``: one intra-op thread; ``MKL_CBWR`` set to the smoke's
``MKL_CBWR`` before torch loads).

Prints the card, then one JSON line a part; exits 1 if any bits moved or
any run was over the limit.

    PYTHONPATH=src python3 tools/lm_parity_repeat_probe.py

Needs one CUDA device and nvcc (``/usr/local/cuda/bin`` or PATH).
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SEED = 0
ARCH = "gemma2-2b"
PROMPT = 64
PREFILLS = 30
REPLAYS = 300
TOL = 1e-4
CPU_PREFILLS = 40


def _clone(v):
    import torch

    return v.clone() if isinstance(v, torch.Tensor) else v


@contextlib.contextmanager
def _wrapped(recording, kernels_only=False):
    """Routes the model's calls of the kernels (and, unless
    ``kernels_only``, of every layer function between them) through
    ``recording(kind, fn)``, and puts them back after."""
    from repro_torch.models import common, transformer
    from repro_torch.nn import attention, linear

    names = [(linear, "matmul_fused", "K3"),
             (attention, "flash_attention", "K10"),
             (transformer, "lm_logits", "head")]
    if not kernels_only:
        names += [(transformer, "embed_tokens", "embed"),
                  (transformer, "block_apply", "block"),
                  (transformer, "norm_apply", "final norm"),
                  (common, "attention_apply", "attention"),
                  (common, "mlp_apply", "mlp"),
                  (common, "rmsnorm_apply", "norm"),
                  (attention, "rmsnorm_apply", "qk norm"),
                  (attention, "apply_rope", "rope")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in names]
    for (mod, attr, kind), (_, _, fn) in zip(names, saved):
        setattr(mod, attr, recording(kind, fn))
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def main() -> int:
    import os

    sys.path.insert(0, str(ROOT))
    from chip_smoke import MKL_CBWR, one_thread

    # before torch loads, as the smoke does
    os.environ["MKL_CBWR"] = MKL_CBWR
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.config import get_arch
    from repro_torch.models.registry import get_model
    from repro_torch.nn.param import init_tree, tree_map

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_arch(ARCH), num_layers=2,
                              dtype="float32", param_dtype="float32")
    gpu = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tree = init_tree(gpu.param_spec(), gen, cfg.param_dtype)
    gpu.load_tree(tree)
    cpu = get_model(cfg).load_tree(tree_map(lambda t: t.cpu(), tree))
    prompt = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                  (1, PROMPT))

    def prefill(model):
        t = torch.from_numpy(prompt).to(model.device)
        cache = model.init_cache(1, PROMPT + 16)
        with torch.no_grad():
            logits, _, _ = model({"tokens": t}, mode="prefill", cache=cache)
        return logits

    calls = []

    def recording(name, fn):
        def call(*args, **kw):
            args_c = tuple(_clone(a) for a in args)
            kw_c = {k: _clone(v) for k, v in kw.items()}
            out = fn(*args, **kw)
            first = out[0] if isinstance(out, tuple) else out
            calls.append((name, fn, args_c, kw_c, first.clone()))
            return out
        return call

    def cpu_prefill():
        calls.clear()
        with _wrapped(recording), one_thread(torch):
            lg = prefill(cpu)
        return lg, list(calls)

    # the first CPU prefill after the build, recorded call by call: the
    # reference of every later run
    ref, base = cpu_prefill()
    limit = TOL * max(1.0, ref.abs().max().item())
    bad = 0

    # 1. whole prefills on the card
    runs = [prefill(gpu).cpu() for _ in range(PREFILLS)]
    moved, worst = [], []
    for i, lg in enumerate(runs):
        diff = (lg - ref).abs()
        j = int(diff.argmax())
        worst.append({"run": i, "max_abs_err": diff.max().item(),
                      "element": j, "row": j // lg.shape[-1]})
        if not torch.equal(lg, runs[0]):
            rows = (lg != runs[0]).any(-1).nonzero()[:, -1].tolist()
            moved.append({"run": i, "rows": rows, "max_diff":
                          (lg - runs[0]).abs().max().item()})
    over = [w for w in worst if w["max_abs_err"] > limit]
    bad += len(moved) + len(over)
    print("prefills " + json.dumps({
        "runs": PREFILLS, "limit": limit, "runs_over_limit": over,
        "runs_not_bitwise_equal_to_run_0": moved,
        "max_abs_err_by_run": [w["max_abs_err"] for w in worst]}),
        flush=True)

    # 2. each kernel call of one prefill, replayed on its inputs
    calls.clear()
    with _wrapped(recording, kernels_only=True):
        prefill(gpu)
    rows = []
    with torch.no_grad():
        for idx, (name, fn, args, kw, want) in enumerate(calls):
            diffs = 0
            worst_d = 0.0
            for _ in range(REPLAYS):
                got = fn(*args, **kw)
                if not torch.equal(got, want):
                    diffs += 1
                    worst_d = max(worst_d, (got.float() - want.float())
                                  .abs().max().item())
            torch.cuda.synchronize()
            shapes = [list(a.shape) for a in args
                      if isinstance(a, torch.Tensor)]
            rows.append({"call": idx, "kind": name, "shapes": shapes,
                         "replays": REPLAYS, "not_bitwise": diffs,
                         "max_diff": worst_d})
            bad += diffs
    print("replays " + json.dumps(rows), flush=True)

    # 3. the CPU against its first prefill, call by call
    out = []
    for i in range(CPU_PREFILLS):
        lg, trace = cpu_prefill()
        diff = (lg - runs[0]).abs()
        rec = {"run": i, "max_abs_err_vs_card": diff.max().item(),
               "element": int(diff.argmax()),
               "bitwise_equal_to_first": torch.equal(lg, ref)}
        for idx, ((name, _, args, _, got), (_, _, args0, _, want)) in \
                enumerate(zip(trace, base)):
            if not torch.equal(got, want):
                same_in = all(torch.equal(x, y) for x, y in zip(args, args0)
                              if isinstance(x, torch.Tensor))
                d = (got.float() - want.float()).abs()
                changed = (d.reshape(-1, d.shape[-1]) > 0).any(-1)
                rec["first_call_that_differs"] = {
                    "call": idx, "kind": name, "inputs_equal": same_in,
                    "shapes": [list(x.shape) for x in args
                               if isinstance(x, torch.Tensor)],
                    "elements_that_differ": int((d > 0).sum()),
                    "rows_that_differ": changed.nonzero()[:, 0].tolist()[:16],
                    "max_diff": d.max().item()}
                break
        bad += not rec["bitwise_equal_to_first"]
        out.append(rec)
    print("cpu " + json.dumps({"threads": 1, "mkl_cbwr": MKL_CBWR,
                               "mkl": torch.backends.mkl.is_available(),
                               "runs": out}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

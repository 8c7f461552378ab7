"""Quickstart of the PyTorch/CUDA port — the paper's core scenario end to
end, the counterpart of ``examples/quickstart.py``.

1. "Train" LeNet-5 server-side (seeded random weights stand in for Caffe
   training; the deploy pipeline is identical), convert and save the
   deployable model with ``repro_torch.core.deploy.save_model``.
2. Load it device-side (``load_model``: integrity, geometry and the plan
   verifier) and run the forward path over a batch of 16 frames (paper
   §6.2) under every execution method of the ladder, each through
   ``CNNEngine.forward_fn``.
3. Print each method's time a batch and its speedup over the sequential
   reference — a miniature of the paper's Table 3.  On the card the times
   are CUDA-event medians; on the CPU (``--device cpu``, the plain
   versions) host-clock means.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import statistics
import tempfile
import time

import torch

from repro_torch.core.deploy import load_model, save_model
from repro_torch.core.engine import CNNEngine
from repro_torch.core.methods import LADDER
from repro_torch.core.netdefs import NETWORKS
from repro_torch.kernels.common import resolve_device

REPS = 10


def time_ms(fn, dev) -> float:
    """Milliseconds a call: the median of ``REPS`` CUDA-event timings on
    the card, the host-clock mean elsewhere; after one warm-up call."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        return (time.perf_counter() - t0) / REPS * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # -- train side -------------------------------------------------------------
    net = NETWORKS["lenet5"]()
    params = CNNEngine(net, device="cpu").init(
        torch.Generator().manual_seed(0))
    with tempfile.TemporaryDirectory(prefix="cnndroid_model_") as path:
        save_model(path, net, params,
                   {"trained_with": "examples/quickstart_torch.py"})
        print(f"[deploy] saved {net.name} -> {path}")

        # -- device side ----------------------------------------------------------
        net2, params2, extra = load_model(path, device=dev)
    print(f"[deploy] loaded {net2.name} on {dev} (extra={extra})")
    x = torch.randn((16, *net2.input_shape),
                    generator=torch.Generator().manual_seed(1)).to(dev)

    clock = "CUDA-event median" if dev.type == "cuda" else "host-clock mean"
    print(f"\n{'method':20s} {'ms/batch':>10s} {'speedup':>9s}  "
          f"(vs §4.1 sequential; {clock} of {REPS})")
    base = None
    rows = {}
    for method in LADDER:
        fn = CNNEngine(net2, method=method, device=dev).forward_fn()
        ms = time_ms(lambda: fn(params2, x), dev)
        base = base or ms
        rows[method.value] = ms
        print(f"{method.value:20s} {ms:10.3f} {base / ms:8.2f}x")
    out = fn(params2, x)
    print(f"\npredictions: {out.argmax(-1).tolist()}")
    if dev.type == "cuda":
        print(f"[{torch.cuda.get_device_name(dev)}]")
    return rows


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--json PATH] [--ptxas]

Phases, each of which fails the run (non-zero exit, no result line):

1. card: the GPU's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 off for every plain and library call;
2. build: compile the kernels of ``src/repro_torch/csrc`` with nvcc
   (timed; ``--ptxas`` prints each kernel's registers and shared memory);
3. kernels: at every shape the engine's fused plan gives K1 (conv+pool
   [+LRN]), K2 (conv chain+pool) and K3 (fc matmul) for AlexNet, LeNet-5
   and the CIFAR-10 net, at batch 1 and 16, each kernel against its plain
   PyTorch version on the card (max abs <= 1e-4 * max(1, max|plain|)),
   then timed with CUDA events (median of 25 after warm-up) beside its
   plain version, one PyTorch library call as a yardstick and its bound;
4. engine: ``CNNEngine(net).forward`` on the card at batch 16 (paper
   §6.2) for AlexNet at full width, LeNet-5 and CIFAR-10, with seeded
   random weights carried in by ``params_from_numpy``: the launch
   counters must show K1/K2/K3 ran (2/1/3, 2/0/2, 3/0/2), the output must
   match the CPU engine on the same weights (max abs <= 1e-4, same
   argmax) and two runs must agree bit for bit; the forward is timed;
5. prints one JSON line ``{"kernels": [...]}`` (per kernel: the
   AlexNet batch-16 shapes summed, errors over every case);
6. prints ``{"ok": true, "device": {...}}`` as its last line.

Run it from the repository root; it needs one CUDA device and the CUDA
toolkit, and imports nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: published fp32 (CUDA cores, FMA = 2 operations) and memory peaks,
#: NVIDIA data sheets; matched against torch.cuda.get_device_name
PEAKS = (
    ("H100 PCIe", 51.2e12, 2.0e12),
    ("H100 NVL", 60.0e12, 3.9e12),
    ("H100", 66.9e12, 3.35e12),   # SXM5 80 GB
    ("H200", 66.9e12, 4.8e12),
)
SEED = 0
BATCHES = (1, 16)
ENGINE_BATCH = 16
EXPECTED_LAUNCHES = {  # K1, K2, K3 per forward of the fused plan
    "alexnet": (2, 1, 3), "lenet5": (2, 0, 2), "cifar10": (3, 0, 2)}
REPS = 25


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_peaks(name: str):
    for key, flops, bw in PEAKS:
        if key in name:
            return flops, bw
    fail(f"no published peaks known for {name!r}")


def time_ms(torch, fn, reps: int = REPS) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def he_params(shapes, rng):
    """Seeded He-normal weights and small random biases (numpy)."""
    import numpy as np

    params = {}
    for name, shp in shapes.items():
        conv = len(shp) == 4
        fan = int(np.prod(shp[1:])) if conv else shp[0]
        params[name] = {
            "w": (rng.standard_normal(shp) * np.sqrt(2.0 / fan)
                  ).astype(np.float32),
            "b": (0.05 * rng.standard_normal(shp[0] if conv else shp[1])
                  ).astype(np.float32)}
    return params


def kernel_cases(net, compile_plan):
    """One case per fused/chain/fc step of the net's fused plan, at each
    batch: (kernel id, step, batch)."""
    cases = []
    for step in compile_plan(net).steps:
        kid = {"fused": "K1", "chain": "K2", "fc": "K3"}.get(step.kind)
        if kid is not None:
            cases.extend((kid, step, n) for n in BATCHES)
    return cases


def run_case(torch, F, kid, step, n, params, dev, peaks):
    """Kernel vs plain version on the card, then times; returns a dict."""
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import lrn_ref
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    flops_peak, bw_peak = peaks
    if kid == "K3":
        p = params[step.spec.name]
        w, b = p["w"], p["b"]
        x = torch.randn((n, step.d_in), generator=gen, device=dev)
        act = "relu" if step.relu else "none"
        kernel = lambda: mm_ops.matmul_fused(x, w, b, act)  # noqa: E731
        plain = lambda: matmul_fused_ref(x, w, b, act)  # noqa: E731

        def library():
            y = torch.addmm(b, x, w)
            return y.relu_() if step.relu else y

        m, k = x.shape
        nn_ = w.shape[1]
        flops = 2.0 * m * k * nn_
        nbytes = 4.0 * (m * k + k * nn_ + nn_ + m * nn_)
    else:
        g = step.group
        convs = g.convs
        ws = [params[cv.name]["w"] for cv in convs]
        bs = [params[cv.name]["b"] for cv in convs]
        x = torch.randn((n, *step.in_shape), generator=gen, device=dev)
        pool = g.pool
        tail = dict(pool_kernel=pool.kernel, pool_stride=pool.stride,
                    pool_kind=pool.pool_kind, pool_relu=g.pool_relu)
        if g.lrn is not None:
            tail.update(lrn_n=g.lrn.lrn_n, lrn_alpha=g.lrn.lrn_alpha,
                        lrn_beta=g.lrn.lrn_beta, lrn_k=g.lrn.lrn_k)
        strides = [cv.stride for cv in convs]
        pads = [cv.padding for cv in convs]
        if kid == "K1":
            args = (x, ws[0], bs[0], strides[0], pads[0], g.relus[0])
            kernel = lambda: conv_ops.conv2d_pool_fused(*args, **tail)  # noqa
            plain = lambda: conv_ops.conv2d_pool_fused_ref(*args, **tail)  # noqa
        else:
            args = (x, ws, bs, strides, pads, g.relus)
            kernel = lambda: conv_ops.conv2d_chain(*args, **tail)  # noqa
            plain = lambda: conv_ops.conv2d_chain_ref(*args, **tail)  # noqa

        def library():
            y = x
            for w, b, s, p_, r in zip(ws, bs, strides, pads, g.relus):
                y = F.conv2d(y, w, b, stride=s, padding=p_)
                if r:
                    y = y.relu_()
            if pool.pool_kind == "max":
                y = F.max_pool2d(y, pool.kernel, pool.stride)
            else:
                y = F.avg_pool2d(y, pool.kernel, pool.stride)
            if g.pool_relu:
                y = y.relu_()
            if g.lrn is not None:
                y = lrn_ref(y, g.lrn.lrn_n, g.lrn.lrn_alpha, g.lrn.lrn_beta,
                            g.lrn.lrn_k)
            return y

        flops, nbytes = 0.0, 4.0 * (x.numel() + sum(t.numel() for t in ws)
                                    + sum(t.numel() for t in bs))
        c, h, w_ = step.in_shape
        for cv in convs:
            kh, kw = cv.kernel
            oh = (h + 2 * cv.padding[0] - kh) // cv.stride[0] + 1
            ow = (w_ + 2 * cv.padding[1] - kw) // cv.stride[1] + 1
            flops += 2.0 * n * cv.out_channels * oh * ow * c * kh * kw
            c, h, w_ = cv.out_channels, oh, ow
        oc, ph, pw = step.out_shape
        nbytes += 4.0 * n * oc * ph * pw
    ref = plain()
    out = kernel()
    torch.cuda.synchronize()
    if out.shape != ref.shape:
        fail(f"{kid} {step.names} n={n}: shape {tuple(out.shape)} != "
             f"{tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{kid} {step.names} n={n}: non-finite output")
    err = (out - ref).abs().max().item()
    tol = 1e-4 * max(1.0, ref.abs().max().item())
    if not err <= tol:
        fail(f"{kid} {step.names} n={n}: max abs err {err} > {tol}")
    lib_err = (library() - ref).abs().max().item()
    return {
        "kernel": kid, "batch": n, "max_abs_err": err, "tol": tol,
        "library_max_abs_err": lib_err,
        "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
        "library_ms": time_ms(torch, library),
        "bound_ms": 1e3 * max(flops / flops_peak, nbytes / bw_peak),
        "bound_by": "operations" if flops / flops_peak > nbytes / bw_peak
        else "bytes",
        "flops": flops, "bytes": nbytes,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", help="also write every case's numbers here")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register/shared-memory report")
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the repository root")
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.core.deploy import params_from_numpy
    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.core.plan import compile_plan, infer_param_shapes
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops

    # -- 1. card ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind} sms "
          f"{torch.cuda.get_device_properties(0).multi_processor_count}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    peaks = card_peaks(kind)
    dev = torch.device("cuda")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds:.1f} s)", flush=True)
    if args.ptxas:
        print(_build.build_log, flush=True)

    counters = {"K1": conv_ops.conv2d_pool_fused, "K2": conv_ops.conv2d_chain,
                "K3": mm_ops.matmul_fused}
    sources = {
        "K1": ("conv_pool_lrn", "src/repro_torch/csrc/conv_pool_lrn.cu",
               "src/repro/kernels/conv2d/kernels.py:649"),
        "K2": ("conv_chain", "src/repro_torch/csrc/conv_chain.cu",
               "src/repro/kernels/conv2d/kernels.py:1103"),
        "K3": ("matmul_fused", "src/repro_torch/csrc/matmul_fused.cu",
               "src/repro/kernels/matmul_fused/kernel.py:37"),
    }
    nets = {name: NETWORKS[name]() for name in ("alexnet", "lenet5",
                                                "cifar10")}
    rng = np.random.default_rng(SEED)
    np_params = {name: he_params(infer_param_shapes(net), rng)
                 for name, net in nets.items()}

    # -- 3. kernels against their plain versions, timed ---------------------
    cases = []
    for name, net in nets.items():
        params = params_from_numpy(np_params[name], dev)
        for kid, step, n in kernel_cases(net, compile_plan):
            r = run_case(torch, F, kid, step, n, params, dev, peaks)
            r.update(net=name, step="+".join(step.names))
            cases.append(r)
            print("case " + json.dumps(r), flush=True)

    # -- 4. the engine on the card ------------------------------------------
    engine_rows = {}
    for name, net in nets.items():
        eng = CNNEngine(net)
        params = params_from_numpy(np_params[name], dev)
        x_np = rng.standard_normal((ENGINE_BATCH, *net.input_shape)
                                   ).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        for fn in counters.values():
            fn.launches = 0
        y = eng.forward(params, x)
        torch.cuda.synchronize()
        launches = tuple(counters[k].launches for k in ("K1", "K2", "K3"))
        if launches != EXPECTED_LAUNCHES[name]:
            fail(f"{name}: launches K1/K2/K3 {launches}, expected "
                 f"{EXPECTED_LAUNCHES[name]}")
        if tuple(y.shape) != (ENGINE_BATCH, net.num_classes):
            fail(f"{name}: output shape {tuple(y.shape)}")
        if not torch.isfinite(y).all():
            fail(f"{name}: non-finite output")
        cpu_eng = CNNEngine(net, device="cpu")
        y_cpu = cpu_eng.forward(params_from_numpy(np_params[name], "cpu"),
                                x_np)
        err = (y.cpu() - y_cpu).abs().max().item()
        if not err <= 1e-4:
            fail(f"{name}: engine max abs err vs CPU {err} > 1e-4")
        if not torch.equal(y.argmax(-1).cpu(), y_cpu.argmax(-1)):
            fail(f"{name}: argmax differs from the CPU engine")
        y2 = eng.forward(params, x)
        y3 = eng.forward(params, x)
        if not (torch.equal(y, y2) and torch.equal(y2, y3)):
            fail(f"{name}: repeated forwards differ")
        ms = time_ms(torch, lambda: eng.forward(params, x))
        t0 = time.perf_counter()
        for _ in range(10):
            eng.forward(params, x)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 100.0
        engine_rows[name] = {"batch": ENGINE_BATCH, "forward_ms": ms,
                             "host_forward_ms": host_ms,
                             "launches": dict(zip(("K1", "K2", "K3"),
                                                  launches)),
                             "max_abs_err_vs_cpu": err}
        print(f"engine {name} batch {ENGINE_BATCH}: forward {ms:.3f} ms "
              f"(event median), {host_ms:.3f} ms (host clock), launches "
              f"K1/K2/K3 {launches}, max abs err vs CPU {err:.3g}",
              flush=True)

    # -- 5. the kernels line ------------------------------------------------
    kernels = []
    for kid, (name, src, replaces) in sources.items():
        mine = [c for c in cases if c["kernel"] == kid]
        main = [c for c in mine if c["net"] == "alexnet"
                and c["batch"] == ENGINE_BATCH]
        fl = sum(c["flops"] for c in main)
        by = sum(c["bytes"] for c in main)
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": engine_rows["alexnet"]["launches"][kid],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": sum(c["ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": 1e3 * max(fl / peaks[0], by / peaks[1]),
            "bound_by": "operations" if fl / peaks[0] > by / peaks[1]
            else "bytes",
            "library_ms": sum(c["library_ms"] for c in main),
        })
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card_line, "kind": kind, "torch": torch.__version__,
             "cuda": torch.version.cuda, "build_log": _build.build_log,
             "cases": cases, "engine": engine_rows, "kernels": kernels},
            indent=1))
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--json PATH] [--ptxas]

Phases, each of which fails the run (non-zero exit, no result line):

1. card: the GPU's name and power limit (``nvidia-smi``), torch and CUDA
   versions; TF32 off for every plain and library call;
2. build: compile the kernels of ``src/repro_torch/csrc`` with nvcc
   (timed; ``--ptxas`` prints each kernel's registers and shared memory);
3. kernels: every step that reaches a kernel in the plans of the rungs of
   phase 4 for AlexNet, LeNet-5 and the CIFAR-10 net, at batch 1 and 16 —
   K1 (fused conv+pool[+LRN] and the per-layer advanced SIMD conv), K2
   (conv chain+pool), K3 (fc matmul), K7 (fused and per-layer basic SIMD
   conv), K8 (basic parallel conv), K9 (standalone pool) — each kernel
   against its plain PyTorch version on the card (max abs <= 1e-4 *
   max(1, max|plain|)), then timed with CUDA events (median of 25 after
   warm-up) beside its plain version, one PyTorch library call as a
   yardstick and its bound;
4. engine: ``CNNEngine(net, method=..., fuse_pool=...).forward`` on the
   card at batch 16 (paper §6.2) on six rungs — ``advanced_simd_8`` fused
   and unfused, ``basic_simd`` fused and unfused, ``basic_parallel``,
   ``seq_ref`` — for AlexNet at full width, LeNet-5 and CIFAR-10, with
   seeded random weights carried in by ``params_from_numpy``: each
   forward is run with the launch counters set to 0 just before it and
   read just after, and they must equal ``EXPECTED_LAUNCHES``; the output
   must match the CPU engine at the same rung on the same weights (max
   abs <= 1e-4, same argmax) and two more runs must agree bit for bit; the
   forward is timed;
5. serving: ``CNNServer`` over full-width AlexNet on the card
   (``max_batch=16``, a fake clock, the default degradation ladder with
   ``queue_high=0, degrade_after=1, cooldown=0``) takes ragged waves of
   16, 5, 1, 3 and 16 seeded frames.  A wave below ``max_batch`` waits one
   step in the queue, which is pressure, so the ladder moves one rung down
   before the wave is served: the waves are served on
   ``advanced_simd_8/fused``, ``advanced_simd_4/fused``,
   ``basic_simd/fused`` and twice ``basic_simd/unfused``, in buckets 16,
   8, 1, 4 and 16.  Every result's top-5 must equal the CPU engine's at
   that rung (probabilities within 1e-4), the bucket cache must stay
   within ``log2(16)+1`` compiles, the counters must show every kernel of
   the ladder ran, and a ``FaultScript`` poisoning one request of a batch
   of 16 must leave the 15 survivors' whole probability rows
   byte-identical to the fault-free run (on the top and the bottom rung);
6. prints one JSON line ``{"kernels": [...]}``: per kernel, ``launches``
   is its count summed over phase 4's AlexNet forwards (each counted from
   0), the times and bound are summed over its distinct AlexNet batch-16
   shapes, the error is the largest over every case;
7. prints ``{"ok": true, "device": {...}}`` as its last line.

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
KERNELS = ("K1", "K2", "K3", "K7", "K8", "K9")
#: the rungs of phase 4: (method, fuse_pool); seq_ref and basic_parallel
#: never fuse, so they run once, at the engine's default fuse_pool
RUNGS = (("advanced_simd_8", True), ("advanced_simd_8", False),
         ("basic_simd", True), ("basic_simd", False),
         ("basic_parallel", True), ("seq_ref", True))
#: launches of K1, K2, K3, K7, K8, K9 per forward, per rung
EXPECTED_LAUNCHES = {
    "alexnet": dict(zip(RUNGS, (
        (2, 1, 3, 0, 0, 0), (5, 0, 3, 0, 0, 3), (0, 1, 3, 2, 0, 0),
        (0, 0, 3, 5, 0, 3), (0, 0, 3, 0, 5, 3), (0, 0, 0, 0, 0, 3)))),
    "lenet5": dict(zip(RUNGS, (
        (2, 0, 2, 0, 0, 0), (2, 0, 2, 0, 0, 2), (0, 0, 2, 2, 0, 0),
        (0, 0, 2, 2, 0, 2), (0, 0, 2, 0, 2, 2), (0, 0, 0, 0, 0, 2)))),
    "cifar10": dict(zip(RUNGS, (
        (3, 0, 2, 0, 0, 0), (3, 0, 2, 0, 0, 3), (0, 0, 2, 3, 0, 0),
        (0, 0, 2, 3, 0, 3), (0, 0, 2, 0, 3, 3), (0, 0, 0, 0, 0, 3)))),
}
#: serving phase: wave sizes, and the rung each wave is served on
WAVES = (16, 5, 1, 3, 16)
WAVE_RUNGS = ("advanced_simd_8/fused", "advanced_simd_4/fused",
              "basic_simd/fused", "basic_simd/unfused", "basic_simd/unfused")
MAX_BATCH = 16
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


def kernel_cases(net, compile_plan, Method):
    """One case per distinct step of the phase-4 rungs' plans that reaches
    a kernel, at each batch: (kernel id, step, batch)."""
    kinds = {  # (method, fuse) -> {step kind: kernel id}
        ("advanced_simd_8", True): {"fused": "K1", "chain": "K2",
                                    "fc": "K3"},
        ("advanced_simd_8", False): {"conv": "K1", "pool": "K9"},
        ("basic_simd", True): {"fused": "K7", "chain": "K2"},
        ("basic_simd", False): {"conv": "K7", "pool": "K9"},
        ("basic_parallel", True): {"conv": "K8", "pool": "K9"},
    }
    cases, seen = [], set()
    for (method, fuse), kid_of in kinds.items():
        for step in compile_plan(net, method=Method(method),
                                 fuse=fuse).steps:
            kid = kid_of.get(step.kind)
            key = (kid, step.kind, step.names)
            if kid is None or key in seen:
                continue
            seen.add(key)
            cases.extend((kid, step, n) for n in BATCHES)
    return cases


def _conv_flops(n, in_shape, convs):
    flops = 0.0
    c, h, w = in_shape
    for cv in convs:
        kh, kw = cv.kernel
        oh = (h + 2 * cv.padding[0] - kh) // cv.stride[0] + 1
        ow = (w + 2 * cv.padding[1] - kw) // cv.stride[1] + 1
        flops += 2.0 * n * cv.out_channels * oh * ow * c * kh * kw
        c, h, w = cv.out_channels, oh, ow
    return flops


def run_case(torch, F, kid, step, n, params, dev, peaks):
    """Kernel vs plain version on the card, then times; returns a dict."""
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.conv2d.ref import (
        conv2d_basic_parallel_ref,
        conv2d_basic_simd_ref,
        lrn_ref,
    )
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.matmul_fused.ref import matmul_fused_ref
    from repro_torch.kernels.pool2d.ops import pool2d
    from repro_torch.kernels.pool2d.ref import pool2d_ref

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
    elif kid == "K9":
        spec = step.spec
        x = torch.randn((n, *step.in_shape), generator=gen, device=dev)
        args = (x, spec.kernel, spec.stride, spec.pool_kind,
                spec.relu or step.relu)
        kernel = lambda: pool2d(*args)  # noqa: E731
        plain = lambda: pool2d_ref(*args)  # noqa: E731

        def library():
            pool = F.max_pool2d if spec.pool_kind == "max" else F.avg_pool2d
            y = pool(x, spec.kernel, spec.stride)
            return y.relu_() if args[-1] else y

        c, oh, ow = step.out_shape
        flops = float(n * c * oh * ow * spec.kernel[0] * spec.kernel[1])
        nbytes = 4.0 * (x.numel() + n * c * oh * ow)
    else:
        if step.kind == "conv":    # per-layer conv: K1, K7 or K8
            convs, relus, pool, g = (step.spec,), (step.relu,), None, None
        else:                      # fused group or chain: K1, K2 or K7
            g = step.group
            convs, relus, pool = g.convs, g.relus, g.pool
        ws = [params[cv.name]["w"] for cv in convs]
        bs = [params[cv.name]["b"] for cv in convs]
        x = torch.randn((n, *step.in_shape), generator=gen, device=dev)
        strides = [cv.stride for cv in convs]
        pads = [cv.padding for cv in convs]
        tail = {}
        if pool is not None:
            tail = dict(pool_kernel=pool.kernel, pool_stride=pool.stride,
                        pool_kind=pool.pool_kind, pool_relu=g.pool_relu)
            if g.lrn is not None:
                tail.update(lrn_n=g.lrn.lrn_n, lrn_alpha=g.lrn.lrn_alpha,
                            lrn_beta=g.lrn.lrn_beta, lrn_k=g.lrn.lrn_k)
        one = (x, ws[0], bs[0], strides[0], pads[0], relus[0])
        if kid == "K1":
            kernel = lambda: conv_ops.conv2d_pool_fused(*one, **tail)  # noqa
            plain = lambda: conv_ops.conv2d_pool_fused_ref(*one, **tail)  # noqa
        elif kid == "K7":
            kernel = lambda: conv_ops.conv2d_basic_simd(*one, **tail)  # noqa
            plain = lambda: conv2d_basic_simd_ref(*one, **tail)  # noqa
        elif kid == "K8":
            kernel = lambda: conv_ops.conv2d_basic_parallel(*one)  # noqa
            plain = lambda: conv2d_basic_parallel_ref(*one)  # noqa
        else:
            args = (x, ws, bs, strides, pads, relus)
            kernel = lambda: conv_ops.conv2d_chain(*args, **tail)  # noqa
            plain = lambda: conv_ops.conv2d_chain_ref(*args, **tail)  # noqa

        def library():
            y = x
            for w, b, s, p_, r in zip(ws, bs, strides, pads, relus):
                y = F.conv2d(y, w, b, stride=s, padding=p_)
                if r:
                    y = y.relu_()
            if pool is None:
                return y
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

        flops = _conv_flops(n, step.in_shape, convs)
        oc, ph, pw = step.out_shape
        nbytes = 4.0 * (x.numel() + sum(t.numel() for t in ws)
                        + sum(t.numel() for t in bs) + n * oc * ph * pw)
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
    if not torch.equal(kernel(), out):
        fail(f"{kid} {step.names} n={n}: a repeated launch differs")
    lib_err = (library() - ref).abs().max().item()
    return {
        "kernel": kid, "kind": step.kind, "batch": n, "max_abs_err": err,
        "tol": tol, "library_max_abs_err": lib_err,
        "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
        "library_ms": time_ms(torch, library),
        "bound_ms": 1e3 * max(flops / flops_peak, nbytes / bw_peak),
        "bound_by": "operations" if flops / flops_peak > nbytes / bw_peak
        else "bytes",
        "flops": flops, "bytes": nbytes,
    }


class FakeClock:
    """The serving phase's clock: time moves only when told to, so the
    server's event trail is deterministic."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def serving_phase(torch, np, net, np_params, rng, dev, counters):
    """Phase 5 (see the module docstring); returns its record."""
    from repro_torch.core.deploy import params_from_numpy
    from repro_torch.core.engine import CNNEngine
    from repro_torch.core.methods import Method
    from repro_torch.serving import (CNNServer, DegradeController,
                                     FailedResult, FaultInjector, FaultScript,
                                     ImageRequest, ImageResult, default_ladder)

    params = params_from_numpy(np_params, dev)
    cpu_params = params_from_numpy(np_params, "cpu")
    frames = rng.standard_normal((sum(WAVES), *net.input_shape)
                                 ).astype(np.float32)
    eng = CNNEngine(net)
    srv = CNNServer(eng, params, max_batch=MAX_BATCH, max_delay_s=1.0,
                    clock=FakeClock(), sleep=lambda s: None,
                    degrade=DegradeController(default_ladder(), queue_high=0,
                                              degrade_after=1, cooldown=0))
    for fn in counters.values():
        fn.launches = 0
    waves, rid = [], 0
    for size in WAVES:
        for r in range(rid, rid + size):
            srv.submit(ImageRequest(rid=r, image=frames[r], top_k=5))
        if size < MAX_BATCH and srv.step() != []:
            fail(f"serving: a wave of {size} was served before it waited")
        rung = (eng.method, eng.fuse_pool)
        label = srv.health()["degrade"]["label"]
        t0 = time.perf_counter()
        served = srv.step(force=True)
        host_ms = (time.perf_counter() - t0) * 1e3
        if (len(served) != size
                or not all(isinstance(r, ImageResult) for r in served)):
            fail(f"serving: wave of {size} on {label} served {served!r}")
        stats = eng.bucket_stats()
        per_fuse = max(sum(1 for f, _ in stats["buckets"] if f == fuse)
                       for fuse in (True, False))
        if stats["compiles"] > MAX_BATCH.bit_length() or per_fuse > 5:
            fail(f"serving: bucket cache {stats}")
        waves.append({"size": size, "rung": label, "rung_key": rung,
                      "bucket": served[0].bucket, "host_ms": host_ms,
                      "rids": list(range(rid, rid + size))})
        rid += size
    launches = {k: counters[k].launches for k in KERNELS}
    if [w["rung"] for w in waves] != list(WAVE_RUNGS):
        fail(f"serving: rungs {[w['rung'] for w in waves]}, expected "
             f"{list(WAVE_RUNGS)}")
    for k in ("K1", "K2", "K3", "K7", "K9"):
        if launches[k] < 1:
            fail(f"serving: {k} never launched ({launches})")
    worst = 0.0
    for w in waves:
        method, fuse = w.pop("rung_key")
        cpu = CNNEngine(net, method=method, fuse_pool=fuse, device="cpu")
        probs = cpu.forward(cpu_params, frames[w["rids"]]).numpy()
        for r, p in zip(w["rids"], probs):
            res = srv.done[r]
            top = [int(j) for j in np.argsort(-p, kind="stable")[:5]]
            if res.top_indices != top:
                fail(f"serving: rid {r} top-5 {res.top_indices} != CPU {top}")
            err = float(np.abs(np.asarray(res.top_probs) - p[top]).max())
            worst = max(worst, err)
            if not err <= 1e-4:
                fail(f"serving: rid {r} probabilities differ by {err}")
    # bisection on the card: survivors keep the parent's bucket and bits
    poison_rid = 6
    bisect = {}
    for method, fuse in ((Method.ADVANCED_SIMD_8, True),
                         (Method.BASIC_SIMD, False)):
        e2 = CNNEngine(net, method=method, fuse_pool=fuse)
        runs = []
        for script in (FaultScript(), FaultScript(poison_rids={poison_rid})):
            s2 = CNNServer(e2, params, max_batch=MAX_BATCH, max_delay_s=0.0,
                           clock=FakeClock(), sleep=lambda s: None,
                           fault_injector=FaultInjector(script))
            for r in range(MAX_BATCH):
                s2.submit(ImageRequest(rid=r, image=frames[r],
                                       top_k=net.num_classes))
            s2.run_until_drained()
            runs.append(s2)
        clean, faulty = runs
        failed = [r for r, v in faulty.done.items()
                  if isinstance(v, FailedResult)]
        if failed != [poison_rid]:
            fail(f"serving: bisection failed {failed}, expected "
                 f"[{poison_rid}]")
        for r in range(MAX_BATCH):
            if r == poison_rid:
                continue
            a, b = faulty.done[r], clean.done[r]
            if (a.bucket != MAX_BATCH or a.top_probs != b.top_probs
                    or a.top_indices != b.top_indices):
                fail(f"serving: survivor {r} on {method.value} differs from "
                     f"the fault-free run")
        bisect[f"{method.value}/{'fused' if fuse else 'unfused'}"] = {
            "bisections": faulty.stats()["bisections"],
            "engine_calls": faulty.fault_injector.calls}
    return {"waves": [{k: v for k, v in w.items() if k != "rids"}
                      for w in waves],
            "launches": launches, "stats": srv.stats(),
            "events": [e["kind"] for e in srv.events],
            "max_prob_err_vs_cpu": worst, "bisection": bisect}


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
    from repro_torch.core.methods import Method
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.core.plan import compile_plan, infer_param_shapes
    from repro_torch.kernels import _build
    from repro_torch.kernels.conv2d import ops as conv_ops
    from repro_torch.kernels.matmul_fused import ops as mm_ops
    from repro_torch.kernels.pool2d import ops as pool_ops

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
                "K3": mm_ops.matmul_fused, "K7": conv_ops.conv2d_basic_simd,
                "K8": conv_ops.conv2d_basic_parallel, "K9": pool_ops.pool2d}
    sources = {
        "K1": ("conv_pool_lrn", "src/repro_torch/csrc/conv_pool_lrn.cu",
               "src/repro/kernels/conv2d/kernels.py:649"),
        "K2": ("conv_chain", "src/repro_torch/csrc/conv_chain.cu",
               "src/repro/kernels/conv2d/kernels.py:1103"),
        "K3": ("matmul_fused", "src/repro_torch/csrc/matmul_fused.cu",
               "src/repro/kernels/matmul_fused/kernel.py:37"),
        "K7": ("conv_basic_simd", "src/repro_torch/csrc/conv_basic_simd.cu",
               "src/repro/kernels/conv2d/kernels.py:555"),
        "K8": ("conv_basic_parallel",
               "src/repro_torch/csrc/conv_basic_parallel.cu",
               "src/repro/kernels/conv2d/kernels.py:376"),
        "K9": ("pool2d", "src/repro_torch/csrc/pool2d.cu",
               "src/repro/kernels/pool2d/kernels.py:84"),
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
        for kid, step, n in kernel_cases(net, compile_plan, Method):
            r = run_case(torch, F, kid, step, n, params, dev, peaks)
            r.update(net=name, step="+".join(step.names))
            cases.append(r)
            print("case " + json.dumps(r), flush=True)

    # -- 4. the engine on the card, every rung -------------------------------
    engine_rows = []
    for name, net in nets.items():
        params = params_from_numpy(np_params[name], dev)
        cpu_params = params_from_numpy(np_params[name], "cpu")
        x_np = rng.standard_normal((ENGINE_BATCH, *net.input_shape)
                                   ).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        for method, fuse in RUNGS:
            label = f"{name} {method}/{'fused' if fuse else 'unfused'}"
            eng = CNNEngine(net, method=Method(method), fuse_pool=fuse)
            for fn in counters.values():
                fn.launches = 0
            y = eng.forward(params, x)
            torch.cuda.synchronize()
            launches = tuple(counters[k].launches for k in KERNELS)
            want = EXPECTED_LAUNCHES[name][(method, fuse)]
            if launches != want:
                fail(f"{label}: launches {dict(zip(KERNELS, launches))}, "
                     f"expected {dict(zip(KERNELS, want))}")
            if tuple(y.shape) != (ENGINE_BATCH, net.num_classes):
                fail(f"{label}: output shape {tuple(y.shape)}")
            if not torch.isfinite(y).all():
                fail(f"{label}: non-finite output")
            y_cpu = CNNEngine(net, method=Method(method), fuse_pool=fuse,
                              device="cpu").forward(cpu_params, x_np)
            err = (y.cpu() - y_cpu).abs().max().item()
            if not err <= 1e-4:
                fail(f"{label}: engine max abs err vs CPU {err} > 1e-4")
            if not torch.equal(y.argmax(-1).cpu(), y_cpu.argmax(-1)):
                fail(f"{label}: argmax differs from the CPU engine")
            y2 = eng.forward(params, x)
            y3 = eng.forward(params, x)
            if not (torch.equal(y, y2) and torch.equal(y2, y3)):
                fail(f"{label}: repeated forwards differ")
            ms = time_ms(torch, lambda: eng.forward(params, x))
            t0 = time.perf_counter()
            for _ in range(10):
                eng.forward(params, x)
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 100.0
            engine_rows.append({
                "net": name, "method": method, "fuse": fuse,
                "batch": ENGINE_BATCH, "forward_ms": ms,
                "host_forward_ms": host_ms,
                "launches": dict(zip(KERNELS, launches)),
                "max_abs_err_vs_cpu": err})
            print(f"engine {label} batch {ENGINE_BATCH}: forward {ms:.3f} ms "
                  f"(event median), {host_ms:.3f} ms (host clock), launches "
                  f"{dict(zip(KERNELS, launches))}, max abs err vs CPU "
                  f"{err:.3g}", flush=True)

    # -- 5. serving: CNNServer walks the degradation ladder -----------------
    serving = serving_phase(torch, np, nets["alexnet"], np_params["alexnet"],
                            rng, dev, counters)
    print("serving " + json.dumps(serving), flush=True)

    # -- 6. the kernels line ------------------------------------------------
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
            "launches": sum(r["launches"][kid] for r in engine_rows
                            if r["net"] == "alexnet"),
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": sum(c["ms"] for c in main),
            "plain_ms": sum(c["plain_ms"] for c in main),
            "bound_ms": 1e3 * max(fl / peaks[0], by / peaks[1]),
            "bound_by": "operations" if fl / peaks[0] > by / peaks[1]
            else "bytes",
            "library_ms": sum(c["library_ms"] for c in main),
        })
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} never launched on the main path")
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": card_line, "kind": kind, "torch": torch.__version__,
             "cuda": torch.version.cuda, "build_log": _build.build_log,
             "cases": cases, "engine": engine_rows, "serving": serving,
             "kernels": kernels}, indent=1))
    print(card_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

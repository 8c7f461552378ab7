"""K11 (WKV6) and K9 (standalone pool) on the card, for one source tree.

    python3 tools/k11_k9_probe.py [--src PATH] [--label NAME] [--profile]

Imports ``repro_torch`` from ``--src`` (default: this checkout's
``src``), so a parent tree unpacked beside the checkout is timed by the
same code; builds its kernels, then:

- K11 at ``chip_smoke.K11_CASES`` (b 1, 32 heads of 64, chunks of 64;
  every case the tree's wrapper takes): o and the final state against the
  plain version on the card within ``LM_KERNEL_TOL``, a repeat bit for
  bit, then the event time (``time_ms``), the device time a call (20
  calls captured in a CUDA graph and replayed, ``stream_device_ms``) and
  the host time a call (``host_call_ms``);
- K9 at the pools of phase 3 (AlexNet, LeNet-5, CIFAR-10's unfused plans,
  batch 1 and 16): within 1e-4 * max(1, max|plain|) of the plain version,
  then the same three times beside ``F.max_pool2d`` / ``F.avg_pool2d``'s
  event and device time.

Prints the card (``nvidia-smi --query-gpu=name,power.limit``), then one
JSON line a case; exits 1 if a case is wrong.  A device time that the
tree's wrapper cannot give (a launch that refuses stream capture) is
null, with the error beside it.  Needs one CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="change")
    ap.add_argument("--ptxas", action="store_true",
                    help="print nvcc's register/shared-memory report")
    ap.add_argument("--profile", action="store_true",
                    help="also trace 10 calls of each K11 case with "
                    "torch.profiler: device time a call by kernel")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as F

    import chip_smoke as smoke
    from repro_torch.core.methods import Method
    from repro_torch.core.netdefs import NETWORKS
    from repro_torch.core.plan import compile_plan
    from repro_torch.kernels import _build
    from repro_torch.kernels.pool2d.ops import pool2d
    from repro_torch.kernels.pool2d.ref import pool2d_ref
    from repro_torch.kernels.wkv6.ops import wkv6
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.library()
    if args.ptxas:
        print(_build.build_log, flush=True)
    bad = 0

    def times(fn):
        out = {"ms": smoke.time_ms(torch, fn),
               "host_ms": smoke.host_call_ms(torch, fn)}
        try:  # a wrapper that makes a runtime call may refuse capture
            out["device_ms"] = smoke.stream_device_ms(torch, fn)
        except RuntimeError as e:
            out["device_ms"], out["capture_error"] = None, str(e)[:200]
            torch.cuda.synchronize()
        return out

    def by_kernel(fn, calls=10):
        """Device ms a call of each CUDA kernel ``fn`` launches."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return {e.key[:60]: e.self_device_time_total / 1e3 / calls
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0}

    def emit(rec):
        rec.update(label=args.label, card=card)
        print("case " + json.dumps(rec), flush=True)

    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    nets = {name: NETWORKS[name]() for name in ("alexnet", "lenet5",
                                                "cifar10")}
    for s, dname, decay in smoke.K11_CASES:
        mean, std = smoke.K11_DECAYS[decay]
        shape = (1, s, smoke.K11_HEADS, 64)
        dt = getattr(torch, dname)
        r, k, v = (torch.randn(shape, generator=gen, device=dev).to(dt)
                   for _ in range(3))
        logw = -torch.exp(mean + std * torch.randn(
            shape, generator=gen, device=dev))
        u = 0.5 * torch.randn((smoke.K11_HEADS, 64), generator=gen,
                              device=dev)
        kernel = lambda: wkv6(r, k, v, logw, u, chunk=64)  # noqa: E731
        ref_o, ref_s = wkv6_chunked_ref(r, k, v, logw, u, 64)
        out_o, out_s = kernel()
        torch.cuda.synchronize()
        rtol, atol = smoke.LM_KERNEL_TOL[dname]
        s_rtol, s_atol = smoke.LM_KERNEL_TOL["float32"]
        ok_o = bool(((out_o.float() - ref_o.float()).abs()
                     <= rtol * ref_o.float().abs() + atol).all())
        ok_s = bool(((out_s - ref_s).abs()
                     <= s_rtol * ref_s.abs() + s_atol).all())
        again = kernel()
        same = (torch.equal(again[0], out_o)
                and torch.equal(again[1], out_s))
        bad += not (ok_o and ok_s and same)
        emit({"kernel": "K11", "tokens": s, "dtype": dname,
              "decays": decay, "o_within_tol": ok_o,
              "state_within_tol": ok_s, "repeat_bitwise": same,
              "max_abs_err": (out_o.float() - ref_o.float()).abs().max()
              .item(), **times(kernel),
              **({"by_kernel": by_kernel(kernel)} if args.profile
                 else {})})
    for name, net in nets.items():
        for kid, step, n in smoke.kernel_cases(net, compile_plan,
                                               Method):
            if kid != "K9":
                continue
            sp = step.spec
            x = torch.randn((n, *step.in_shape), generator=gen,
                            device=dev)
            relu = bool(sp.relu or step.relu)
            a = (x, sp.kernel, sp.stride, sp.pool_kind, relu)
            kernel = lambda: pool2d(*a)  # noqa: E731
            pool = F.max_pool2d if sp.pool_kind == "max" else F.avg_pool2d

            def library():
                y = pool(x, sp.kernel, sp.stride)
                return y.relu_() if relu else y

            ref = pool2d_ref(*a)
            out = kernel()
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ok = err <= 1e-4 * max(1.0, ref.abs().max().item())
            same = torch.equal(kernel(), out)
            bad += not (ok and same)
            lib = times(library)
            emit({"kernel": "K9", "net": name,
                  "step": "+".join(step.names), "batch": n,
                  "kind": sp.pool_kind, "max_abs_err": err,
                  "within_tol": ok, "repeat_bitwise": same,
                  **times(kernel), "library_ms": lib["ms"],
                  "library_device_ms": lib["device_ms"],
                  "library_host_ms": lib["host_ms"]})
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

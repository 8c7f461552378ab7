"""The compute-sanitizer tool (``repro_torch.tools.sanitize``) on the CPU:
its reading of recorded reports, written by hand in the tool's documented
format (NVIDIA compute-sanitizer's memcheck, initcheck, racecheck and
synccheck records: a ``=========`` line opening a record, indented lines
continuing it, a summary line at the end), and its exit code 2 when the
binary is absent.  The case runner launches kernels and needs the card."""
import json
import re

import pytest

from repro_torch.analysis.findings import RULES, Finding
from repro_torch.kernels import _build
from repro_torch.tools import sanitize

BANNER = "========= COMPUTE-SANITIZER\n"


def _ran(case, units):
    return f"{sanitize.RAN_MARK}{case} {json.dumps(units)}\n"


MEMCHECK = (
    BANNER
    + "SANITIZE-CASE lenet5/advanced_simd_8/fused\n"
    + "========= Invalid __global__ write of size 4 bytes\n"
    "=========     at 0x1d0 in /repo/src/repro_torch/csrc/pool2d.cu:55:"
    "(anonymous namespace)::pool2d_kernel<3, 3>(const float *, float *, "
    "int, int, int, int, int, int, int, int, int, int, int, int)\n"
    "=========     by thread (4,0,0) in block (17,0,0)\n"
    "=========     Address 0x7f3a5c000200 is out of bounds\n"
    "=========     Host Frame: [0x2f1b9d] in libcuda.so.1\n"
    "=========\n"
    + _ran("lenet5/advanced_simd_8/fused", ["K1", "K9", "K3/stream"])
    + "SANITIZE-CASE k3/bf16/m4\n"
    + "========= Program hit cudaErrorInvalidValue (error 1) due to "
    "\"invalid argument\" on CUDA API call to cudaFuncGetAttributes.\n"
    + _ran("k3/bf16/m4", ["K3/stream"])
    + "========= ERROR SUMMARY: 1 error\n")

INITCHECK = (
    BANNER
    + "SANITIZE-CASE alexnet/advanced_simd_8/fused/b1\n"
    + "========= Uninitialized __global__ memory read of size 4 bytes\n"
    "=========     at stage_major_kernel(cnnk::Geo, cnnk::Plan, const float "
    "*, float *, float *)+0x3a70 in conv_stage_major.cuh:312\n"
    "=========     by thread (3,0,0) in block (200,0,0)\n"
    "=========\n"
    + _ran("alexnet/advanced_simd_8/fused/b1", ["K1", "K2", "K3/stream"])
    + "========= ERROR SUMMARY: 1 error\n")

RACECHECK = (
    BANNER
    + "SANITIZE-CASE k10/bfloat16/256\n"
    + _ran("k10/bfloat16/256", ["K10/wgmma"])
    + "SANITIZE-CASE k11/bfloat16/256\n"
    + "========= Error: Race reported between Write access at "
    "wkv6_walk(float *, const float *, int, int)+0x8b0 in wkv6.cu:301\n"
    "=========     and Read access at wkv6_walk(float *, const float *, "
    "int, int)+0x930 in wkv6.cu:305 [128 hazards]\n"
    "=========\n"
    + _ran("k11/bfloat16/256", ["K11"])
    + "========= RACECHECK SUMMARY: 1 hazard displayed (1 error, 0 "
    "warnings)\n")

SYNCCHECK_FAILED = (
    BANNER
    + "SANITIZE-CASE lenet5/basic_simd/fused\n"
    + "========= Error: Target application terminated before first "
    "instrumented API call\n")


def test_memcheck_report():
    findings, completed, ran = sanitize.parse_report("memcheck", MEMCHECK)
    assert completed and [c for c, _ in ran] == [
        "lenet5/advanced_simd_8/fused", "k3/bf16/m4"]
    errors = [f for f in findings if f.severity == "error"]
    assert [(f.rule, f.step) for f in errors] == [
        ("K101", "memcheck:lenet5/advanced_simd_8/fused:pool2d_kernel")]
    assert "Invalid __global__ write" in errors[0].detail
    info = [f for f in findings if f.severity == "info"]
    assert [f.rule for f in info] == ["K100"]
    assert "cudaErrorInvalidValue" in info[0].detail


def test_initcheck_report():
    findings, completed, _ = sanitize.parse_report("initcheck", INITCHECK)
    assert completed
    assert [(f.severity, f.rule, f.step) for f in findings] == [
        ("error", "K102",
         "initcheck:alexnet/advanced_simd_8/fused/b1:stage_major_kernel")]


def test_racecheck_report_and_the_async_proxy():
    """A hazard naming K11's walk is a K107 finding; K10's wgmma kernel,
    whose shared memory moves through the async proxy, is unanalysed,
    not clean."""
    results = {"racecheck": sanitize.parse_report("racecheck", RACECHECK)}
    findings, completed, _ = results["racecheck"]
    assert completed
    assert [(f.severity, f.rule, f.step) for f in findings] == [
        ("error", "K107", "racecheck:k11/bfloat16/256:wkv6_walk")]
    table = sanitize.status_table(results)
    assert table["K10/wgmma"] == {"racecheck": "unanalysed"}
    assert table["K11"] == {"racecheck": "finding"}
    assert table["K10/simt"] == table["K1"] == {"racecheck": "not run"}
    assert set(table) == set(sanitize.COVERED)


def test_a_tool_that_did_not_run_is_unanalysed():
    """No summary line: every case is unanalysed, and the failure is a
    K100 warning, not a clean result."""
    results = {"synccheck": sanitize.parse_report("synccheck",
                                                  SYNCCHECK_FAILED)}
    findings, completed, ran = results["synccheck"]
    assert not completed and ran == []
    assert {(f.severity, f.rule) for f in findings} == {("warning", "K100")}
    mem = sanitize.parse_report("memcheck", MEMCHECK)
    table = sanitize.status_table({"memcheck": mem, **results})
    assert {u: t["memcheck"] for u, t in table.items()
            if t["memcheck"] != "not run"} == {
        "K1": "clean", "K9": "finding", "K3/stream": "clean"}
    assert {t["synccheck"] for t in table.values()} == {"unanalysed"}


#: the reading of the card this port runs on (compute-sanitizer
#: 2025.2.1.0 on an NVIDIA H100 80GB HBM3): the tool refuses the device
UNSUPPORTED = (
    BANNER
    + "========= Error: Device not supported. Please refer to the "
    "\"Supported Devices\" section of the sanitizer documentation\n"
    "========= \n"
    "========= Program hit cudaErrorUnknown (error 999) due to \"unknown "
    "error\" on CUDA API call to cudaMalloc.\n"
    "========= Target application returned an error\n"
    "========= ERROR SUMMARY: 3 errors\n")


def test_an_unsupported_device_is_unanalysed_and_exits_2(monkeypatch,
                                                        capsys):
    findings, analysed, ran = sanitize.parse_report("memcheck", UNSUPPORTED)
    assert not analysed and ran == []
    assert {(f.severity, f.rule) for f in findings} == {
        ("warning", "K100"), ("info", "K100")}
    monkeypatch.setattr(sanitize, "find_sanitizer", lambda: "/x/cs")
    monkeypatch.setattr(_build, "build", lambda: None)
    monkeypatch.setattr(sanitize, "run_tool", lambda *a: UNSUPPORTED)
    monkeypatch.setattr(sanitize.subprocess, "run", lambda *a, **k: type(
        "P", (), {"stdout": "Version 2025.2.1.0"})())
    assert sanitize.main([]) == 2
    out = capsys.readouterr().out
    assert "| K1 | unanalysed | unanalysed | unanalysed | unanalysed |" in out


def test_every_tool_has_a_rule_and_every_kernel_its_globals():
    assert all(rule in RULES for rule in sanitize.TOOL_RULES.values())
    assert sanitize.TOOL_RULES == {"memcheck": "K101", "initcheck": "K102",
                                   "racecheck": "K107", "synccheck": "K108"}
    declared = set()
    for src in _build.CSRC.glob("*.cu"):
        declared |= set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
            src.read_text()))
    named = {g for names in sanitize.GLOBALS.values() for g in names}
    assert named == declared
    # the cases cover every unit, K3's CUDA-core tiles included; the
    # guard pass runs first, its rules in the taxonomy
    assert sanitize.COVERED == tuple(sanitize.GLOBALS)
    assert "K3/tiles" in sanitize.COVERED and len(sanitize.COVERED) == 14
    assert sanitize.DEFAULT_TOOLS == (sanitize.GUARD,) + sanitize.TOOLS
    assert all(rule in RULES for rule in ("K109", "K110", "K111"))
    # the async-proxy kernels read their shared memory with wgmma
    for name, src in (("mm_wgmma", "matmul_fused.cu"),
                      ("flash_wgmma", "flash_attention.cu")):
        assert name in sanitize.ASYNC_PROXY
        assert "wgmma" in (_build.CSRC / src).read_text()


def test_absent_binary_exits_2(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    monkeypatch.setenv("PATH", str(tmp_path))
    assert sanitize.find_sanitizer() is None
    assert sanitize.main([]) == 2
    assert "compute-sanitizer not found" in capsys.readouterr().out


def test_binary_beside_nvcc_is_found(monkeypatch, tmp_path):
    (tmp_path / "nvcc").write_text("")
    (tmp_path / "compute-sanitizer").write_text("")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(tmp_path / "nvcc"))
    assert sanitize.find_sanitizer() == str(tmp_path / "compute-sanitizer")


@pytest.mark.parametrize("tool", sanitize.TOOLS)
def test_each_tool_runs_the_cases(tool, monkeypatch):
    """One sanitizer run a tool, the case runner under it, each tensor its own
    allocation (``PYTORCH_NO_CUDA_MEMORY_CACHING``)."""
    seen = {}

    def run(cmd, **kw):
        seen.update(cmd=cmd, env=kw["env"])
        return type("P", (), {"stdout": "out", "returncode": 0})()

    monkeypatch.setattr(sanitize.subprocess, "run", run)
    out = sanitize.run_tool("/x/compute-sanitizer", tool, 10.0)
    assert out.startswith("out")
    assert seen["cmd"][:3] == ["/x/compute-sanitizer", "--tool", tool]
    assert seen["cmd"][-3:] == ["-m", "repro_torch.tools.sanitize",
                                "--run-cases"]
    assert seen["env"]["PYTORCH_NO_CUDA_MEMORY_CACHING"] == "1"


def _guard_result(findings, analysed=True):
    ran = [("k3/bf16/gate/m4", ["K3/stream"])]
    return findings, analysed, ran if analysed else []


def test_guard_pass_alone_exits_0_without_compute_sanitizer(monkeypatch,
                                                            capsys):
    """The guard pass runs first; with it analysed, a missing
    compute-sanitizer is no exit 2, and its column reads clean."""
    monkeypatch.setattr(sanitize, "run_guard",
                        lambda: _guard_result([]))
    monkeypatch.setattr(sanitize, "find_sanitizer", lambda: None)
    assert sanitize.main([]) == 0
    out = capsys.readouterr().out
    assert "compute-sanitizer not found" in out
    assert "| K3/stream | clean |" in out and "| K1 | not run |" in out
    assert "| unit | K101 | K102 | K109 | K110 | K111 |" in out


def test_guard_finding_exits_1(monkeypatch, capsys):
    bad = Finding("error", "guard:k3/bf16/gate/m4:K3/stream", "K102",
                  "launch 0 (matmul_fused_bf16): y: 1 element(s) never "
                  "written")
    monkeypatch.setattr(sanitize, "run_guard",
                        lambda: _guard_result([bad]))
    assert sanitize.main(["--tools", "guard"]) == 1
    out = capsys.readouterr().out
    assert "| K3/stream | finding |" in out
    assert "| K3/stream | clean | 1 | clean | clean | clean |" in out


def test_guard_without_a_card_is_unanalysed(monkeypatch, capsys):
    """On a machine with no CUDA device the guard pass does not run: not
    analysed, exit 2."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert sanitize.main(["--tools", "guard"]) == 2
    out = capsys.readouterr().out
    assert "the guard pass did not run" in out
    assert "| K1 | unanalysed |" in out


def test_cases_hold_the_one_slice_stream_and_starcoder2s_window():
    """The 100 cases include K3 where the weight stream takes one K slice
    on 132 SMs (starcoder2-15b's up with a bias and gelu at M = 4,
    qwen1.5-32b's gate at M = 4) and N = 27392 on wgmma (the gate at
    300), and K10's window at head_dim 128, 48 heads over 4."""
    import torch

    from repro_torch.kernels.attention.ops import k10_path
    from repro_torch.kernels.matmul_fused.ops import k3_path, split_k

    names = sanitize.cases("cpu")
    assert len(names) == 100
    for name, kk, n, act, bias, rows in sanitize.K3_ONE_SLICE:
        assert split_k(torch.bfloat16, kk, n, 132) == (1, kk)
        for m in rows:
            assert f"k3/bf16/{name}/m{m}" in names
            assert k3_path(torch.bfloat16, m, kk, n) == (
                "stream" if m < 64 else "wgmma")
    assert [c for c in sanitize.K10_CASES if c[2:5] == (48, 4, 128)] == [
        (300, None, 48, 4, 128, True, 4096, 0.0, "bfloat16")]
    assert "k10/bfloat16/300x300/h48-4/hd128/causal/w4096/cap0" in names
    assert k10_path(torch.bfloat16, 300, 300, 128) == "wgmma"

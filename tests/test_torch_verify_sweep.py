"""The port's verify sweep (``repro_torch.tools.verify_sweep``) on the CPU:
every bundled net × kernel method × fuse, and the forced second-generation
knob sets with the tuned deployment, verify clean at batches 1-16 on 132
SMs; the CLI's exit code and its ``--json`` / ``--md`` output."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.core import netdefs
from repro_torch.core.methods import Method
from repro_torch.tools import verify_sweep

REPO = Path(__file__).resolve().parent.parent


def test_sweep_cli_exits_0():
    p = subprocess.run([sys.executable, "-m",
                        "repro_torch.tools.verify_sweep"],
                       capture_output=True, text=True,
                       env={"PYTHONPATH": str(REPO / "src")})
    assert p.returncode == 0, p.stdout + p.stderr
    assert "31 configurations at batches 1-16 on 132 SMs, 0 finding(s)" in \
        p.stdout


@pytest.mark.parametrize("flag", ["--json", "--md"])
def test_sweep_output_parses(flag, capsys):
    assert verify_sweep.main([flag]) == 0
    out = capsys.readouterr().out
    if flag == "--json":
        assert json.loads(out) == []
    else:
        assert out.startswith("### Plan verifier sweep") and \
            "No findings." in out


def test_sweep_grid():
    assert verify_sweep.METHODS == (
        Method.BASIC_PARALLEL, Method.BASIC_SIMD, Method.ADVANCED_SIMD_4,
        Method.ADVANCED_SIMD_8)
    assert verify_sweep.BATCHES == tuple(range(1, 17))
    assert any(tag == "tuned" and knobs is verify_sweep.TUNED
               for _, _, knobs, tag in verify_sweep.EXTRA_CONFIGS)


def test_sweep_tuned_is_the_smokes():
    """The sweep's tuned deployment is the one ``chip_smoke.py`` deploys
    (the smoke keeps its own copy: it imports the port only once it has
    found the card)."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    assert chip_smoke.TUNED == verify_sweep.TUNED


def test_sweep_reports_a_seeded_defect(capsys):
    """A net of 16001 channels with an LRN: the stage-major LRN tail holds
    more channels than the kernel's shared memory (V301 for the advanced
    methods) and K7's band of one pooled row does not fit a block (V303
    for basic SIMD); the CLI's exit code would be 1."""
    def wide():
        L = netdefs.LayerSpec
        return netdefs.NetworkDef("wide", (1, 4, 4), 2, (
            L("conv", "c1", out_channels=16001, kernel=(1, 1)),
            L("pool", "p1", kernel=(2, 2), stride=(2, 2)),
            L("lrn", "n1", lrn_n=5), L("flatten", "f"),
            L("fc", "fc1", out_channels=2)))

    findings, combos = verify_sweep.sweep({"wide": wide}, batches=(1,))
    assert combos == 8
    assert {(f.step.split("::")[0], f.rule) for f in findings} == {
        ("wide/advanced_simd_4/fuse=True", "V301"),
        ("wide/advanced_simd_8/fuse=True", "V301"),
        ("wide/basic_simd/fuse=True", "V303")}

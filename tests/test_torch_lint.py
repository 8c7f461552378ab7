"""The port's lint (``repro_torch.analysis.lint``) on the CPU.

The port's tree lints clean (the gate, through the tier-1 tests); the
rules it shares with the JAX lint (R002, R004, R005, R006) give the JAX
lint's findings on the snippet corpus of ``tests/test_lint.py``; R001's
and R007's counterparts fire on seeded snippets; and the lint imports
nothing of the JAX package.
"""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from repro.analysis import lint as jlint
from repro_torch.analysis.lint import lint_source, lint_tree
from repro_torch.tools import lint as lint_cli

REPO = Path(__file__).resolve().parent.parent
SHARED = ("R002", "R004", "R005", "R006")


def rules_of(findings):
    return {f.rule for f in findings}


def test_port_tree_lints_clean():
    assert lint_tree(REPO / "src" / "repro_torch") == []


def test_cli_fails_on_findings_only(tmp_path, capsys):
    """``python -m repro_torch.tools.lint --fail-on-findings`` exits 0 on
    the package (its default path) and 1 on a seeded file; ``--json`` and
    ``--md`` print the findings."""
    env = {"PYTHONPATH": str(REPO / "src")}
    p = subprocess.run([sys.executable, "-m", "repro_torch.tools.lint",
                        "--fail-on-findings"], capture_output=True,
                       text=True, env=env, cwd=tmp_path)
    assert p.returncode == 0, p.stdout + p.stderr
    assert p.stdout.strip().endswith("0 finding(s)")
    bad = tmp_path / "bad.py"
    bad.write_text("try:\n    f()\nexcept Exception:\n    pass\n")
    assert lint_cli.main([str(bad), "--fail-on-findings", "--json"]) == 1
    assert '"rule": "R004"' in capsys.readouterr().out
    assert lint_cli.main([str(bad), "--md"]) == 0
    assert "| R004 |" in capsys.readouterr().out


def _corpus():
    """Every ``src = \"\"\"...\"\"\"`` snippet of ``tests/test_lint.py`` and
    its R005 expressions, by test name."""
    tree = ast.parse((REPO / "tests" / "test_lint.py").read_text())
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "src"
                    and isinstance(node.value, ast.Constant)):
                out.append((fn.name, node.value.value))
        if fn.name == "test_r005_magic_budget_comparison":
            exprs = fn.decorator_list[0].args[1].elts
            out += [(fn.name, f"ok = cell_bytes <= {e.value}\n")
                    for e in exprs]
    return out


CORPUS = _corpus()
#: the path each snippet is linted under in each package
PATHS = (("<string>", "<string>"),
         ("src/repro/serving/x.py", "src/repro_torch/serving/x.py"),
         ("src/repro/kernels/conv2d/kernels.py",
          "src/repro_torch/kernels/conv2d/kernels.py"))


def test_corpus_is_the_jax_tests():
    assert len(CORPUS) >= 20
    assert {name.split("_")[1] for name, _ in CORPUS} >= {
        "r002", "r004", "r005", "r006"}


@pytest.mark.parametrize("idx", range(len(CORPUS)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CORPUS)])
def test_shared_rules_match_jax(idx):
    _, src = CORPUS[idx]
    for jpath, path in PATHS:
        theirs = [(f.severity, f.step.replace("src/repro/",
                                              "src/repro_torch/"),
                   f.rule, f.detail)
                  for f in jlint.lint_source(src, jpath)
                  if f.rule in SHARED]
        ours = [(f.severity, f.step, f.rule, f.detail)
                for f in lint_source(src, path) if f.rule in SHARED]
        assert ours == theirs


# -- R001: a C entry's return code reaches _build.check -----------------------


def test_r001_unchecked_entry_call():
    src = """
def launch(x, y):
    rc = _build.library().pool2d_f32(x.data_ptr(), y.data_ptr())
    pool2d.launches += 1
    return y


def bare(x):
    _build.library().conv_basic_simd_f32(x.data_ptr())


def by_name(x, entry):
    lib = _build.library()
    lib.wkv6_f32(x)
"""
    findings = lint_source(src)
    assert rules_of(findings) == {"R001"}
    assert [f.step for f in findings] == ["<string>:3", "<string>:9",
                                          "<string>:14"]


def test_r001_checked_entry_calls_clean():
    src = """
def launch(x, y, entry):
    rc = getattr(_build.library(), entry)(x.data_ptr(), y.data_ptr())
    _build.check(rc, entry)
    lib = _build.library()
    rc2 = lib.pool2d_f32(x.data_ptr())
    _build.check(rc2, "pool2d_f32")
    return y
"""
    assert lint_source(src) == []


def test_r001_check_of_another_name_fires():
    src = """
def launch(x, rc0):
    rc = _build.library().pool2d_f32(x.data_ptr())
    _build.check(rc0, "pool2d_f32")
"""
    assert rules_of(lint_source(src)) == {"R001"}


# -- R007: the plain versions' ACC_DTYPE discipline ------------------------------

KERNEL_REF = "src/repro_torch/kernels/pool2d/ref.py"
KERNEL_OPS = "src/repro_torch/kernels/conv2d/ops.py"


@pytest.mark.parametrize("expr", ["x.to(torch.float32)",
                                  "x.to(dtype=torch.float64)",
                                  'x.to("float32")', "x.float()",
                                  "x.to(x.device, torch.float32)"])
def test_r007_inline_float_dtype(expr):
    src = f"def pool_ref(x):\n    return {expr}.sum()\n"
    for path in (KERNEL_REF, KERNEL_OPS):
        assert rules_of(lint_source(src, path)) == {"R007"}


def test_r007_named_constant_and_dtype_clean():
    src = """
def conv_ref(x, w):
    out = x.to(ACC_DTYPE) @ w.to(ACC_DTYPE)
    return out.to(x.dtype)
"""
    assert lint_source(src, KERNEL_REF) == []


def test_r007_only_plain_versions_under_kernels():
    src = "def launch(x):\n    return x.to(torch.float32)\n"
    assert lint_source(src, KERNEL_OPS) == []  # a wrapper, not a plain one
    ref = "def pool_ref(x):\n    return x.to(torch.float32)\n"
    assert lint_source(ref, "src/repro_torch/nn/attention.py") == []


# -- R008: a launching wrapper allocates through the guard pass's hook --------


R008_SRC = """
def _launch(x):
    y = torch.empty((4, 4), dtype=x.dtype, device=x.device)
    s = torch.zeros_like(y)
    rc = _build.library().pool2d_f32(operand(x).data_ptr(), y.data_ptr())
    _build.check(rc, "pool2d_f32")
    return y


def helper(x):
    return torch.empty_like(x)


def hooked(x):
    y = alloc((4, 4), x.dtype, x.device)
    rc = _build.library().pool2d_f32(operand(x).data_ptr(), y.data_ptr())
    _build.check(rc, "pool2d_f32")
    return y
"""


def test_r008_allocation_past_the_hook():
    """A function of a wrapper module that calls ``_build.library()`` and
    allocates with ``torch.empty``/``zeros_like`` fires R008 at each
    allocation; a helper that launches nothing, and the hooked launch,
    are clean; so is the same source outside ``kernels/*/ops.py``."""
    findings = lint_source(R008_SRC, KERNEL_OPS)
    assert rules_of(findings) == {"R008"}
    assert [f.step for f in findings] == [f"{KERNEL_OPS}:3",
                                          f"{KERNEL_OPS}:4"]
    assert "torch.empty" in findings[0].detail
    assert lint_source(R008_SRC, KERNEL_REF) == []
    assert lint_source(R008_SRC, "src/repro_torch/kernels/common.py") == []


def test_lint_imports_nothing_of_the_jax_package():
    """A fresh interpreter that imports the port's lint, its CLI and the
    sweep loads no module of ``repro`` and no ``jax``."""
    code = ("import sys\n"
            "import repro_torch.analysis.lint, repro_torch.tools.lint\n"
            "import repro_torch.tools.verify_sweep\n"
            "import repro_torch.tools.sanitize\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'jax', 'jaxlib')))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={"PYTHONPATH": str(REPO / "src")})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"

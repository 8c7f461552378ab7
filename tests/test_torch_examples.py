"""The port's examples run end to end on the CPU (``--device cpu``, the
plain versions): the deploy-and-ladder quickstart and the seeded serving
driver, whose two runs give the same tokens."""
import importlib.util
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_runs_the_ladder(capsys):
    rows = _example("quickstart_torch").main(["--device", "cpu"])
    assert list(rows) == ["seq_ref", "basic_parallel", "basic_simd",
                          "advanced_simd_4", "advanced_simd_8"]
    assert all(ms > 0 for ms in rows.values())
    out = capsys.readouterr().out
    assert "[deploy] loaded lenet5 on cpu" in out and "predictions:" in out


def test_deploy_and_serve_is_seeded():
    serve = _example("deploy_and_serve_torch")
    done = serve.main(["--device", "cpu"])
    assert sorted(done) == list(range(8))
    assert all(8 <= len(toks) < 20 for toks in done.values())
    assert serve.main(["--device", "cpu"]) == done

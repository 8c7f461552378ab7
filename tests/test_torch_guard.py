"""The guard pass (``repro_torch.analysis.guard``) on the CPU.

The harness is driven through the wrappers' own launch code (K3's, K9's,
K10's, K11's and the stage-major ``_launch*``) with CPU tensors standing
in for the card's and a stand-in of the kernel library whose entries,
typed by ``_build.SIGNATURES``, are plain PyTorch functions reading and
writing the memory the pointers they get address.  Clean stand-ins give
no finding; each seeded fault (the fault classes of the JAX sanitizer's
tests, ``tests/test_sanitizer.py``) is flagged by its own rule alone and
names its operand.  Guard mode's buffers and the hooks with guard mode
off are checked directly.
"""
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch.analysis import guard
from repro_torch.analysis.findings import RULES
from repro_torch.kernels import _build, common
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.matmul_fused import ops as mm_ops
from repro_torch.kernels.pool2d import ops as pool_ops
from repro_torch.kernels.wkv6 import ops as wkv6_ops
from repro_torch.tools import sanitize


def _at(p, numel, dtype, first=0):
    """``numel`` elements of ``dtype`` at address ``p`` (plus ``first``
    elements), as a tensor sharing that memory."""
    size = dtype.itemsize
    raw = (ctypes.c_char * (numel * size)).from_address(p + first * size)
    return torch.frombuffer(raw, dtype=dtype)


def _guarded(p):
    """True when ``p`` lies in a buffer of the current guarded run (a
    seeded fault touches memory past a tensor only there: in the
    unguarded run it would be another allocation's)."""
    run = common._guard
    st = run.lookup(p) if run is not None else None
    return st is not None and st.buf is not None


class _Lib:
    """A stand-in of the kernel library: ``fns`` maps C entries to plain
    functions of their arguments; each call checks its arity against
    ``_build.SIGNATURES``."""

    def __init__(self, **fns):
        self.fns, self.calls = fns, []

    def __getattr__(self, name):
        fn = self.fns[name]

        def entry(*args):
            assert len(args) == len(_build.SIGNATURES[name]), name
            self.calls.append(name)
            return fn(*args)
        return entry


def _fill_outputs(*args):
    """A clean stand-in of any entry: every output and scratch buffer the
    pointers reach, written whole with a deterministic value."""
    run = common._guard
    for p in args:
        ps = list(p) if isinstance(p, ctypes.Array) else [p]
        for q in ps:
            st = run.lookup(q) if isinstance(q, int) and q else None
            if st is not None and st.role in ("output", "scratch"):
                st.view.fill_(0.5)
    return 0


# -- K3's wrapper with a stand-in of matmul_fused_f32 ---------------------------


M, K, N = 5, 8, 6


def _k3_entry(fault=None):
    """``y = x @ w + b`` from the pointers, with one seeded ``fault``."""
    state = {"calls": 0}

    def entry(x, w, b, y, m, n, k, path, splits, kchunk, act, stream):
        f32 = torch.float32
        xs, ws = _at(x, m * k, f32).view(m, k), _at(w, k * n, f32).view(k, n)
        out = xs @ ws + _at(b, n, f32)
        if fault == "read_past" and _guarded(x):
            out[:, -1] += _at(x, 1, f32, first=m * k)[0]
        if fault == "nondeterministic":
            state["calls"] += 1
            out[0, 0] += state["calls"]
        ys = _at(y, m * n, f32).view(m, n)
        rows = m - 1 if fault == "last_row" else m
        ys[:rows] = out[:rows]
        if fault == "write_past" and _guarded(y):
            _at(y, 1, f32, first=m * n)[0] = 1.0
        if fault == "write_before" and _guarded(y):
            _at(y, 1, f32, first=-1)[0] = 1.0
        if fault == "write_input":
            xs[0, 0] = 7.0
        return 0
    return entry


@pytest.fixture
def stand_in(monkeypatch):
    """Route the wrappers' launches to a stand-in library on the CPU."""
    for mod in (mm_ops, attn_ops):
        monkeypatch.setattr(mod, "check_cuda", lambda *a, **kw: None)
        monkeypatch.setattr(mod, "_stream", lambda dev: 0)
    monkeypatch.setattr(mm_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(pool_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(pool_ops, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(wkv6_ops, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(wkv6_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(wkv6_ops, "stream_handle", lambda dev: 0)
    monkeypatch.setattr(wkv6_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(conv_ops, "_sms", lambda dev: 132)
    monkeypatch.setattr(conv_ops, "_stream", lambda dev: 0)
    for fn in (mm_ops.matmul_fused, attn_ops.flash_attention,
               pool_ops.pool2d, wkv6_ops.wkv6, conv_ops.conv2d_chain):
        for k, v in list(vars(fn).items()):
            monkeypatch.setattr(fn, k, dict(v) if isinstance(v, dict) else v)

    def install(**fns):
        lib = _Lib(**fns)
        monkeypatch.setattr(_build, "_lib", lib)
        return lib
    return install


def _k3_case():
    rng = np.random.default_rng(0)
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((M, K), (K, N), (N,)))
    return lambda: mm_ops._launch(x, w, b, "none")


def _rules(findings):
    return sorted({f.rule for f in findings})


def test_clean_stand_in_gives_no_finding(stand_in):
    lib = stand_in(matmul_fused_f32=_k3_entry())
    findings, units = guard.check_case("k3", _k3_case())
    assert findings == [] and units == ["K3/stream"]
    assert lib.calls == ["matmul_fused_f32"] * 5   # four guarded, one plain


@pytest.mark.parametrize("fault,rule,operand", [
    ("write_past", "K101", "after y"),
    ("write_before", "K101", "before y"),
    ("last_row", "K102", "y: 6 element(s) never written"),
    ("read_past", "K101", "y changes with the guard bands"),
    ("write_input", "K109", "input x"),
    ("nondeterministic", "K110", "y differs between two runs"),
])
def test_seeded_fault_is_flagged_by_its_rule_alone(fault, rule, operand,
                                                   stand_in):
    stand_in(matmul_fused_f32=_k3_entry(fault))
    findings, _ = guard.check_case("k3", _k3_case())
    assert _rules(findings) == [rule], findings
    assert len(findings) == 1 and operand in findings[0].detail
    assert findings[0].step == "guard:k3:K3/stream"
    assert findings[0].severity == "error"


def test_unstaged_operand_is_k111(stand_in, monkeypatch):
    """A wrapper that hands its C entry a tensor past the operand hook:
    the pass is incomplete, an error of its own."""
    stand_in(matmul_fused_f32=_k3_entry())
    real = common.operand
    monkeypatch.setattr(mm_ops, "operand",
                        lambda t: t if t is not None and t.dim() == 1
                        else real(t))
    findings, _ = guard.check_case("k3", _k3_case())
    assert _rules(findings) == ["K111"] and "b = 0x" in findings[0].detail


# -- the stage-major wrapper: pointer arrays, scratch, host arrays ------------


def _chain_case():
    rng = np.random.default_rng(1)
    shapes = [(8, 4, 3, 3), (4, 8, 3, 3)]
    x = torch.from_numpy(rng.standard_normal((2, 4, 9, 9)).astype(np.float32))
    ws = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          for s in shapes]
    bs = [torch.from_numpy(rng.standard_normal(s[0]).astype(np.float32))
          for s in shapes]
    pool, lrn = conv_ops._pool_lrn((2, 2), None, "max", None, 0, 0, 0)

    def run():
        return conv_ops._launch_stage_major(
            conv_ops.conv2d_chain, "conv_chain_f32", x, ws, bs,
            [(1, 1)] * 2, [(1, 1)] * 2, [True] * 2, pool, False, lrn)
    return run, ws


def _scratch_read_first(x, ws, bs, out, scratch, geo, lrn, plan, stream):
    """Adds the scratch's first floats into the output before writing
    them: a read of scratch before it is written."""
    run = common._guard
    o, s = run.lookup(out), run.lookup(scratch)
    o.view.fill_(0.5)
    o.view.view(-1)[:4] += s.view[:4]
    s.view.fill_(0.0)
    return 0


def test_stage_major_clean_and_its_host_arrays_staged(stand_in):
    lib = stand_in(conv_chain_f32=_fill_outputs)
    run_fn, _ = _chain_case()
    findings, units = guard.check_case("chain", run_fn)
    assert findings == [] and units == ["K2"]
    assert len(lib.calls) == 5
    # the memo's arrays are left as they are: read-only, not the staged
    memo = conv_ops.chain_launch.cache_info().currsize
    assert memo >= 1


def test_scratch_read_before_write_is_k102(stand_in):
    stand_in(conv_chain_f32=_scratch_read_first)
    run_fn, _ = _chain_case()
    findings, _ = guard.check_case("chain", run_fn)
    assert _rules(findings) == ["K102"], findings
    assert "read before it was written" in findings[0].detail
    assert "out:" in findings[0].detail


def test_unstaged_pointer_in_a_pointer_array_is_k111(stand_in, monkeypatch):
    """A converted weight handed to the stage-major entry past the
    operand hook: ``ws[1]`` lies in no staged buffer."""
    stand_in(conv_chain_f32=_fill_outputs)
    run_fn, ws = _chain_case()
    hidden = conv_ops.chain_weights(ws[1])
    real = common.operand
    monkeypatch.setattr(conv_ops, "operand",
                        lambda t: t if t is hidden else real(t))
    findings, _ = guard.check_case("chain", run_fn)
    assert _rules(findings) == ["K111"], findings
    assert "ws[1] = 0x" in findings[0].detail


# -- every wrapper routes every operand through the hooks ------------------------


def _pool_case():
    x = torch.randn(2, 3, 7, 6, generator=torch.Generator().manual_seed(0))
    return lambda: pool_ops._launch(x, (3, 2), (2, 2), "max", False)


def _attention_case(ml):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 20, 4, 64, generator=g)
    k, v = (torch.randn(1, 20, 2, 64, generator=g) for _ in range(2))
    return lambda: attn_ops._launch(q, k, v, True, 0, 0.0, 0.125, ml=ml)


def _wkv6_case(state):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 37, 2, 64, generator=g) for _ in range(3))
    logw = -torch.rand(1, 37, 2, 64, generator=g)
    u = torch.randn(2, 64, generator=g)
    s = torch.randn(1, 2, 64, 64, generator=g) if state else None
    return lambda: wkv6_ops._launch(r, k, v, logw, u, 37, s)


@pytest.mark.parametrize("entry,make,unit", [
    ("pool2d_f32", _pool_case, "K9"),
    ("flash_attention_fwd", lambda: _attention_case(False), "K10/simt"),
    ("flash_attention_fwd_ml", lambda: _attention_case(True), "K10/simt"),
    ("wkv6_f32", lambda: _wkv6_case(True), "K11"),
    ("wkv6_f32", lambda: _wkv6_case(False), "K11"),
    ("matmul_fused_f32", _k3_case, "K3/stream"),
])
def test_every_wrapper_stages_every_operand(entry, make, unit, stand_in):
    """Each wrapper's launch through a clean stand-in gives no finding:
    no K111 (every pointer lies in a staged buffer) and no K102 (every
    output the stand-in wrote was one the wrapper allocated)."""
    stand_in(**{entry: _fill_outputs})
    findings, units = guard.check_case(entry, make())
    assert findings == [] and units == [unit]


# -- guard mode's buffers, and the hooks with guard mode off ----------------------


@pytest.mark.parametrize("shape,dtype", [((3, 5), torch.float32),
                                         ((7,), torch.bfloat16),
                                         ((400, 300), torch.float32),
                                         ((0,), torch.float32)])
def test_guarded_buffers(shape, dtype):
    src = torch.randn(shape).to(dtype)
    with guard.guarded("B", "S2") as run:
        out = common.alloc(shape, dtype, "cpu")
        like = common.alloc(src)
        staged = common.operand(src)
        host = common.operand(np.arange(5, dtype=np.int32))
        sts, hst = run.pending[:3], run.pending[3]
    assert all(st.view is t for st, t in zip(sts, (out, like, staged)))
    for t in (out, like, staged):
        assert t.shape == shape and t.dtype == dtype and t.is_contiguous()
        assert t.data_ptr() % 512 == 0
    assert host.ctypes.data % 512 == 0 and list(host) == list(range(5))
    assert torch.equal(staged, src)
    if src.numel():  # an empty tensor's data_ptr is 0
        assert staged.data_ptr() != src.data_ptr()
    bits = guard._TORCH_BITS[dtype.itemsize]
    s2 = guard.pattern("S2", dtype)
    assert bool((out.view(bits) == s2).all())
    nbytes = src.numel() * dtype.itemsize
    for st in sts + [hst]:
        assert st.band == max(64 * 1024, -(-st.nbytes // 8 + 511) // 512
                              * 512)
        assert st.band % 512 == 0 and st.band * 8 >= st.nbytes
    for st in sts:
        assert st.nbytes == nbytes
        b = guard.pattern("B", dtype)
        assert bool((st.buf[:st.band].view(bits) == b).all())
        assert bool((st.buf[st.band + nbytes:].view(bits) == b).all())
    assert [st.role for st in sts] == ["output", "output", "input"]


def test_band_size():
    assert guard.band_bytes(0) == guard.band_bytes(4) == 64 * 1024
    assert guard.band_bytes(8 * 64 * 1024) == 64 * 1024
    assert guard.band_bytes(8 * 64 * 1024 + 8) == 64 * 1024 + 512
    assert guard.band_bytes(8 << 20) == 1 << 20


def test_patterns():
    """A: a quiet NaN; B: large and finite (fp32 1e38, bf16 0x7E96); S1
    and S2: NaNs of opposite signs with the quiet bit clear (no arithmetic
    makes them)."""
    f32 = torch.tensor([guard.pattern(n, torch.float32)
                        for n in ("A", "B", "S1", "S2")],
                       dtype=torch.int32).view(torch.float32)
    assert f32[0].isnan() and f32[1].item() == pytest.approx(1e38, rel=1e-6)
    assert f32[2].isnan() and f32[3].isnan()
    for size in (2, 4, 8):  # opposite signs
        p = guard.PATTERNS[size]
        assert (p["S1"] >> (8 * size - 1), p["S2"] >> (8 * size - 1)) == (0, 1)
    bf = torch.tensor([guard.pattern(n, torch.bfloat16)
                       for n in ("A", "B", "S1", "S2")],
                      dtype=torch.int16).view(torch.bfloat16)
    assert bf[0].isnan() and bf[1].isfinite() and bf[1].item() > 9e37
    assert bf[2].isnan() and bf[3].isnan()
    assert guard.pattern("S1", torch.bfloat16) == 0x7FA5
    assert guard.pattern("S2", torch.bfloat16) == 0xFFA5 - 0x10000
    # the quiet bit of the S fills is clear: signalling payloads
    assert not (guard.PATTERNS[4]["S1"] >> 22) & 1
    assert not (guard.PATTERNS[2]["S1"] >> 6) & 1


def test_hooks_with_guard_mode_off():
    assert common._guard is None
    t = torch.randn(3, 4)
    a = np.arange(3, dtype=np.int32)
    assert common.operand(t) is t and common.operand(a) is a
    assert common.operand(None) is None
    ptrs = (a.ctypes.data,)
    assert common.operand_ptrs((a,), ptrs) is ptrs
    out = common.alloc((2, 3), torch.float32, "cpu")
    assert out.shape == (2, 3) and out.dtype == torch.float32
    assert out._base is None and out.storage_offset() == 0
    like = common.alloc(t)
    assert like.shape == t.shape and like._base is None
    lib = _build._lib
    if lib is not None:
        assert _build.library() is lib


def test_library_is_a_proxy_only_in_guard_mode(monkeypatch):
    lib = _Lib(pool2d_f32=_fill_outputs)
    monkeypatch.setattr(_build, "_lib", lib)
    assert _build.library() is lib
    with guard.guarded():
        assert isinstance(_build.library(), guard._Proxy)
        with pytest.raises(RuntimeError, match="already on"):
            with guard.guarded():
                pass
    assert _build.library() is lib and common._guard is None


def test_arg_names_match_the_signatures():
    names = guard.arg_names()
    assert set(names) == set(_build.SIGNATURES)
    for entry, types in _build.SIGNATURES.items():
        assert len(names[entry]) == len(types), entry
        if types:
            assert names[entry][-1] == "stream"
    assert names["conv_chain_f32"][:5] == ("x", "ws", "bs", "out", "scratch")


def test_rules_and_units():
    assert all(r in RULES for r in guard.RULES)
    for r in ("K109", "K110", "K111"):
        assert RULES[r][0] == "guard"
    for r in ("K101", "K102"):
        assert "guard pass" in RULES[r][1]
    assert {"memcheck" in RULES["K101"][1], "initcheck" in RULES["K102"][1]
            } == {True}
    units = set(guard.ENTRY_UNITS.values()) | {
        f"K3/{p}" for p in guard.K3_PATHS} | {
        f"K10/{p}" for p in guard.K10_PATHS}
    assert units == set(sanitize.GLOBALS)
    assert guard.K3_PATHS == tuple(mm_ops.PATH_CODES)
    assert guard.K10_PATHS == tuple(attn_ops.PATH_CODES)
    assert list(mm_ops.PATH_CODES.values()) == [0, 1, 2]
    assert list(attn_ops.PATH_CODES.values()) == [0, 1]


def test_table():
    f = [guard.Finding("error", "guard:c:K9", "K101", "x"),
         guard.Finding("error", "guard:c:K9", "K101", "y")]
    table = guard.guard_table(f, ["K9", "K1"], ["K1", "K9", "K11"])
    assert table["K9"]["K101"] == "2" and table["K9"]["K102"] == "clean"
    assert set(table["K1"].values()) == {"clean"}
    assert set(table["K11"].values()) == {"not run"}
    md = guard.table_markdown(table)
    assert re.search(r"\| K9 \| 2 \| clean \| clean \| clean \| clean \|", md)


def _runs(*outs):
    """Runs 1-4 and the unguarded run of one launch of K9 whose output
    ``y`` holds ``outs[i]`` (fp32 values) in run ``i``."""
    runs = []
    for o in outs:
        run = guard.Run("c")
        bits = torch.tensor(o, dtype=torch.float32).view(torch.int32)
        run.launches.append(guard.LaunchRecord("pool2d_f32", "K9",
                                               [("y", bits)]))
        runs.append(run)
    return runs[:4], runs[4]


def test_compare_placement_and_nan_from_the_fill():
    """A result that differs only from the unguarded launch's is K110 (it
    depends on where the buffers sit), unless run 1 holds NaNs where the
    unguarded run does not: the card's arithmetic drops a NaN's payload,
    so a read of the S fill before a write shows only there (K102)."""
    nan = float("nan")
    runs, plain = _runs([1.0, 2.0], [1.0, 2.0], [1.0, 2.0], [1.0, 2.0],
                        [1.0, 3.0])
    (f,) = guard.compare("c", runs, plain)
    assert f.rule == "K110" and "where the buffers sit" in f.detail
    runs, plain = _runs([1.0, nan], [1.0, nan], [1.0, nan], [1.0, nan],
                        [1.0, 0.0])
    (f,) = guard.compare("c", runs, plain)
    assert f.rule == "K102" and "holds NaNs" in f.detail
    runs, plain = _runs(*[[1.0, 2.0]] * 5)
    assert guard.compare("c", runs, plain) == []


# -- the one-slice weight stream (phase 15's geometry) ----------------------------


def test_one_slice_stream_is_clean(stand_in):
    """A bf16 stream product with one K slice (``split_k`` (1, K): N wide
    enough that its column blocks alone fill the card, as starcoder2's
    up and qwen1.5's gate on 132 SMs) hands the entry one slice of the
    whole K, and its launch through a clean stand-in gives no finding."""
    m, k, n = 4, 128, 16896
    assert mm_ops.split_k(torch.bfloat16, k, n, 132) == (1, k)
    seen = []

    def entry(x, w, b, y, m_, n_, k_, path, splits, kchunk, act, stream):
        seen.append((m_, n_, k_, path, splits, kchunk))
        bf = torch.bfloat16
        xs = _at(x, m_ * k_, bf).view(m_, k_).float()
        ws = _at(w, k_ * n_, bf).view(k_, n_).float()
        _at(y, m_ * n_, bf).view(m_, n_).copy_(xs @ ws)
        return 0

    stand_in(matmul_fused_bf16=entry)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(m, k, generator=g).bfloat16()
    w = (torch.randn(k, n, generator=g) / k ** 0.5).bfloat16()
    findings, units = guard.check_case(
        "one slice", lambda: mm_ops._launch(x, w, None, "none"))
    assert findings == [] and units == ["K3/stream"]
    assert set(seen) == {(m, n, k, mm_ops.PATH_CODES["stream"], 1, k)}

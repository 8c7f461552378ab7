"""The guard pass: every CUDA kernel's global reads, writes and output
coverage checked on the card, without compute-sanitizer.  The port's
counterpart of the JAX sanitizer's K101 (loads stay inside their operand)
and K102 (stores cover every output element), in host code only.

Guard mode (:func:`guarded`, off by default and the only switch) changes
what the wrappers' two hooks in ``kernels/common.py`` return: every
tensor a wrapper allocates (``alloc``) and every operand it hands a C
entry (``operand``, ``operand_ptrs``) lies inside a larger buffer, with a
guard band before it and one after it, each at least 64 KiB and at least
1/8 of the tensor's bytes, rounded up to 512 B (so the tensor keeps the
512-B alignment of torch's allocator).  Inputs are staged copies (the
memos of ``chain_launch``, ``chain_weights`` and the host arrays stay
untouched); outputs and scratch are fresh and prefilled.  Under guard
mode ``_build.library()`` returns a proxy that, after each launch,
synchronizes and checks the launch's operands:

* **K101 (write)** — a guard band no longer holds the run's pattern;
* **K109** — a byte of an input changed (a write to an operand the
  kernel only reads);
* **K111** — a pointer argument (or an element of a pointer array, as
  the stage-major entries' ``ws`` and ``bs``) lies in no buffer the pass
  staged: the pass is incomplete, so this is an error.

:func:`check_case` runs one case four times in guard mode and once
unguarded, records each launch's outputs by their index within the run,
and compares the runs launch by launch, naming the first launch that
differs:

=====  ============  ========================================
run    guard bands   fresh outputs and scratch prefilled with
=====  ============  ========================================
1      A (qNaN)      S1
2      B (finite)    S1
3      A             S2
4      A             S1 (a repeat of run 1)
=====  ============  ========================================

* runs 1 and 4 differ: **K110**, a repeated launch is not bit for bit
  the same (the determinism contract; it may signal a race);
* runs 1 and 2 differ: **K101 (read)**, the kernel read a guard band;
* runs 1 and 3 differ: **K102**, an element that holds S1 in run 1 and
  S2 in run 3 was never written; any other difference is a read of an
  output or of its scratch before it was written;
* run 1 and the unguarded run differ: **K110**, the result depends on
  where the buffers sit — unless run 1 holds a NaN where the unguarded
  run does not, which arithmetic on an S fill gives (a NaN's payload
  does not survive the card's arithmetic, so runs 1 and 3 agree): then
  **K102**, a read before a write.

A difference explained by an earlier launch of the same comparison, or by
a finding of a higher rule in this order at the same or an earlier
launch, is not reported again.  The bit patterns are those of the
operand's element size (A: a quiet NaN; B: a large finite value, fp32
``1e38``, bf16 ``0x7E96``; S1, S2: signalling-NaN payloads no arithmetic
produces, of opposite signs), and every fill and comparison works on
integer bit views.  What the pass cannot see is in ``analysis/README.md``.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis.findings import Finding
from repro_torch.kernels import _build, common

#: the guard pass's rules, in the order of the table's columns
RULES = ("K101", "K102", "K109", "K110", "K111")
ALIGN = 512                  # bytes: torch's allocator's alignment
MIN_BAND = 64 * 1024         # bytes: the narrowest guard band
BAND_SHARE = 8               # a band holds at least 1/8 of the tensor

#: bit patterns by element size: the bands' (A, B) and the fills' (S1, S2)
PATTERNS = {
    1: {"A": 0xFF, "B": 0x7F, "S1": 0x5A, "S2": 0xDA},
    2: {"A": 0x7FC0, "B": 0x7E96, "S1": 0x7FA5, "S2": 0xFFA5},
    4: {"A": 0x7FC00000, "B": 0x7E967699, "S1": 0x7FA5A5A5,
        "S2": 0xFFA5A5A5},
    8: {"A": 0x7FF8000000000000, "B": 0x7E37E43C8800759C,
        "S1": 0x7FF5A5A5A5A5A5A5, "S2": 0xFFF5A5A5A5A5A5A5},
}
#: fp16's largest finite value: its exponent field is narrower than bf16's
F16_B = 0x7BFF
_TORCH_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
_NP_BITS = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}

#: the kernel unit of each C entry (K3 and K10: by the path argument)
ENTRY_UNITS = {
    "conv_pool_lrn_f32": "K1", "conv_chain_f32": "K2",
    "conv_pool_lrn_halo_f32": "K4", "conv_pool_carry_f32": "K5",
    "conv_chain_ocb_f32": "K6", "conv_basic_simd_f32": "K7",
    "conv_basic_parallel_f32": "K8", "pool2d_f32": "K9",
    "wkv6_f32": "K11", "wkv6_bf16": "K11",
}
K3_PATHS = ("stream", "tiles", "wgmma")   # matmul_fused's PATH_CODES
K10_PATHS = ("simt", "wgmma")             # flash_attention's PATH_CODES


def band_bytes(nbytes: int) -> int:
    """One guard band's bytes for a tensor of ``nbytes``."""
    share = -(-nbytes // BAND_SHARE)
    return max(MIN_BAND, -(-share // ALIGN) * ALIGN)


def _signed(value: int, size: int) -> int:
    bits = 8 * size
    return value - (1 << bits) if size > 1 and value >> (bits - 1) else value


def pattern(name: str, dtype) -> int:
    """The bit pattern ``name`` (A, B, S1, S2) of ``dtype``'s element size,
    as the signed integer its bit view holds."""
    size = dtype.itemsize
    if name == "B" and dtype in (torch.float16, np.dtype(np.float16)):
        return F16_B
    return _signed(PATTERNS[size][name], size)


@functools.lru_cache(maxsize=None)
def arg_names() -> Dict[str, Tuple[str, ...]]:
    """Each C entry's parameter names, read from the ``extern "C"``
    prototypes of ``csrc/*.cu``."""
    out = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       src.read_text()):
            params = " ".join(params.split())
            out[name] = tuple(
                re.findall(r"(\w+)\s*(?:\[[^\]]*\])?$", p.strip())[0]
                for p in params.split(",") if p.strip() not in ("", "void"))
    return out


def unit_of(entry: str, args: Sequence) -> str:
    """The kernel unit (a key of ``tools.sanitize.GLOBALS``) of a launch
    of ``entry`` with ``args``."""
    if entry.startswith("matmul_fused"):
        return "K3/" + K3_PATHS[args[arg_names()[entry].index("path")]]
    if entry.startswith("flash_attention"):
        return "K10/" + K10_PATHS[args[arg_names()[entry].index("path")]]
    return ENTRY_UNITS[entry]


@dataclass
class Staged:
    """One buffer the pass made: ``view``, the tensor (or host array) a
    wrapper hands its C entry, inside ``buf`` (bands included; None in
    the unguarded run) between two bands of ``band`` bytes.  ``role``:
    ``input`` (a staged copy of ``src``), ``output`` or ``scratch``."""
    role: str
    view: object
    buf: object
    band: int
    ptr: int
    nbytes: int
    src: object = None

    def contains(self, p: int) -> bool:
        return self.ptr <= p < self.ptr + max(self.nbytes, 1)


@dataclass
class LaunchRecord:
    entry: str
    unit: str
    outputs: List[Tuple[str, object]]   # (operand, its bit view's copy)


@dataclass
class Run:
    """The state of one run in guard mode (``stage``: staged buffers) or
    of the unguarded run (``stage`` False: wrappers' own tensors, outputs
    recorded)."""
    case: str = "case"
    bands: str = "A"
    fill: str = "S1"
    stage: bool = True
    pending: List[Staged] = field(default_factory=list)
    launches: List[LaunchRecord] = field(default_factory=list)
    findings: List[Tuple[int, Finding]] = field(default_factory=list)

    # -- the wrappers' hooks ------------------------------------------------

    def alloc(self, spec, dtype=None, device=None, scratch=False):
        """A fresh output (or scratch) tensor: inside a guarded buffer,
        prefilled with the run's fill; unguarded, ``torch.empty``."""
        like = spec if isinstance(spec, torch.Tensor) else None
        shape = tuple(like.shape) if like is not None else tuple(
            spec if isinstance(spec, (tuple, list, torch.Size)) else (spec,))
        dtype = like.dtype if like is not None else dtype
        device = like.device if like is not None else torch.device(device)
        role = "scratch" if scratch else "output"
        if not self.stage:
            t = (torch.empty_like(like) if like is not None
                 else torch.empty(shape, dtype=dtype, device=device))
            self.pending.append(Staged(role, t, None, 0, t.data_ptr(),
                                       t.numel() * t.element_size()))
            return t
        st = self._guarded_tensor(shape, dtype, device, role)
        st.view.view(_TORCH_BITS[dtype.itemsize]).fill_(
            pattern(self.fill, dtype))
        return st.view

    def stage_operand(self, t):
        """A staged copy of input ``t`` (a tensor or a host array) in a
        guarded buffer; unguarded, ``t`` itself."""
        if not self.stage:
            return t
        if isinstance(t, np.ndarray):
            st = self._guarded_array(t)
            st.view[...] = t
            return st.view
        st = self._guarded_tensor(tuple(t.shape), t.dtype, t.device, "input",
                                  src=t)
        with torch.no_grad():
            st.view.copy_(t)
        return st.view

    # -- buffers ------------------------------------------------------------

    def _guarded_tensor(self, shape, dtype, device, role, src=None):
        size = dtype.itemsize
        nbytes = int(np.prod(shape, dtype=np.int64)) * size
        band = band_bytes(nbytes)
        with torch.no_grad():
            raw = torch.empty(nbytes + 2 * band + ALIGN, dtype=torch.uint8,
                              device=device)
            off = (-raw.data_ptr()) % ALIGN
            buf = raw[off:off + nbytes + 2 * band]
            bits, pat = _TORCH_BITS[size], pattern(self.bands, dtype)
            buf[:band].view(bits).fill_(pat)
            buf[band + nbytes:].view(bits).fill_(pat)
            view = buf[band:band + nbytes].view(dtype).view(shape)
        st = Staged(role, view, buf, band, view.data_ptr(), nbytes, src)
        self.pending.append(st)
        return st

    def _guarded_array(self, a: np.ndarray) -> Staged:
        nbytes, size = a.nbytes, a.dtype.itemsize
        band = band_bytes(nbytes)
        raw = np.empty(nbytes + 2 * band + ALIGN, dtype=np.uint8)
        off = (-raw.ctypes.data) % ALIGN
        buf = raw[off:off + nbytes + 2 * band]
        pat = pattern(self.bands, a.dtype)
        buf[:band].view(_NP_BITS[size])[:] = pat
        buf[band + nbytes:].view(_NP_BITS[size])[:] = pat
        view = buf[band:band + nbytes].view(a.dtype).reshape(a.shape)
        st = Staged("input", view, buf, band, view.ctypes.data, nbytes, a)
        self.pending.append(st)
        return st

    def lookup(self, p: int) -> Optional[Staged]:
        """The buffer of this launch that pointer ``p`` lies in."""
        return next((st for st in self.pending if st.contains(p)), None)

    # -- a launch -----------------------------------------------------------

    def launch(self, entry: str, fn: Callable, args: tuple):
        """Call C entry ``entry`` through ``fn``; after it, synchronize,
        check its operands and record its outputs."""
        names = arg_names()[entry]
        types = _build.SIGNATURES[entry]
        index = len(self.launches)
        unit = unit_of(entry, args)
        where = f"guard:{self.case}:{unit}"
        operands, cuda = [], False
        for i, (name, typ) in enumerate(zip(names, types)):
            if typ is not ctypes.c_void_p or name == "stream":
                continue
            v = args[i]
            many = isinstance(v, ctypes.Array)
            for j, p in enumerate(v if many else (v,)):
                if not p:
                    continue
                label = f"{name}[{j}]" if many else name
                st = self.lookup(p)
                if st is None:
                    if self.stage:
                        self._find(index, Finding(
                            "error", where, "K111",
                            f"launch {index} ({entry}): {label} = {p:#x} "
                            f"lies in no buffer the pass staged"))
                    continue
                operands.append((label, st))
                cuda |= isinstance(st.view, torch.Tensor) and st.view.is_cuda
        rc = fn(*args)
        if rc != 0:
            self.pending.clear()
            return rc
        if cuda:
            torch.cuda.synchronize()
        if self.stage:
            self._check_operands(index, entry, where, operands)
        outs = []
        for label, st in operands:
            if st.role == "output":
                v = st.view
                outs.append((label, v.view(_TORCH_BITS[v.dtype.itemsize])
                             .clone()))
        self.launches.append(LaunchRecord(entry, unit, outs))
        self.pending.clear()
        return rc

    def _check_operands(self, index, entry, where, operands):
        """K101 (write) on every band, K109 on every input: the device
        buffers first in one reduction (one synchronization), the ones it
        flags and the host arrays then element by element."""
        tensors = [st for _, st in operands
                   if isinstance(st.view, torch.Tensor)]
        quick = []
        for st in tensors:
            bits = _TORCH_BITS[st.view.dtype.itemsize]
            pat = pattern(self.bands, st.view.dtype)
            quick.append((st.buf[:st.band].view(bits) != pat).any())
            quick.append((st.buf[st.band + st.nbytes:].view(bits)
                          != pat).any())
            if st.role == "input":
                quick.append((st.view.view(bits) != st.src.view(bits)).any())
        if quick and not bool(torch.stack(quick).any()):
            operands = [(label, st) for label, st in operands
                        if not isinstance(st.view, torch.Tensor)]
        for label, st in operands:
            size = st.view.dtype.itemsize
            for side, lo, hi in (("before", 0, st.band),
                                 ("after", st.band + st.nbytes,
                                  2 * st.band + st.nbytes)):
                bits = _bits(st.buf[lo:hi], size)
                bad = np.flatnonzero(bits != pattern(self.bands,
                                                     st.view.dtype))
                if bad.size:
                    at, edge = ((bad[-1] + 1 - bits.size, "start")
                                if side == "before" else (bad[0], "end"))
                    self._find(index, Finding(
                        "error", where, "K101",
                        f"launch {index} ({entry}): a write to the band "
                        f"{side} {label} ({st.role}) at byte offset "
                        f"{at * size:+d} from its {edge}, {bad.size} "
                        f"element(s) changed"))
            if st.role == "input":
                now, was = _bits(st.view, size), _bits(st.src, size)
                bad = np.flatnonzero(now.reshape(-1) != was.reshape(-1))
                if bad.size:
                    self._find(index, Finding(
                        "error", where, "K109",
                        f"launch {index} ({entry}): input {label} written "
                        f"at {bad.size} element(s), first at flat index "
                        f"{bad[0]}"))

    def _find(self, index: int, f: Finding) -> None:
        self.findings.append((index, f))

    def proxy(self, lib) -> "_Proxy":
        """``lib`` as ``_build.library()`` returns it in this run."""
        return _Proxy(lib, self)


def _bits(x, size: int) -> np.ndarray:
    """The bit view of tensor or array ``x`` as a flat numpy array."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(_TORCH_BITS[size]).cpu().numpy()
    return np.asarray(x).reshape(-1).view(_NP_BITS[size])


class _Proxy:
    """The kernel library under guard mode: each C entry that takes a
    pointer goes through ``run.launch``."""

    def __init__(self, lib, run: Run):
        self._lib, self._run = lib, run

    def __getattr__(self, name):
        fn = getattr(self._lib, name)
        if name not in arg_names() or not arg_names()[name]:
            return fn
        return lambda *args: self._run.launch(name, fn, args)


@contextlib.contextmanager
def guarded(bands: str = "A", fill: str = "S1", *, stage: bool = True,
            case: str = "case"):
    """Guard mode: while it is on, the wrappers' allocations and operands
    lie in guarded buffers (bands ``A`` or ``B``, fresh outputs prefilled
    with ``S1`` or ``S2``) and every launch is checked.  ``stage=False``
    is the unguarded run: the wrappers' own tensors, each launch's
    outputs recorded.  Yields the :class:`Run`."""
    if common._guard is not None:
        raise RuntimeError("guard mode is already on")
    run = Run(case, bands, fill, stage)
    common._guard = run
    try:
        yield run
    finally:
        common._guard = None


# -- comparing the runs ---------------------------------------------------------


def _first_diff(a: List[LaunchRecord], b: List[LaunchRecord]):
    """The first launch (index, output index) where runs ``a`` and ``b``
    differ, or None; a launch sequence that differs is reported at the
    first launch that is not the same entry with the same outputs."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x.entry != y.entry or len(x.outputs) != len(y.outputs):
            return i, None
        for k, ((_, u), (_, v)) in enumerate(zip(x.outputs, y.outputs)):
            if u.shape != v.shape or not torch.equal(u, v):
                return i, k
    if len(a) != len(b):
        return min(len(a), len(b)), None
    return None


def _where(bits, flat: int) -> str:
    idx = np.unravel_index(int(flat), tuple(bits.shape)) if bits.dim() else ()
    return f"element {tuple(int(i) for i in idx)}"


def compare(case: str, runs: Sequence[Run], plain: Run) -> List[Finding]:
    """The findings of one case's four guarded runs and its unguarded run:
    each run's own (K101 write, K109, K111; each once) and those of the
    comparisons (K110 repeat, K101 read, K102, K110 placement), each at
    the first launch its comparison differs, and not where a higher rule
    already explains that launch or an earlier one."""
    r1, r2, r3, r4 = runs
    out: Dict[Tuple, Finding] = {}
    hit = []  # the launches a finding explains
    for run in runs:
        for i, f in run.findings:
            out.setdefault((f.rule, f.detail), f)
            hit.append(i)

    def launch_of(i):
        rec = r1.launches[i] if i < len(r1.launches) else None
        return (rec.unit, rec.entry) if rec else ("-", "-")

    def add(rule, i, text):
        unit, entry = launch_of(i)
        f = Finding("error", f"guard:{case}:{unit}", rule,
                    f"launch {i} ({entry}): {text}")
        out.setdefault((rule, f.detail), f)

    def before(i, j):
        return j is not None and j <= i

    d4 = _first_diff(r1.launches, r4.launches)
    repeat = None if d4 is None else d4[0]
    if d4 is not None:
        i, k = d4
        add("K110", i, _label(r1, i, k)
            + " differs between two runs under the same conditions: a "
              "repeated launch is not bit for bit the same")
        hit.append(i)
    d2 = _first_diff(r1.launches, r2.launches)
    if d2 is not None and not before(d2[0], repeat):
        i, k = d2
        add("K101", i, _label(r1, i, k)
            + " changes with the guard bands' contents: the kernel read "
              "a guard band")
        hit.append(i)
    d3 = _first_diff(r1.launches, r3.launches)
    if d3 is not None and not before(d3[0], repeat):
        i, k = d3
        hit.append(i)
        if k is None:
            add("K102", i, "the launch sequence changes with the fill of "
                           "fresh outputs and scratch")
        else:
            label, a = r1.launches[i].outputs[k]
            b = r3.launches[i].outputs[k][1]
            s1, s2 = pattern("S1", a.dtype), pattern("S2", a.dtype)
            diff = a != b
            never = diff & (a == s1) & (b == s2)
            n_never, n_diff = int(never.sum()), int(diff.sum())
            if n_never:
                add("K102", i, f"{label}: {n_never} element(s) never "
                    f"written, first at "
                    f"{_where(a, int(never.reshape(-1).nonzero()[0]))}")
            if n_diff > n_never:
                other = (diff & ~never).reshape(-1).nonzero()[0]
                add("K102", i, f"{label}: {n_diff - n_never} element(s) "
                    f"depend on the fill of fresh outputs and scratch, "
                    f"first at {_where(a, int(other))}: an output or its "
                    f"scratch read before it was written")
    d0 = _first_diff(r1.launches, plain.launches)
    if d0 is not None and not any(before(d0[0], j) for j in hit):
        i, k = d0
        if k is not None and _nan_from_fill(r1.launches[i].outputs[k][1],
                                            plain.launches[i].outputs[k][1]):
            add("K102", i, _label(r1, i, k) + " holds NaNs where the "
                "unguarded launch does not: arithmetic on the fill of "
                "fresh outputs or scratch, read before it was written")
        else:
            add("K110", i, _label(r1, i, k) + " differs from the unguarded "
                "launch: the result depends on where the buffers sit")
    return list(out.values())


def _label(run: Run, i: int, k: Optional[int]) -> str:
    if k is None or i >= len(run.launches):
        return "the launch sequence"
    return run.launches[i].outputs[k][0]


def _nan_from_fill(a, b) -> bool:
    """True when bit views ``a`` (run 1) and ``b`` (unguarded) differ only
    where ``a`` holds a NaN and ``b`` does not."""
    if a.dtype not in (torch.int16, torch.int32, torch.int64):
        return False
    fdt = {torch.int16: torch.bfloat16, torch.int32: torch.float32,
           torch.int64: torch.float64}[a.dtype]
    fa, fb = a.view(fdt), b.view(fdt)
    diff = a != b
    return bool((diff & fa.isnan() & ~fb.isnan()).any()) and bool(
        (~diff | fa.isnan()).all())


RUNS = (("A", "S1"), ("B", "S1"), ("A", "S2"), ("A", "S1"))


def check_case(case: str, fn: Callable[[], object]
               ) -> Tuple[List[Finding], List[str]]:
    """Run ``fn`` (a callable that launches kernels through the wrappers)
    four times in guard mode and once unguarded; returns the findings and
    the units run 1 launched, in launch order."""
    runs = []
    for bands, fill in RUNS:
        with guarded(bands, fill, case=case) as run:
            fn()
        runs.append(run)
    with guarded(stage=False, case=case) as plain:
        fn()
    return compare(case, runs, plain), [r.unit for r in runs[0].launches]


def guard_table(findings: Iterable[Finding], launched: Iterable[str],
                units: Sequence[str]) -> Dict[str, Dict[str, str]]:
    """``{unit: {rule: reading}}``: ``clean``, the number of findings, or
    ``not run`` for a unit no case launched."""
    launched = set(launched)
    counts: Dict[Tuple[str, str], int] = {}
    for f in findings:
        if f.rule in RULES:
            unit = f.step.rsplit(":", 1)[-1]
            counts[unit, f.rule] = counts.get((unit, f.rule), 0) + 1
    return {u: {r: ("not run" if u not in launched else
                    str(counts[u, r]) if (u, r) in counts else "clean")
                for r in RULES} for u in units}


def table_markdown(table: Dict[str, Dict[str, str]]) -> str:
    rows = ["| unit | " + " | ".join(RULES) + " |",
            "| --- |" + " --- |" * len(RULES)]
    rows += [f"| {u} | " + " | ".join(cols[r] for r in RULES) + " |"
             for u, cols in table.items()]
    return "\n".join(rows)

"""Static plan verifier: prove an ``ExecutionPlan``'s geometry on paper.
The port of ``repro.analysis.verifier``.

``verify_plan(plan)`` walks the compiled ``PlanStep``s and checks, with
no kernel execution:

* **shape flow** (V1xx) — every step's output shape re-derives from its
  input shape and layer spec (V101), consecutive steps chain (V102) and
  conv/fc parameter geometry matches ``infer_param_shapes`` (V103);
* **launch geometry** (V2xx) — for every step that launches a conv or
  pool kernel, at every batch of ``batches``, the geometry its wrapper
  would launch is read through the same functions the dispatch runs
  (``step_launch_geometry``: ``core.methods.fused_cell``/``chain_cell``
  pick the kernel; ``conv_ops.stage_major_geometry`` → ``chain_launch``
  → ``chain_plan`` for K1, K2, K4, K5 and K6; ``k7_geometry`` →
  ``k7_launch`` for K7; ``k8_geometry`` → ``k8_launch`` for K8;
  ``pool_geometry`` → ``pool_plan`` for K9), never re-derived, and
  proven to cover every output once (V201), to stage every row its
  windows read (V203) and to agree with the arrays packed for the kernel
  (V205);
* **shared memory, scratch, grid** (V3xx) — a block's dynamic shared
  memory within the card's 227-KB opt-in limit (V301), the stage-major
  scratch within its 32-bit offsets and a unit's partials within
  ``CH_PARTIAL_BYTES`` (V302), a launch that has no geometry at all
  (V303: its ``ValueError`` becomes this finding), and the cooperative
  grid within the blocks an SM holds (V304).

The plan carries no batch, so the geometry rules run at every batch of
``batches`` (default 1, 2, 4, 8 and 16: the serving buckets of
``max_batch`` 16) on ``sms`` SMs (default 132, an H100 SXM's): the
stage-major schedule follows both.  ``CNNEngine.verify`` passes its
buckets and, on the card, its SM count.

Severity follows the JAX verifier's budget rule: every finding is an
``error``, but a V3xx finding of a step whose cell a user pinned
(``per_layer_pool_carry``, ``per_layer_lrn_oc_block``,
``per_layer_oc_block_final``) is a ``warning``.  A cell that cannot take
its step at all (K6 with an LRN tail raises on every device) is an
``error`` whatever pinned it.

``compile_plan(verify=True)`` — the default — raises
``PlanVerificationError`` on any error finding, so every engine, deploy
load and server checks its plan before a batch arrives.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.analysis.findings import (  # noqa: F401  (re-exported)
    Finding,
    PlanVerificationError,
)
from repro_torch.core import methods
from repro_torch.core.fusion import _conv_out_hw, _pool_out_hw
from repro_torch.core.plan import (ExecutionPlan, PlanStep, call_kwargs,
                                   infer_param_shapes)
from repro_torch.kernels.common import Launch, LaunchGeometryError
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.pool2d import ops as pool_ops

#: the batches and SMs the geometry rules run at by default
DEFAULT_BATCHES: Tuple[int, ...] = (1, 2, 4, 8, 16)
DEFAULT_SMS = 132
#: an H100's shared memory: the most dynamic shared memory a block may
#: opt in to, an SM's, the runtime's reserve a block, threads an SM
SMEM_OPTIN = 227 * 1024
SM_SMEM = 228 * 1024
BLOCK_RESERVED = 1024
SM_THREADS = 2048
#: the stage-major cells (``csrc/conv_chain.cu``)
STAGE_MAJOR = ("K1", "K2", "K4", "K5", "K6")
#: a launch function's LaunchGeometryError kind -> its rule
_ERROR_RULES = {"smem": "V301", "scratch": "V302", "floor": "V303"}
#: the step knobs that pin a fused or chain step's cell
_PINNED = ("pool_carry", "lrn_oc_block", "oc_block_final")

Rules = List[Tuple[str, str]]


def step_launch_geometry(plan: ExecutionPlan, step: PlanStep, batch: int,
                         sms: int, shapes: Optional[dict] = None
                         ) -> Optional[Tuple[str, Launch]]:
    """``(kernel id, launch)``: the kernel the step's executor reaches at
    ``batch`` frames on ``sms`` SMs and the launch geometry its wrapper
    computes, read through the dispatch's own functions; None for steps
    that launch no conv or pool kernel (flatten, fc, lrn, relu, softmax,
    a ``SEQ_REF`` conv).  Raises what the launch functions raise."""
    if step.kind not in ("conv", "fused", "chain", "pool"):
        return None
    shapes = shapes if shapes is not None else infer_param_shapes(plan.net)
    kw = call_kwargs(step)
    if step.kind == "conv":
        return methods.conv_geometry(step.method, batch, step.in_shape,
                                     shapes[step.spec.name], sms, **kw)
    if step.kind == "fused":
        return methods.fused_geometry(step.method, batch, step.in_shape,
                                      shapes[step.group.conv.name], sms, **kw)
    if step.kind == "chain":
        return methods.chain_geometry(
            step.method, batch, step.in_shape,
            [shapes[cv.name] for cv in step.group.convs], sms, **kw)
    c, h, w = step.in_shape
    return "K9", pool_ops.pool_geometry(batch, c, h, w, kw["kernel"],
                                        kw["stride"])


def launch_smem(kid: str, launch: Launch) -> int:
    """Dynamic shared memory a block of the launch takes, in bytes."""
    if kid in STAGE_MAJOR:
        return conv_ops.CH_SMEM
    if kid in ("K7", "K8"):
        return launch.geometry[1] if kid == "K7" else launch.geometry[2]
    return 0


# -- the rules over one launch ------------------------------------------------

_MEMO: Dict[tuple, Rules] = {}


def clear_caches() -> None:
    """Drop the memoized rule results and the wrappers' launch memos (a
    test that patches a launch function calls it before and after)."""
    _MEMO.clear()
    for fn in (conv_ops.chain_launch, conv_ops.k7_launch, conv_ops.k8_launch):
        fn.cache_clear()


def launch_rules(kid: str, launch: Launch) -> Rules:
    """``(rule, detail)`` for every V2xx/V3xx rule the launch breaks
    (memoized per launch: the same call signature has the same
    geometry)."""
    key = (kid, launch.fn, launch.args)
    if key not in _MEMO:
        if kid in STAGE_MAJOR:
            _MEMO[key] = _stage_major_rules(kid, launch)
        elif kid == "K7":
            _MEMO[key] = _k7_rules(launch)
        elif kid == "K8":
            _MEMO[key] = _k8_rules(launch)
        else:
            _MEMO[key] = _k9_rules(launch)
    return _MEMO[key]


def _geo_rules(geo: np.ndarray, n: int, stages, pool, pool_relu: bool, lrn,
               blk: int, tail: int = 0) -> Rules:
    """V205: ``geo[]`` decoded in the layout ``read_geo`` reads, field by
    field against the stages and tail it was packed from."""
    total, out_h, out_w = conv_ops.final_rows(stages, pool)
    want = [n, len(stages),
            conv_ops.POOL_CODES[pool.kind] if pool is not None else 0,
            *((pool.kh, pool.kw, pool.sy, pool.sx) if pool is not None
              else (1, 1, 1, 1)),
            int(pool_relu), lrn[0] if lrn is not None else 0, blk,
            -(-total // blk), total, out_h, out_w]
    names = ["N", "n_stages", "pool_kind", "pkh", "pkw", "psy", "psx",
             "pool_relu", "lrn_n", "blk", "n_tiles", "total", "out_h",
             "out_w"]
    for st in stages:
        want += [st.C, st.H, st.W, st.OC, st.KH, st.KW, st.sy, st.sx, st.py,
                 st.px, int(st.relu), st.OH, st.OW]
    for s in range(len(stages)):
        names += [f"stage{s}.{f}" for f in ("C", "H", "W", "OC", "KH", "KW",
                                             "sy", "sx", "py", "px", "relu",
                                             "OH", "OW")]
    got = [int(v) for v in geo]
    if len(got) != len(want) + tail:
        return [("V205", f"geo holds {len(got)} ints, the layout "
                 f"{len(want) + tail}")]
    bad = [f"{nm} {g} != {w}" for nm, g, w in zip(names, got, want) if g != w]
    return [("V205", "geo " + ", ".join(bad))] if bad else []


def _band_rules(stages, pool, blk: int, n_tiles: int) -> Rules:
    """V203: the rows ``band_rows`` gives each stage of every block hold
    every row the next stage's windows (or the pool's, or the final
    rows) read, clipped to the stage's output, and lie inside it."""
    total = conv_ops.final_rows(stages, pool)[0]
    out: Rules = []
    for t in range(n_tiles):
        rows = conv_ops.band_rows(stages, pool, blk, t)
        f0, f1 = t * blk, min((t + 1) * blk, total)
        if pool is not None:
            need = (f0 * pool.sy, (f1 - 1) * pool.sy + pool.kh)
        else:
            need = (f0, f1)
        for s in range(len(stages) - 1, -1, -1):
            st = stages[s]
            a, b = rows[s]
            lo, hi = max(0, need[0]), min(st.OH, need[1])
            if not (0 <= a <= lo and hi <= b <= st.OH):
                out.append(("V203", f"block {t}: stage {s} computes output "
                            f"rows [{a}, {b}) of [0, {st.OH}), its readers "
                            f"need [{lo}, {hi})"))
                return out
            if s:
                need = (a * st.sy - st.py, (b - 1) * st.sy - st.py + st.KH)
    return out


def _stage_major_rules(kid: str, launch: Launch) -> Rules:
    n, _, _, _, _, _, pool, pool_relu, lrn, sms, obf = launch.args
    stages, plan, arrays, ptrs = launch.geometry
    out: Rules = []
    tp, to = conv_ops.ST_TP, conv_ops.ST_TO
    # V201: every stage's items walked as the kernel walks them (pixel
    # tile fastest, then channel block, then partial), its chunks over
    # the taps; the scratch regions apart
    regions = [(0, n * stages[0].H * stages[0].W
                * conv_ops._round4(stages[0].C), "input")]
    for s, (st, sp) in enumerate(zip(stages, plan.stages)):
        n_ot = math.ceil(sp.ocp / to)
        chunks = st.KH * sp.tpr * sp.split
        cover = []
        if sp.m != n * st.OH * st.OW or not (
                (sp.tiles_m - 1) * tp < sp.m <= sp.tiles_m * tp):
            cover.append(f"{sp.tiles_m} pixel tiles for {n * st.OH * st.OW} "
                         f"pixels")
        if sp.ocp != conv_ops._round4(st.OC):
            cover.append(f"{sp.ocp} channels for {st.OC}")
        width = sp.chunk_slots * conv_ops.CH_CK
        if not (sp.chunk_slots <= conv_ops.CH_CHUNK_SLOTS
                and (sp.split - 1) * width < sp.tw <= sp.split * width):
            cover.append(f"{sp.split} chunks of {width} floats for a tap of "
                         f"{sp.tw}")
        item = np.arange(sp.items)
        mt, rest = item % sp.tiles_m, item // sp.tiles_m
        ob, q = rest % sp.o_items, rest // sp.o_items
        part = np.zeros((sp.n_partials, sp.tiles_m, n_ot), dtype=np.int64)
        cov = np.zeros((chunks, sp.tiles_m, n_ot), dtype=np.int64)
        if (q >= sp.n_partials).any() or sp.n_partials * sp.unit > chunks:
            cover.append(f"{sp.items} items write partials past "
                         f"{sp.n_partials}")
        else:
            for j in range(sp.ot_item):
                ot = ob * sp.ot_item + j
                keep = ot < n_ot
                np.add.at(part, (q[keep], mt[keep], ot[keep]), 1)
                for u in range(sp.unit):
                    np.add.at(cov, (q[keep] * sp.unit + u, mt[keep],
                                    ot[keep]), 1)
            if not (part == 1).all():
                cover.append(f"(partial, pixel tile, channel tile) written "
                             f"{int(part.min())}-{int(part.max())} times")
            if not (cov == 1).all():
                cover.append(f"(chunk, pixel tile, channel tile) summed "
                             f"{int(cov.min())}-{int(cov.max())} times")
        if sp.whole != (sp.unit == chunks):
            cover.append(f"whole {sp.whole} with {sp.unit} of {chunks} "
                         f"chunks an item")
        if cover:
            out.append(("V201", f"stage {s}: " + "; ".join(cover)))
        if sp.act_off >= 0:
            regions.append((sp.act_off, sp.act_off + sp.m * sp.ocp,
                            f"stage {s}"))
    regions.append((plan.part_off, plan.scratch, "partials"))
    regions.sort()
    for (a0, a1, an), (b0, _, bn) in zip(regions, regions[1:]):
        if a1 > b0:
            out.append(("V201", f"scratch of {an} [{a0}, {a1}) overlaps "
                        f"{bn} at {b0}"))
    _, out_h, out_w = conv_ops.final_rows(stages, pool)
    want_tail = n * out_h * out_w if pool is not None else 0
    if plan.tail_items != want_tail:
        out.append(("V201", f"{plan.tail_items} tail items for "
                    f"{want_tail} pooled pixels"))
    # V203: the whole frame is the one band of every stage
    total = conv_ops.final_rows(stages, pool)[0]
    out += _band_rules(stages, pool, total, 1)
    # V205: the arrays the C entry reads, field by field
    geo, lrn_f, plan_arr = arrays[:3]
    out += _geo_rules(geo, n, stages, pool, pool_relu, lrn, total)
    want_lrn = list(lrn[1:]) if lrn is not None else [0.0, 0.0, 1.0]
    if not np.array_equal(lrn_f, np.float32(want_lrn)):
        out.append(("V205", f"lrn {list(lrn_f)} != {want_lrn}"))
    want_plan = [plan.grid, plan.part_off] + [
        v for sp in plan.stages for v in (sp.unit, sp.ot_item, sp.act_off)]
    if [int(v) for v in plan_arr] != want_plan:
        out.append(("V205", f"plan {[int(v) for v in plan_arr]} != "
                    f"{want_plan}"))
    ocb = conv_ops.k6_ocb(obf) if obf is not None else None
    if (kid == "K6") != (len(arrays) == 4) or (kid == "K6") != (
            ocb is not None):
        out.append(("V205", f"{kid} with {len(arrays) - 3} tile arrays and "
                    f"oc_block_final {obf}"))
    elif ocb is not None:
        want_tile = [ocb, math.ceil(stages[-1].OC / ocb)]
        if ([int(v) for v in arrays[3]] != want_tile
                or plan.stages[-1].ot_item != math.ceil(ocb / to)):
            out.append(("V205", f"tile {[int(v) for v in arrays[3]]} != "
                        f"{want_tile} or final items of "
                        f"{plan.stages[-1].ot_item} channel tiles"))
    if ptrs != tuple(a.ctypes.data for a in arrays):
        out.append(("V205", "the pointers handed to the C entry are not "
                    "the packed arrays'"))
    want_barriers = sum(1 if sp.whole else 2 for sp in plan.stages) + (
        pool is not None)
    if plan.barriers != want_barriers:
        out.append(("V205", f"{plan.barriers} grid barriers, the schedule "
                    f"takes {want_barriers}"))
    for s, st in enumerate(stages):
        tw_tpr = conv_ops.tap_walk(st)
        sp = plan.stages[s]
        if (sp.tw, sp.tpr) != tw_tpr or sp.split != conv_ops.tap_split(sp.tw):
            out.append(("V205", f"stage {s} walks taps ({sp.tw}, {sp.tpr}) "
                        f"in {sp.split} chunks, the kernel {tw_tpr}"))
    # V301: the block's shared memory; V302: scratch and partials
    if conv_ops.CH_SMEM > SMEM_OPTIN:
        out.append(("V301", f"a block takes {conv_ops.CH_SMEM} B of shared "
                    f"memory > {SMEM_OPTIN} B"))
    if plan.scratch >= conv_ops.CH_SCRATCH_LIMIT:
        out.append(("V302", f"scratch of {plan.scratch} floats is past the "
                    f"kernel's 32-bit offsets"))
    for s, (st, sp) in enumerate(zip(stages, plan.stages)):
        row = sp.tpr * sp.split
        chunks = st.KH * row
        if (sp.unit not in (row, chunks)
                and 4 * sp.part > conv_ops.CH_PARTIAL_BYTES):
            out.append(("V302", f"stage {s}: items of {sp.unit} chunks "
                        f"write {4 * sp.part} B of partials > "
                        f"{conv_ops.CH_PARTIAL_BYTES}"))
    # V304: the cooperative grid is resident at once
    per_sm = min(SM_SMEM // (conv_ops.CH_SMEM + BLOCK_RESERVED),
                 SM_THREADS // conv_ops.CH_THREADS)
    if conv_ops.CH_MIN_BLOCKS > per_sm or plan.grid > per_sm * sms:
        out.append(("V304", f"grid of {plan.grid} blocks "
                    f"({conv_ops.CH_MIN_BLOCKS} an SM) on {sms} SMs, which "
                    f"hold {per_sm} an SM"))
    return out


def _k7_rules(launch: Launch) -> Rules:
    n, _, _, _, _, _, pool, pool_relu, lrn = launch.args
    stages, smem, geo, lrn_f = launch.geometry
    st = stages[0]
    out: Rules = []
    blk = 1  # k7_launch packs one final row a block
    out += _geo_rules(geo, n, stages, pool, pool_relu, lrn, blk, tail=2)
    groups, ring_off = int(geo[-2]), int(geo[-1])
    total = conv_ops.final_rows(stages, pool)[0]
    if pool is None:
        # the per-layer kernel: (pixel tiles x N, channel tiles) blocks of
        # one ring, sized by the C entry from geo
        if (groups, ring_off) != (1, 0) or smem != 4 * conv_ops.K7_RING:
            out.append(("V205", f"per-layer tail ({groups}, {ring_off}) "
                        f"and {smem} B, the kernel takes one ring"))
    else:
        # the fused kernel: one block a pooled row of a frame
        n_tiles = int(geo[10])
        if not ((n_tiles - 1) * blk < total <= n_tiles * blk):
            out.append(("V201", f"{n_tiles} blocks of {blk} pooled rows "
                        f"for {total}"))
        out += _band_rules(stages, pool, blk, min(n_tiles, total))
        band = (st.OC * ((blk - 1) * pool.sy + pool.kh) * st.OW
                + (st.OC * blk * conv_ops.final_rows(stages, pool)[2]
                   if lrn is not None else 0))
        if not (1 <= groups <= conv_ops.K7_MAX_GROUPS and ring_off >= band
                and ring_off % 4 == 0
                and smem >= 4 * (ring_off + groups * conv_ops.K7_RING)):
            out.append(("V205", f"{groups} tile groups at ring offset "
                        f"{ring_off} in {smem} B, after a band of {band} "
                        f"floats"))
    if smem > SMEM_OPTIN:
        out.append(("V301", f"a block takes {smem} B of shared memory > "
                    f"{SMEM_OPTIN} B"))
    return out


def _k8_rules(launch: Launch) -> Rules:
    n, _, w_shape, _, _, relu = launch.args
    st, dims, smem, grid = launch.geometry
    out: Rules = []
    want = [n, *st[:10], st.OH, st.OW, int(relu)]
    got = [int(v) for v in dims]
    cc = got[-1] if len(got) == len(want) + 1 else 0
    if got[:-1] != want or not 1 <= cc <= st.C:
        out.append(("V205", f"dims {got} != {want} + [cc]"))
    elif smem != 2 * 4 * conv_ops.k8_stage(st, cc):
        out.append(("V205", f"{smem} B for two stages of {cc} channels"))
    p_all = st.OH * st.OW
    n_pt, n_ot = math.ceil(p_all / conv_ops.ST_TP), math.ceil(st.OC /
                                                              conv_ops.ST_TO)
    if tuple(grid) != (n_pt * n, n_ot):
        out.append(("V201", f"grid {tuple(grid)} for {n} frames of {n_pt} "
                    f"pixel tiles and {n_ot} channel tiles"))
    # V203: the tallest tile's input rows (a tile: ST_TP row-major output
    # pixels of one frame)
    p0 = np.arange(0, p_all, conv_ops.ST_TP)
    r0, r1 = p0 // st.OW, (np.minimum(p0 + conv_ops.ST_TP, p_all) - 1) // st.OW
    need = int(((r1 - r0) * st.sy).max()) + st.KH
    have = conv_ops.k8_halo_rows(st)
    if have < need:
        out.append(("V203", f"k8_halo_rows {have} < the {need} input rows "
                    f"a tile reads"))
    if smem > SMEM_OPTIN:
        out.append(("V301", f"a block takes {smem} B of shared memory > "
                    f"{SMEM_OPTIN} B"))
    return out


def _k9_rules(launch: Launch) -> Rules:
    n, c, h, w, kernel, stride = launch.args
    oh, ow, plan = launch.geometry
    out: Rules = []
    want = ((h - kernel[0]) // stride[0] + 1, (w - kernel[1]) // stride[1] + 1)
    planes = n * c
    if (oh, ow) != want or plan.per_plane != oh * ow:
        out.append(("V205", f"output {oh}x{ow} ({plan.per_plane} a plane) "
                    f"!= {want[0]}x{want[1]}"))
    if not (plan.ppb >= 1 and (plan.blocks - 1) * plan.ppb < planes
            <= plan.blocks * plan.ppb):
        out.append(("V201", f"{plan.blocks} blocks of {plan.ppb} planes for "
                    f"{planes}"))
    return out


# -- shape flow -----------------------------------------------------------------


def _derived_out_shape(step: PlanStep) -> Optional[Tuple[int, ...]]:
    cur = tuple(step.in_shape)
    if step.kind == "conv":
        _, h, w = cur
        h, w = _conv_out_hw(h, w, step.spec)
        return (step.spec.out_channels, h, w)
    if step.kind in ("fused", "chain"):
        _, h, w = cur
        for cv in step.group.convs:
            h, w = _conv_out_hw(h, w, cv)
        if step.group.pool is not None:
            h, w = _pool_out_hw(h, w, step.group.pool)
        return (step.group.convs[-1].out_channels, h, w)
    if step.kind == "pool":
        c, h, w = cur
        h, w = _pool_out_hw(h, w, step.spec)
        return (c, h, w)
    if step.kind == "flatten":
        return ((int(cur[0] * cur[1] * cur[2]),) if len(cur) == 3 else cur)
    if step.kind == "fc":
        return (step.spec.out_channels,)
    if step.kind in ("lrn", "relu", "softmax"):
        return cur
    return None


def _shape_findings(step: PlanStep, label: str, cur: Tuple[int, ...],
                    shapes: dict) -> List[Finding]:
    findings: List[Finding] = []
    if tuple(step.in_shape) != tuple(cur):
        findings.append(Finding(
            "error", label, "V102",
            f"step input shape {tuple(step.in_shape)} != upstream "
            f"activation {tuple(cur)}"))
    want = _derived_out_shape(step)
    if want is not None:
        if any(d < 1 for d in want):
            findings.append(Finding(
                "error", label, "V101",
                f"derived output shape {want} has a non-positive dim "
                f"(kernel/pool larger than its input)"))
        elif tuple(step.out_shape) != want:
            findings.append(Finding(
                "error", label, "V101",
                f"step output shape {tuple(step.out_shape)} != derived "
                f"{want}"))
    # parameter geometry vs infer_param_shapes
    if step.kind == "conv":
        kh, kw = step.spec.kernel
        want_w = (step.spec.out_channels, step.in_shape[0], kh, kw)
        if shapes.get(step.spec.name) != want_w:
            findings.append(Finding(
                "error", label, "V103",
                f"conv {step.spec.name} weight {shapes.get(step.spec.name)} "
                f"!= step-derived {want_w}"))
    elif step.kind in ("fused", "chain"):
        c = step.in_shape[0]
        for cv in step.group.convs:
            kh, kw = cv.kernel
            want_w = (cv.out_channels, c, kh, kw)
            if shapes.get(cv.name) != want_w:
                findings.append(Finding(
                    "error", label, "V103",
                    f"conv {cv.name} weight {shapes.get(cv.name)} != "
                    f"step-derived {want_w}"))
            c = cv.out_channels
    elif step.kind == "fc":
        d_in = (int(step.in_shape[0] * step.in_shape[1] * step.in_shape[2])
                if len(step.in_shape) == 3 else int(step.in_shape[0]))
        want_w = (d_in, step.spec.out_channels)
        if step.d_in != d_in or shapes.get(step.spec.name) != want_w:
            findings.append(Finding(
                "error", label, "V103",
                f"fc {step.spec.name}: weight {shapes.get(step.spec.name)} "
                f"/ step d_in {step.d_in} != step-derived {want_w}"))
    return findings


# -- the plan -------------------------------------------------------------------


def _geometry_findings(plan: ExecutionPlan, step: PlanStep, label: str,
                       batches: Sequence[int], sms: int,
                       shapes: dict) -> List[Finding]:
    pinned = any((step.kwargs or {}).get(k) is not None for k in _PINNED)
    budget_sev = "warning" if pinned else "error"
    findings: List[Finding] = []
    for n in batches:
        try:
            got = step_launch_geometry(plan, step, n, sms, shapes)
        except LaunchGeometryError as e:
            findings.append(Finding(budget_sev, label, _ERROR_RULES[e.kind],
                                    f"batch {n}: {e}"))
            continue
        except ValueError as e:
            # the cell cannot take the step at all (K6 with an LRN tail):
            # an error whoever pinned it
            findings.append(Finding("error", label, "V303",
                                    f"batch {n}: {e}"))
            continue
        if got is None:
            return findings
        kid, launch = got
        for rule, detail in launch_rules(kid, launch):
            sev = budget_sev if rule.startswith("V3") else "error"
            findings.append(Finding(sev, label, rule,
                                    f"{kid} batch {n}: {detail}"))
    return findings


def verify_plan(plan: ExecutionPlan, net=None, input_shape=None, *,
                batches: Sequence[int] = DEFAULT_BATCHES,
                sms: int = DEFAULT_SMS) -> List[Finding]:
    """All findings for ``plan``, most severe first.  ``net`` /
    ``input_shape`` default to the plan's own — pass them to check a
    plan against an independently trusted definition.  The geometry rules
    run at every batch of ``batches`` on ``sms`` SMs, on every step whose
    shape flow holds."""
    net = net if net is not None else plan.net
    cur: Tuple[int, ...] = tuple(input_shape if input_shape is not None
                                 else net.input_shape)
    shapes = infer_param_shapes(net)
    findings: List[Finding] = []
    for idx, step in enumerate(plan.steps):
        label = f"step{idx}:{'+'.join(step.names)}"
        flow = _shape_findings(step, label, cur, shapes)
        findings += flow
        if not any(f.severity == "error" for f in flow):
            findings += _geometry_findings(plan, step, label, batches, sms,
                                           shapes)
        cur = tuple(step.out_shape)
    # headless nets end wherever they end; a classifier tail must land
    # exactly on the class distribution
    if (plan.steps and plan.steps[-1].kind in ("fc", "softmax")
            and tuple(cur) != (net.num_classes,)):
        findings.append(Finding(
            "warning", "plan", "V102",
            f"final activation {tuple(cur)} != (num_classes="
            f"{net.num_classes},)"))
    order = {"error": 0, "warning": 1, "info": 2}
    findings.sort(key=lambda f: order[f.severity])
    return findings

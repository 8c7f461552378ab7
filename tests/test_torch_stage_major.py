"""The port's kernel modules on the CPU, against their JAX counterparts.

The stage-major schedule of ``csrc/conv_stage_major.cuh`` that K1,
K2, K4, K5 and K6 launch: its items, sum order, grid, kernel-row walk
and a plain emulation of it at small shapes.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
import math
import re
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methods as jm
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import ops as conv_ops
from torch_kernels_common import (
    ALEX_CHAIN,
    K1_CASES,
    K2_CASES,
    NARROW,
    POOL32,
    REPORT_SMS,
    SCHEDULES,
    _Entry,
    _arr,
    _chain_constants,
    _chain_items,
    _close,
    _emulate_chain,
    _fold,
    _jit,
    _k1_inputs,
    _k2_inputs,
    _round4,
    _stages,
    _sum_order,
    _t,
    _units,
    _walk_rows,
)


def test_chain_constants_match_the_wrapper():
    """The wrapper's copies of the stage-major kernels' constants, its plan
    array's layout, its shared memory and the entry points' argument
    lists agree with the sources."""
    c = _chain_constants()
    assert (c["CH_THREADS"], c["CH_MIN_BLOCKS"], c["CH_CK"], c["CH_AROW"],
            c["CH_CHUNK_SLOTS"]) == (
        conv_ops.CH_THREADS, conv_ops.CH_MIN_BLOCKS, conv_ops.CH_CK,
        conv_ops.CH_AROW, conv_ops.CH_CHUNK_SLOTS)
    slot = conv_ops.ST_TP * c["CH_AROW"] + c["CH_CK"] * conv_ops.ST_BROW
    assert conv_ops.CH_RING == 2 * slot
    assert conv_ops.CH_SMEM == 4 * (2 * slot + conv_ops.ST_TP
                                    * conv_ops.ST_TO + 3 * conv_ops.ST_TP)
    plan = conv_ops.chain_plan(ALEX_CHAIN, POOL32, 2, 132)
    arr = conv_ops.pack_chain_plan(plan)
    assert len(arr) == c["CH_PLAN_HEAD"] + 3 * c["CH_PLAN_STAGE"]
    for entry in ("conv_chain_f32", "conv_pool_lrn_f32",
                  "conv_pool_carry_f32", "conv_pool_lrn_halo_f32"):
        assert _build.SIGNATURES[entry] == [_build._P] * 9
    assert _build.SIGNATURES["conv_chain_ocb_f32"] == [_build._P] * 10
    assert _build.SIGNATURES["stage_major_blocks_per_sm"] == []
    # one stage-major __global__, which every stage-major entry launches
    text = (_build.CSRC / "conv_chain.cu").read_text()
    assert '#include "conv_stage_major.cuh"' in text
    assert text.count("__global__ void") == 1
    assert re.search(r"__launch_bounds__\(CH_THREADS, CH_MIN_BLOCKS\)\s*"
                     r"stage_major_kernel\(", text)
    assert text.count("stage_major(g, p, x, out, scratch);") == 1
    for entry in ("conv_chain_f32", "conv_chain_ocb_f32", "conv_pool_lrn_f32",
                  "conv_pool_carry_f32", "conv_pool_lrn_halo_f32"):
        body = text[text.index(f'extern "C" int {entry}('):]
        body = body[:body.index("\n}\n")]
        assert body.count("cnnk::launch_stage_major(") == 1
    others = [p for p in _build.CSRC.glob("*.cu") if p.name != "conv_chain.cu"]
    assert not [p.name for p in others
                if "conv_stage_major.cuh" in p.read_text()]
    # the band body (the old K1's and K4's) and K5's carry loop are gone:
    # K4's entry wraps the stage-major launch once, like K1's and K5's
    assert not (_build.CSRC / "conv_pool_carry.cu").exists()
    assert not (_build.CSRC / "conv_pool_lrn.cu").exists()
    assert not [p.name for p in _build.CSRC.glob("*.cu*")
                if "conv_band(" in p.read_text()]


@pytest.mark.parametrize("chain", sorted(SCHEDULES))
@pytest.mark.parametrize("n", [1, 2, 5, 16])
def test_chain_items_cover_every_output_once(chain, n):
    """Each stage's items write every (partial, pixel tile, channel tile)
    once (a whole item: every output), and through their chunks each
    (chunk, pixel tile, channel tile) of the stage's GEMM once, the chunks
    covering every float of every tap's run; the scratch regions do not
    overlap."""
    stages, pool = SCHEDULES[chain]
    plan = conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
    regions = [(0, n * stages[0].H * stages[0].W * _round4(stages[0].C))]
    tp, to = conv_ops.ST_TP, conv_ops.ST_TO
    for st, sp in zip(stages, plan.stages):
        assert (sp.tw, sp.tpr) == conv_ops.tap_walk(st)
        chunks = st.KH * sp.tpr * sp.split
        assert sp.m == n * st.OH * st.OW and sp.ocp == _round4(st.OC)
        assert sp.unit in _units(st, sp.split, sp.tpr)
        assert sp.whole == (sp.unit == chunks)
        assert sp.n_partials * sp.unit == chunks
        # a tap's chunks: runs of chunk_slots x CH_CK floats over its run
        width = sp.chunk_slots * conv_ops.CH_CK
        assert sp.chunk_slots <= conv_ops.CH_CHUNK_SLOTS
        assert (sp.split - 1) * width < sp.tw <= sp.split * width
        assert (sp.tiles_m - 1) * tp < sp.m <= sp.tiles_m * tp
        n_ot = math.ceil(sp.ocp / to)
        part = np.zeros((sp.n_partials, sp.tiles_m, n_ot), dtype=np.int64)
        cov = np.zeros((chunks, sp.tiles_m, n_ot), dtype=np.int64)
        for px, ch, cr, q in _chain_items(st, sp):
            mt, o0, o1 = px.start // tp, ch.start // to, math.ceil(ch.stop
                                                                  / to)
            assert px == range(mt * tp, min((mt + 1) * tp, sp.m))
            assert len(ch) and ch == range(o0 * to, min(o1 * to, sp.ocp))
            assert list(cr) == list(range(q * sp.unit, (q + 1) * sp.unit))
            part[q, mt, o0:o1] += 1
            cov[cr.start:cr.stop, mt, o0:o1] += 1
        assert (part == 1).all() and (cov == 1).all()
        run = conv_ops.whole_run(sp.split, sp.tpr, st.KH)
        assert sp.part == ((sp.m * sp.ocp if chunks > run else 0) if sp.whole
                           else sp.n_partials * sp.m * sp.ocp)
        if sp.act_off >= 0:
            regions.append((sp.act_off, sp.act_off + sp.m * sp.ocp))
        assert sp.part <= plan.scratch - plan.part_off
    regions.append((plan.part_off, plan.scratch))
    regions.sort()
    assert all(a[1] <= b[0] for a, b in zip(regions, regions[1:]))
    assert all(off % 4 == 0 for off, _ in regions)
    assert (plan.stages[-1].act_off < 0) == (pool is None)
    assert plan.barriers == (sum(1 if sp.whole else 2 for sp in plan.stages)
                             + (pool is not None))


@pytest.mark.parametrize("chain", sorted(SCHEDULES))
def test_chain_sum_order_is_the_same_for_every_batch(chain):
    """The unit follows the batch; each output's sum does not: items of
    one chunk, one tap, a kernel row or the whole reduction add the chunks
    in one tree (chunks into taps, taps into rows, rows, each left to
    right), and the chunks (runs of a tap's floats) are fixed by the
    shape."""
    stages, pool = SCHEDULES[chain]
    plans = {n: conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
             for n in (1, 2, 5, 16)}
    plus = lambda a, b: ("+", a, b)  # noqa: E731
    for s, st in enumerate(stages):
        tw, tpr = conv_ops.tap_walk(st)
        split = plans[1].stages[s].split
        assert split == conv_ops.tap_split(tw)
        assert {(p.stages[s].split, p.stages[s].tpr)
                for p in plans.values()} == {(split, tpr)}
        want = _fold([_fold([_fold([(i * tpr + j) * split + k
                                    for k in range(split)], plus)
                             for j in range(tpr)], plus)
                      for i in range(st.KH)], plus)
        for unit in _units(st, split, tpr):
            assert _sum_order(st, split, tpr, unit) == want
        assert {_sum_order(st, split, tpr, p.stages[s].unit)
                for p in plans.values()} == {want}
    if chain == "alexnet":  # batch 1 takes a chunk an item, 16 a row
        assert [sp.split for sp in plans[1].stages] == [2, 3, 3]
        assert [sp.unit for sp in plans[1].stages] == [1, 1, 1]
        assert plans[16].stages[0].unit == 6
        assert plans[16].stages[1].unit == 9
    if chain in ("alexnet_conv1_group", "alexnet_conv2_group"):
        # batch 16: the pixel x channel tiles fill the grid, so an item
        # takes the whole reduction; batch 1: a chunk an item
        assert plans[16].stages[0].whole and plans[1].stages[0].unit == 1


@pytest.mark.parametrize("chain", sorted(SCHEDULES))
@pytest.mark.parametrize("n", [1, 16])
def test_chain_grid_fits_the_card(chain, n):
    """The cooperative grid fits the blocks an SM holds by the kernel's
    shared memory (228 KB an SM, 1 KB of it reserved a block) and threads
    (2048 an SM) on 132 SMs (its launch bounds promise the registers), 3
    an SM; at batch 16 AlexNet's chain gives every block an item in conv3
    and conv4, its K1 groups give 368 and 758 whole items, and the
    scratch stays in the 50 MB L2."""
    stages, pool = SCHEDULES[chain]
    plan = conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
    per_sm = min(233472 // (conv_ops.CH_SMEM + 1024),
                 2048 // conv_ops.CH_THREADS)
    assert per_sm == conv_ops.CH_MIN_BLOCKS == 3
    assert plan.grid == per_sm * REPORT_SMS == 396
    assert conv_ops.CH_SMEM <= 227 * 1024
    if chain.startswith("alexnet"):
        assert 4 * plan.scratch < 50e6
    if chain == "alexnet" and n == 16:
        assert plan.grid >= 128
        assert [sp.items for sp in plan.stages][:2] == [396, 396]
        assert plan.tail_items == 16 * 6 * 6
    if n == 16 and chain == "alexnet_conv2_group":
        assert plan.stages[0].items == 368 and plan.barriers == 2
        assert plan.tail_items == 16 * 13 * 13
    if n == 16 and chain == "alexnet_conv1_group":
        # one fold holds the whole sum of a row-walked stage: no partials
        assert plan.stages[0].items == 758 and plan.stages[0].part == 0


@pytest.mark.parametrize("conv", sorted(NARROW))
def test_kernel_row_walk_covers_each_real_row_once(conv):
    """A stage with Cp < CH_CK walks a kernel row a tap: each real (i, j,
    c) is read once, at its HWIO weight row, the rest of a row's slots are
    padding past the run, and the walk takes fewer reduction rows than a
    tap a slot would."""
    st = _stages(*NARROW[conv])[0]
    sp = conv_ops.chain_plan([st], None, 1, REPORT_SMS).stages[0]
    cp = _round4(st.C)
    assert cp < conv_ops.CH_CK and (sp.tw, sp.tpr) == (st.KW * cp, 1)
    seen = {}
    for g, i, j, c, w_row in _walk_rows(st, sp):
        assert 0 <= i < st.KH and 0 <= j < st.KW and 0 <= c < cp
        assert w_row == (i * st.KW + j) * cp + c
        assert g // sp.split == i
        seen[(i, j, c)] = seen.get((i, j, c), 0) + 1
    assert seen == {(i, j, c): 1 for i in range(st.KH) for j in range(st.KW)
                    for c in range(cp)}
    rows = st.KH * sp.split * sp.chunk_slots * conv_ops.CH_CK
    assert rows < st.KH * st.KW * conv_ops.CH_CK
    if conv == "alexnet_conv1":  # 3 slots a row: 528 rows for 363
        assert (sp.split, sp.chunk_slots, rows) == (1, 3, 528)
    if conv == "cp12_2x11":
        assert sp.split == 2


@pytest.mark.parametrize("conv", sorted(NARROW))
def test_kernel_row_walk_gives_every_unit_the_same_bits(conv):
    """The emulated schedule of a row-walked stage gives the same bits with
    every unit (one chunk, a tap = a kernel row, the whole reduction), and
    its result is the plain conv's within 1e-4."""
    in_chw, w_shape, stride, padding = NARROW[conv]
    rng = np.random.default_rng(len(conv))
    if conv == "alexnet_conv1":  # the full frame is slow to emulate
        in_chw = (3, 51, 51)
    x = _t(_arr(rng, 2, *in_chw))
    w = _t(_arr(rng, *w_shape, scale=(np.prod(w_shape[1:])) ** -0.5))
    b = _t(_arr(rng, w_shape[0], scale=0.1))
    args = ([stride], [padding], [True])
    st = conv_ops.make_stages(in_chw, [w], *args)[0]
    tw, tpr = conv_ops.tap_walk(st)
    units = _units(st, conv_ops.tap_split(tw), tpr)
    assert len(units) >= 2
    outs = [_emulate_chain(x, [w], [b], *args, None, None, unit=u)
            for u in units]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    ref = conv_ops.conv2d_pool_fused_ref(x, w, b, stride, padding, True)
    _close(outs[0], ref.numpy())


@pytest.mark.parametrize("case", sorted(K2_CASES))
@pytest.mark.parametrize("n", [1, 3])
def test_chain_schedule_matches_the_plain_chain_and_jax(case, n):
    """The emulated schedule (items, chunks, partials, the fixed folds,
    padding between stages) equals ``conv2d_chain_ref`` and the JAX
    package's jnp chain (``conv2d_chain_fused``, never Pallas) on the
    same numpy inputs within 1e-4, with an LRN tail and without; at
    n = 3 pixel tiles cross frame boundaries."""
    x, ws, bs, (strides, pads, relus), pool, lrn_n = _k2_inputs(case, n)
    tail = dict(pool_kernel=pool[0] if pool else None,
                pool_stride=pool[1] if pool else None,
                pool_kind=pool[2] if pool else "max", lrn_n=lrn_n,
                lrn_alpha=1e-2, lrn_beta=0.75, lrn_k=1.0)
    tpool = (conv_ops.Pool(*pool[0], *pool[1], pool[2]) if pool else None)
    lrn = (lrn_n, 1e-2, 0.75, 1.0) if lrn_n else None
    tw, tb = [_t(w) for w in ws], [_t(b) for b in bs]
    ours = _emulate_chain(_t(x), tw, tb, strides, pads, relus, tpool, lrn)
    ref = conv_ops.conv2d_chain_ref(_t(x), tw, tb, strides, pads, relus,
                                    **tail)
    _close(ours, ref.numpy())
    theirs = _jit(jm.conv2d_chain_fused, method=jm.Method.ADVANCED_SIMD_8,
                  strides=tuple(strides), paddings=tuple(pads),
                  relus=tuple(relus), **tail)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs])
    _close(ours, theirs)


@pytest.mark.parametrize("case", sorted(K1_CASES))
@pytest.mark.parametrize("n", [1, 3])
def test_one_stage_schedule_matches_k1_plain_and_jax(case, n):
    """K1's launch is the one-stage schedule: emulated item by item (the
    kernel-row walk where Cp < 16) with the plan's unit and with the whole
    reduction, it gives the same bits both ways and equals
    ``conv2d_pool_fused_ref`` and the JAX package's jnp
    ``conv2d_pool_fused`` on the same numpy inputs within 1e-4."""
    x, w, b, stride, padding, relu, tail, pool, lrn = _k1_inputs(case, n)
    args = ([stride], [padding], [relu])
    emu = partial(_emulate_chain, _t(x), [_t(w)], [_t(b)], *args, pool, lrn,
                  pool_relu=tail["pool_relu"])
    ours = emu()
    st = conv_ops.make_stages(x.shape[1:], [w.shape], *args)[0]
    tw, tpr = conv_ops.tap_walk(st)
    whole = _units(st, conv_ops.tap_split(tw), tpr)[-1]
    assert whole == st.KH * tpr * conv_ops.tap_split(tw)
    assert torch.equal(ours, emu(unit=whole))
    ref = conv_ops.conv2d_pool_fused_ref(_t(x), _t(w), _t(b), stride,
                                         padding, relu, **tail)
    _close(ours, ref.numpy())
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=relu, **tail)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(ours, theirs)


@pytest.mark.parametrize("inference", [False, True])
@pytest.mark.parametrize("entry", ["conv_pool_lrn_f32", "conv_chain_f32"])
def test_stage_major_launch_keeps_converted_weights_alive(entry, inference,
                                                          monkeypatch):
    """Every weight pointer the stage-major launch hands its C entry (one
    stage for K1, three for K2) points into a converted weight tensor that
    is still alive when the entry is called, also for inference tensors,
    whose converted copies are not cached: a copy freed before the launch
    could be overwritten by the next stage's conversion before the kernel
    reads it."""
    import weakref

    one = entry == "conv_pool_lrn_f32"
    rng = np.random.default_rng(7)
    shapes = [(8, 3, 3, 3)] if one else [(8, 4, 3, 3), (8, 8, 3, 3),
                                         (4, 8, 3, 3)]
    with torch.inference_mode(inference):
        x = _t(_arr(rng, 2, shapes[0][1], 9, 9))
        ws = [_t(_arr(rng, *s)) for s in shapes]
        bs = [_t(_arr(rng, s[0])) for s in shapes]
    converted = []
    convert = conv_ops.chain_weights

    def recording(w):
        out = convert(w)
        converted.append(weakref.ref(out))
        return out

    fake = type("Lib", (), {})()
    setattr(fake, entry, _Entry(converted, bs))
    wrapper = (conv_ops.conv2d_pool_fused if one else conv_ops.conv2d_chain)
    monkeypatch.setattr(conv_ops, "chain_weights", recording)
    monkeypatch.setattr(conv_ops, "_sms", lambda dev: REPORT_SMS)
    monkeypatch.setattr(conv_ops, "_stream", lambda dev: 0)
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(wrapper, "launches", 0)
    k = len(shapes)
    pool, lrn = conv_ops._pool_lrn((2, 2), None, "max", None, 0, 0, 0)
    with torch.inference_mode(inference):
        conv_ops._launch_stage_major(wrapper, entry, x, ws, bs,
                                     [(1, 1)] * k, [(1, 1)] * k, [True] * k,
                                     pool, False, lrn)
    assert all(w.is_inference() == inference for w in ws)
    assert getattr(fake, entry).seen == ([True] * k, True)
    assert wrapper.launches == 1


def test_chain_schedule_gives_the_same_bits_with_every_unit():
    """Items of one chunk, one tap or a kernel row (the units the host
    picks by the batch) add each output in the same tree: the emulated
    schedule gives the same bits with each, within 1e-4 of the plain
    chain, on a chain whose taps are cut in chunks (136 and 140 channels:
    two chunks a tap) and a 1 x 3 kernel."""
    rng = np.random.default_rng(7)
    x = _t(_arr(rng, 2, 136, 6, 7))
    ws = [_t(_arr(rng, 140, 136, 3, 3, scale=(9 * 136) ** -0.5)),
          _t(_arr(rng, 12, 140, 1, 3, scale=(3 * 140) ** -0.5))]
    bs = [_t(_arr(rng, 140, scale=0.1)), _t(_arr(rng, 12, scale=0.1))]
    args = ([(1, 1)] * 2, [(1, 1), (0, 1)], [True, False])
    pool = conv_ops.Pool(2, 2, 2, 2, "max")
    stages = conv_ops.make_stages((136, 6, 7), ws, *args)
    assert [conv_ops.tap_split(_round4(st.C)) for st in stages] == [2, 2]
    # a chunk, a tap and a kernel row at every stage (the 1 x 3 stage's
    # row is its whole reduction)
    outs = [_emulate_chain(x, ws, bs, *args, pool, None, unit=u)
            for u in (1, 2, 6)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[1], outs[2])
    ref = conv_ops.conv2d_chain_ref(x, ws, bs, *args, pool_kernel=(2, 2),
                                    pool_stride=(2, 2))
    _close(outs[0], ref.numpy())


def test_chain_weights_are_converted_once():
    """``chain_weights`` converts a tensor once and reuses the copy until
    the tensor is written in place or dropped."""
    w = _t(_arr(np.random.default_rng(0), 5, 3, 3, 2))
    a = conv_ops.chain_weights(w)
    assert a.shape == (3, 2, 4, 8) and a.is_contiguous()
    assert torch.equal(a[:, :, :3, :5], w.permute(2, 3, 1, 0))
    assert not a[:, :, 3:].any() and not a[..., 5:].any()
    assert conv_ops.chain_weights(w) is a
    w.mul_(2.0)
    b = conv_ops.chain_weights(w)
    assert b is not a and torch.equal(b[:, :, :3, :5], w.permute(2, 3, 1, 0))
    key = id(w)
    del w
    assert key not in conv_ops._CHAIN_WEIGHTS

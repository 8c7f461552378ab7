"""The port's kernel modules on the CPU, against their JAX counterparts.

K7 and K8 (the §4.3 and §4.2 convs, register-tiled) and K9 (the
standalone pool): their plain versions, their tile geometry read from
the sources, and numpy walks of their tiles.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methods as jm
from repro.kernels.pool2d.ref import pool2d_ref as jax_pool2d_ref
from repro_torch.core import methods as tm
from repro_torch.kernels import _build
from repro_torch.kernels.conv2d import ops as conv_ops
from repro_torch.kernels.conv2d.ref import (
    conv2d_basic_parallel_ref,
    conv2d_basic_simd_ref,
)
from repro_torch.kernels.pool2d.ops import pool2d
from torch_kernels_common import (
    K1_CASES,
    K7_GROUPS,
    LADDER_CONV_CASES,
    NET_CONVS,
    REPORT_SMS,
    _arr,
    _close,
    _emulate_k7,
    _emulate_k8,
    _emulate_k9,
    _jit,
    _k7_operands,
    _k7_tile,
    _net_pool_shapes,
    _one_thread_an_output,
    _pool_constants,
    _round4,
    _simt_constants,
    _t,
    _tile_counts,
)


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_basic_simd_ref_matches_jax(case, relu):
    """K7's plain version (NHWC, a channel dot per kernel position) against
    JAX ``methods.conv2d_basic_simd`` without Pallas."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(20 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_simd, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(conv2d_basic_simd_ref(_t(x), _t(w), _t(b), stride, padding, relu),
           theirs)
    _close(conv_ops.conv2d_basic_simd(_t(x), _t(w), _t(b), stride, padding,
                                      relu), theirs)


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_basic_parallel_ref_matches_jax(case, relu):
    """K8's plain version (NCHW patches, channels outer) against JAX
    ``methods.conv2d_basic_parallel`` without Pallas."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(30 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_parallel, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(conv2d_basic_parallel_ref(_t(x), _t(w), _t(b), stride, padding,
                                     relu), theirs)
    _close(conv_ops.conv2d_basic_parallel(_t(x), _t(w), _t(b), stride,
                                          padding, relu), theirs)


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_basic_simd_fused_matches_jax(case):
    """The fused §4.3 super-layer (K7 with its pool/ReLU/LRN tail) against
    JAX ``methods.conv2d_pool_fused(method=BASIC_SIMD)`` without Pallas."""
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = K1_CASES[case]
    rng = np.random.default_rng(40 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    lrn = dict(lrn_n=lrn_n, lrn_alpha=1e-3, lrn_beta=0.75, lrn_k=1.0)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.BASIC_SIMD,
                  stride=stride, padding=padding, relu=relu, pool_kernel=pk,
                  pool_stride=ps, pool_kind=kind, pool_relu=pool_relu,
                  **lrn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _close(tm.conv2d_pool_fused(_t(x), _t(w), _t(b), tm.Method.BASIC_SIMD,
                                stride, padding, relu, pk, ps, kind,
                                pool_relu, **lrn), theirs)
    _close(conv2d_basic_simd_ref(_t(x), _t(w), _t(b), stride, padding, relu,
                                 pool_kernel=pk, pool_stride=ps,
                                 pool_kind=kind, pool_relu=pool_relu, **lrn),
           theirs)


@pytest.mark.parametrize("kernel,stride", [((3, 3), (2, 2)), ((2, 2), (2, 2)),
                                           ((3, 2), (1, 2))])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("relu", [False, True])
def test_pool2d_wrapper_matches_jax(kernel, stride, kind, relu):
    """K9's wrapper (its plain version on the CPU) against JAX
    ``pool2d_ref``, at the pool shapes of the three nets and a ragged
    one."""
    rng = np.random.default_rng(sum(kernel) + sum(stride))
    x = _arr(rng, 2, 5, 13, 12)
    _close(pool2d(_t(x), kernel, stride, kind, relu),
           jax_pool2d_ref(jnp.asarray(x), kernel, stride, kind, relu))


def test_pool2d_negative_inputs_stay_negative_under_max():
    """The TPU kernel pads channels with zeros, which must never win a max
    (tests/test_pool2d.py); the port pads no channel, and a max over
    all-negative inputs stays negative."""
    x = -1.0 - np.random.default_rng(9).random((2, 3, 9, 9)).astype(
        np.float32)
    out = pool2d(_t(x), (3, 3), (2, 2), "max")
    assert (out < 0).all()
    _close(out, jax_pool2d_ref(jnp.asarray(x), (3, 3), (2, 2), "max"))


def test_pool2d_rejects_a_window_larger_than_the_input():
    from repro_torch.kernels.pool2d.ops import pool_out_hw

    assert pool_out_hw(27, 27, (3, 3), (2, 2)) == (13, 13)
    with pytest.raises(ValueError, match="larger than input"):
        pool_out_hw(2, 9, (3, 3), (2, 2))


def test_pool_constants_match_the_wrapper():
    from repro_torch.kernels.pool2d import ops as pool_ops

    assert _pool_constants() == {"POOL_THREADS": pool_ops.THREADS}


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("shape", _net_pool_shapes()
                         + [(3, 13, 12, (3, 2), (1, 2), "max", False)])
def test_k9_walk_matches_jax(shape, kind, relu):
    """The plane-per-block walk writes every output once and equals JAX's
    ``pool2d_ref`` at every pool shape of the three nets' unfused plans
    (channels cut to 3, batch 2) and a ragged one, max and avg, with and
    without ReLU, with the bits of the previous kernel's order."""
    c, h, w, kernel, stride, _, _ = shape
    rng = np.random.default_rng(h * 100 + w + sum(kernel))
    x = _arr(rng, 2, min(c, 3), h, w)
    y, writes = _emulate_k9(x, kernel, stride, kind, relu)
    assert (writes == 1).all()
    _close(y, jax_pool2d_ref(jnp.asarray(x), kernel, stride, kind, relu))
    assert np.array_equal(y, _one_thread_an_output(x, kernel, stride, kind,
                                                   relu))


@pytest.mark.parametrize("n", [1, 16])
def test_k9_grid_fills_the_card_at_batch_16(n):
    """AlexNet's pools: whole planes a block, 32-bit offsets inside a
    plane, and at batch 16 at least one block an SM."""
    from repro_torch.kernels.pool2d import ops as pool_ops

    for c, h, w, kernel, stride, _, _ in _net_pool_shapes()[:3]:
        oh, ow = pool_ops.pool_out_hw(h, w, kernel, stride)
        plan = pool_ops.pool_plan(n * c, oh, ow)
        assert plan.ppb * plan.per_plane <= max(pool_ops.THREADS,
                                                plan.per_plane)
        assert plan.blocks * plan.ppb >= n * c > (plan.blocks - 1) * plan.ppb
        assert h * w < 2 ** 31
        if n == 16:
            assert plan.blocks >= REPORT_SMS


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("kind", ["max", "avg"])
def test_k9_launch_passes_live_tensors(kind, relu, monkeypatch):
    """``_launch`` hands ``pool2d_f32`` the input and the one tensor it
    allocates (the output it returns), both alive when it is called, the
    geometry, the kind code and the stream handle, and steps the counter
    once."""
    import weakref

    from repro_torch.kernels.pool2d import ops as pool_ops

    x = torch.zeros(2, 5, 13, 12)
    calls, tensors = [], [weakref.ref(x)]
    empty = torch.empty

    def recording(*a, **kw):
        out = empty(*a, **kw)
        tensors.append(weakref.ref(out))
        return out

    def entry(*args):
        live = {t.data_ptr() for t in (r() for r in tensors) if t is not None}
        calls.append((args, [p in live for p in args[:2]]))
        return 0

    fake = type("Lib", (), {"pool2d_f32": staticmethod(entry)})()
    monkeypatch.setattr(pool_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(pool_ops, "stream_handle", lambda dev: 55)
    monkeypatch.setattr(pool_ops.torch, "empty", recording)
    monkeypatch.setattr(_build, "library", lambda: fake)
    monkeypatch.setattr(pool2d, "launches", 0)
    y = pool_ops._launch(x, (3, 2), (1, 2), kind, relu)
    (args, live), = calls
    assert live == [True, True] and len(tensors) == 2
    assert args == (x.data_ptr(), y.data_ptr(), 10, 13, 12, 11, 6, 3, 2, 1, 2,
                    pool_ops.KIND_CODES[kind], int(relu), 55)
    assert y.shape == (2, 5, 11, 6) and pool2d.launches == 1


def test_simt_constants_match_the_wrappers():
    """The wrappers' copies of the sources' tile constants, and K8's dims
    array, agree with the sources."""
    c = _simt_constants()
    assert (c["ST_TP"], c["ST_TO"], c["ST_BROW"]) == (
        conv_ops.ST_TP, conv_ops.ST_TO, conv_ops.ST_BROW)
    assert (c["K7_CK"], c["K7_AROW"], c["K7_MAX_GROUPS"]) == (
        conv_ops.K7_CK, conv_ops.K7_AROW, conv_ops.K7_MAX_GROUPS)
    assert (c["K7_SMEM_LIMIT"] == c["K8_SMEM_LIMIT"]
            == conv_ops.K7_SMEM_LIMIT == 227 * 1024)
    assert conv_ops.K7_RING == 2 * (c["ST_TP"] * c["K7_AROW"]
                                    + c["K7_CK"] * c["ST_BROW"])
    # 8 x 8 accumulators a thread; K7's stage is whole float4s of channels
    assert c["ST_TP"] * c["ST_TO"] == 64 * c["ST_THREADS"]
    assert c["K7_CK"] % 4 == 0 and c["K7_AROW"] % 4 == 0
    st, dims, _, _ = conv_ops.k8_launch(1, (3, 9, 9), (4, 3, 3, 3), (1, 1),
                                        (1, 1), True)
    assert len(dims) == c["K8_DIMS"]
    geo = conv_ops.k7_launch(1, (4, 9, 9), (4, 4, 3, 3), (1, 1), (1, 1),
                             True, None, False, None)[2]
    assert len(geo) == 14 + 13 + c["K7_GEO_TAIL"]


@pytest.mark.parametrize("conv", sorted(NET_CONVS))
@pytest.mark.parametrize("n", [1, 16])
def test_k8_geometry(conv, n):
    """K8's launch: a block per (frame, pixel tile, channel tile) within
    CUDA's grid limits, every output written by exactly one thread, every
    tap of every pixel inside the stage's halo, ``cc`` the most channels
    whose stage fits ``K8_STAGE_FLOATS``, and two stages within 227 KB."""
    c = _simt_constants()
    in_chw, w_shape, stride, padding = NET_CONVS[conv]
    st, dims, smem, grid = conv_ops.k8_launch(n, in_chw, w_shape, stride,
                                              padding, True)
    p_all, tp, to = st.OH * st.OW, c["ST_TP"], c["ST_TO"]
    n_pt = -(-p_all // tp)
    assert grid == (n_pt * n, -(-st.OC // to))
    assert grid[0] < 2 ** 31 and grid[1] <= 65535
    # blockIdx.x = frame * n_pt + pixel tile: each frame's tiles once
    assert (np.bincount(np.arange(grid[0]) // n_pt) == n_pt).all()
    tiles = [(t * tp, o * to) for t in range(n_pt) for o in range(grid[1])]
    assert (_tile_counts(c, p_all, st.OC, tiles) == 1).all()
    # the halo: rows (oy - r0) * sy + i and columns ox * sx + j of every
    # valid pixel's taps
    wp = (st.OW - 1) * st.sx + st.KW
    hr = 0
    for p0 in range(0, p_all, tp):
        p = np.arange(p0, min(p0 + tp, p_all))
        rows = (p // st.OW - p0 // st.OW) * st.sy + st.KH - 1
        cols = (p % st.OW) * st.sx + st.KW - 1
        assert cols.max() < wp
        hr = max(hr, int(rows.max()) + 1)
    assert hr == conv_ops.k8_halo_rows(st)
    cc = int(dims[-1])

    def stage(k):
        return (_round4(k * hr * wp)
                + _round4(k * st.KH * st.KW) * c["ST_BROW"])

    assert 1 <= cc <= st.C
    assert cc == 1 or stage(cc) <= conv_ops.K8_STAGE_FLOATS
    assert cc == st.C or stage(cc + 1) > conv_ops.K8_STAGE_FLOATS
    assert smem == 2 * 4 * stage(cc) <= c["K8_SMEM_LIMIT"]
    assert list(dims) == [n, *in_chw, w_shape[0], *w_shape[2:], *stride,
                          *padding, st.OH, st.OW, 1, cc]


@pytest.mark.parametrize("conv", sorted(NET_CONVS))
@pytest.mark.parametrize("n", [1, 16])
def test_k7_geometry(conv, n):
    """K7's per-layer launch (the grid its source computes): a block per
    (frame, pixel tile, channel tile) within CUDA's limits, every output
    written by exactly one thread, one ring under the 48 KB a block has
    without opting in, the channels padded to whole float4s."""
    c = _simt_constants()
    (ch, h, w), (oc, _, kh, kw), stride, padding = NET_CONVS[conv]
    cp = _round4(ch)
    stages, smem, geo, _ = conv_ops.k7_launch(
        n, (cp, h, w), (oc, cp, kh, kw), stride, padding, True, None, False,
        None)
    st = stages[0]
    p_all, tp, to = st.OH * st.OW, c["ST_TP"], c["ST_TO"]
    n_pt = -(-p_all // tp)
    assert n_pt * n < 2 ** 31 and -(-oc // to) <= 65535
    tiles = [(t * tp, o * to) for t in range(n_pt)
             for o in range(-(-oc // to))]
    assert (_tile_counts(c, p_all, oc, tiles) == 1).all()
    assert smem == 4 * conv_ops.K7_RING <= 48 * 1024
    assert geo[14] == cp and cp % conv_ops.K7_ALIGN == 0
    assert geo[2] == 0 and list(geo[-2:]) == [1, 0]


def test_simt_stage_loads_cover_each_element_once():
    """The copies a stage's threads issue: K7's A (pixel (gtid >> 2) + 32 r,
    channel quad gtid & 3) and B (row (gtid >> 6) + 2 r, column gtid & 63)
    and K8's weight rows (a warp: 8 channels x 4 consecutive k) write every
    element of their tiles exactly once."""
    c = _simt_constants()
    g = np.arange(c["ST_THREADS"])
    r4, r8 = np.arange(4), np.arange(8)
    a_px = ((g >> 2)[:, None] + 32 * r4[None]).ravel()
    a_q = np.repeat(g & 3, 4)
    count = np.zeros((c["ST_TP"], c["K7_CK"] // 4), dtype=np.int64)
    np.add.at(count, (a_px, a_q), 1)
    assert (count == 1).all()
    b_k = ((g >> 6)[:, None] + 2 * r8[None]).ravel()
    b_o = np.repeat(g & 63, 8)
    count = np.zeros((c["K7_CK"], c["ST_TO"]), dtype=np.int64)
    np.add.at(count, (b_k, b_o), 1)
    assert (count == 1).all()
    for rows in (4, 12, 124):
        e = np.arange(rows * c["ST_TO"])
        o = ((e >> 5) & 7) * 8 + (e & 7)
        k = (e >> 8) * 4 + ((e >> 3) & 3)
        count = np.zeros((rows, c["ST_TO"]), dtype=np.int64)
        np.add.at(count, (k, o), 1)
        assert (count == 1).all()
        # a warp's 32 stores land on 32 distinct banks of rows ST_BROW apart
        for w0 in range(0, len(e), 32):
            banks = (k[w0:w0 + 32] * c["ST_BROW"] + o[w0:w0 + 32]) % 32
            assert len(set(banks)) == 32


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_k8_tile_walk_matches_jax(case, relu):
    """The numpy emulation of K8's tile walk against JAX
    ``methods.conv2d_basic_parallel`` without Pallas; frame 0 of the batch
    equals, bit for bit, the same walk on frame 0 alone."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(50 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_parallel, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = _emulate_k8(x, w, b, stride, padding, relu)
    _close(ours, theirs)
    assert np.array_equal(ours[:1],
                          _emulate_k8(x[:1], w, b, stride, padding, relu))


@pytest.mark.parametrize("case", sorted(LADDER_CONV_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_k7_tile_walk_matches_jax(case, relu):
    """The numpy emulation of K7's per-layer tile walk against JAX
    ``methods.conv2d_basic_simd`` without Pallas; frame 0 of the batch
    equals, bit for bit, the same walk on frame 0 alone."""
    xs, ws, stride, padding = LADDER_CONV_CASES[case]
    rng = np.random.default_rng(60 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    theirs = _jit(jm.conv2d_basic_simd, stride=stride, padding=padding,
                  relu=relu)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = _emulate_k7(x, w, b, stride, padding, relu)
    _close(ours, theirs)
    assert np.array_equal(ours[:1],
                          _emulate_k7(x[:1], w, b, stride, padding, relu))


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k7_fused_tile_walk_matches_jax(case):
    """The numpy emulation of K7's fused kernel: each block's band (the
    conv rows of its pooled row, ``band_rows``) from its groups' tiles,
    where rows that two blocks share come out bit for bit the same, then
    the pool → [ReLU] → [LRN] tail, against JAX
    ``methods.conv2d_pool_fused(method=BASIC_SIMD)`` without Pallas."""
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = K1_CASES[case]
    rng = np.random.default_rng(70 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    lrn = dict(lrn_n=lrn_n, lrn_alpha=1e-3, lrn_beta=0.75, lrn_k=1.0)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.BASIC_SIMD,
                  stride=stride, padding=padding, relu=relu, pool_kernel=pk,
                  pool_stride=ps, pool_kind=kind, pool_relu=pool_relu,
                  **lrn)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    c = _simt_constants()
    xh, wk, cp = _k7_operands(x, w)
    n, _, h, wd = x.shape
    oc, _, kh, kw = w.shape
    pool = conv_ops.Pool(*pk, *ps, kind)
    lrn_t = (lrn_n, 1e-3, 0.75, 1.0) if lrn_n is not None else None
    stages, _, geo, _ = conv_ops.k7_launch(
        n, (cp, h, wd), (oc, cp, kh, kw), stride, padding, relu, pool,
        pool_relu, lrn_t)
    st, groups = stages[0], int(geo[-2])
    conv = np.full((n, oc, st.OH, st.OW), np.nan, dtype=np.float32)
    for frame in range(n):
        for t in range(int(geo[10])):
            (a, bb), = conv_ops.band_rows(stages, pool, 1, t)
            npx = (bb - a) * st.OW
            n_ot = -(-oc // c["ST_TO"])
            tiles = -(-npx // c["ST_TP"]) * n_ot
            band = np.full((oc, npx), np.nan, dtype=np.float32)
            for gi in range(groups):
                for tile in range(gi, tiles, groups):
                    p0 = tile // n_ot * c["ST_TP"]
                    o0 = tile % n_ot * c["ST_TO"]
                    acc = _k7_tile(xh[frame], wk, st, a, npx, p0, o0)
                    q, o = p0 + np.arange(c["ST_TP"]), o0 + np.arange(
                        c["ST_TO"])
                    kq, ko = q < npx, o < oc
                    y = acc[kq][:, ko] + b[o[ko]][None]
                    band[np.ix_(o[ko], q[kq])] = (
                        np.maximum(y, 0) if relu else y).T
            band = band.reshape(oc, bb - a, st.OW)
            seen = conv[frame, :, a:bb]
            done = ~np.isnan(seen)
            assert np.array_equal(seen[done], band[done])
            conv[frame, :, a:bb] = band
    ours = conv_ops.pool_lrn_tail(
        torch.from_numpy(np.nan_to_num(conv)), pk, ps, kind, pool_relu,
        **lrn)
    _close(ours, theirs)


@pytest.mark.parametrize("group", range(len(K7_GROUPS)))
@pytest.mark.parametrize("n", [1, 16])
def test_k7_band_fits_shared_memory(group, n):
    """K7's fused kernel gives a block one pooled row of one frame at full
    channel width: the conv rows that row reads (and, with LRN, the pooled
    row), then one tile ring for each of its groups (one a band tile, at
    most K7_MAX_GROUPS, as many as fit), must fit the 227 KB of shared
    memory a block may have; the groups' tiles cover the band once."""
    c = _simt_constants()
    (_, (ch, h, w), (oc, _, kh, kw), stride, padding, pk, ps,
     lrn) = K7_GROUPS[group]
    cp = _round4(ch)
    pool = conv_ops.Pool(*pk, *ps, "max")
    lrn_t = (5, 1e-4, 0.75, 1.0) if lrn else None
    stages, smem, geo, lrn_f = conv_ops.k7_launch(
        n, (cp, h, w), (oc, cp, kh, kw), stride, padding, True, pool, False,
        lrn_t)
    st = stages[0]
    ph = (st.OH - pk[0]) // ps[0] + 1
    pw = (st.OW - pk[1]) // ps[1] + 1
    # the conv rows of one pooled row, and with LRN that pooled row, then
    # the rings
    groups, ring_off = (int(v) for v in geo[-2:])
    ring = 2 * (c["ST_TP"] * c["K7_AROW"] + c["K7_CK"] * c["ST_BROW"])
    assert ring_off == _round4(oc * (pk[0] * st.OW + (pw if lrn else 0)))
    tiles = -(-pk[0] * st.OW // c["ST_TP"]) * -(-oc // c["ST_TO"])
    fits = (c["K7_SMEM_LIMIT"] // 4 - ring_off) // ring
    assert groups == min(c["K7_MAX_GROUPS"], tiles, fits) >= 1
    assert smem == 4 * (ring_off + groups * ring)
    assert smem <= conv_ops.K7_SMEM_LIMIT == 227 * 1024
    # one pooled row a block, n_tiles = pooled rows, the padded channels;
    # a grid of (pooled rows, frames) and at most 1024 threads
    assert geo[9] == 1 and geo[10] == ph and geo[14] == cp
    assert n <= 65535 and groups * c["ST_THREADS"] <= 1024
    for t in range(ph):
        (a, b), = conv_ops.band_rows(stages, pool, 1, t)
        assert (a, b) == (t * ps[0], t * ps[0] + pk[0]) and b <= st.OH
    n_ot = -(-oc // c["ST_TO"])
    owned = [(tile // n_ot * c["ST_TP"], tile % n_ot * c["ST_TO"])
             for gi in range(groups) for tile in range(gi, tiles, groups)]
    assert (_tile_counts(c, pk[0] * st.OW, oc, owned) == 1).all()


def test_k7_alexnet_conv2_band_is_83_kb():
    stages = conv_ops.make_stages((96, 27, 27), [(256, 96, 5, 5)], [(1, 1)],
                                  [(2, 2)], [True])
    pool = conv_ops.Pool(3, 3, 2, 2, "max")
    ring = 4 * conv_ops.K7_RING
    assert conv_ops.k7_ring_off(stages, pool, False) * 4 == 3 * 27 * 256 * 4
    assert conv_ops.k7_smem(stages, pool, False, 2) == 82944 + 2 * ring
    assert conv_ops.k7_smem(stages, pool, True, 2) == (82944 + 256 * 13 * 4
                                                       + 2 * ring)
    # its band has four 128 x 64 tiles on two groups: 152 KB in all
    assert conv_ops.k7_groups(stages, pool, True) == 2
    assert conv_ops.k7_smem(stages, pool, True, 2) == 155648

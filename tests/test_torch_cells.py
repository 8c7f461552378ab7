"""The port's kernel modules on the CPU, against their JAX counterparts.

K4, K5 and K6 (the second-generation cells): their knobs, the
resolvers, and their emulations against K1 and K2.

Each case draws its inputs with numpy from a seed and hands the same
arrays to both packages.  The JAX side takes its jnp paths (the Pallas
path does not run under the installed jax); the port's wrappers take
their plain versions because the tensors lie on the CPU.  Tolerance:
max abs <= 1e-4 (fp32 sums in another order).  The CUDA kernels
themselves are checked against these plain versions on the card by
``chip_smoke.py``.
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import methods as jm
from repro_torch.core import methods as tm
from repro_torch.kernels.conv2d import ops as conv_ops
from torch_kernels_common import (
    ALEX_CHAIN,
    ALEX_GROUPS,
    ALEX_LRN,
    ALEX_LRN_TAIL,
    CELL_CASES,
    GROUPS,
    K2_CASES,
    K4_CASES,
    K4_GROUPS,
    K5_CASES,
    K5_GROUPS,
    POOL32,
    REPORT_SMS,
    TOL,
    _OnCard,
    _arr,
    _chain_items,
    _close,
    _emulate_chain,
    _jit,
    _record_stage_major,
    _t,
)


@pytest.mark.parametrize("kid,case", [("K4", c) for c in K4_CASES]
                         + [("K5", c) for c in K5_CASES])
def test_fused_cell_knobs_match_jax(kid, case):
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = CELL_CASES[case]
    rng = np.random.default_rng(20 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    tail = dict(pool_kernel=pk, pool_stride=ps, pool_kind=kind,
                pool_relu=pool_relu)
    lrn = dict(lrn_n=lrn_n, lrn_alpha=1e-3, lrn_beta=0.75, lrn_k=1.0)
    knob = {"K4": {"lrn_oc_block": True}, "K5": {"pool_carry": True}}[kid]
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, xs[1:], ws, stride,
                         padding, pk, ps, lrn_n, **knob) == kid
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=relu, **tail, **lrn,
                  **knob)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ours = tm.conv2d_pool_fused(_t(x), _t(w), _t(b),
                                tm.Method.ADVANCED_SIMD_8, stride, padding,
                                relu, **tail, **lrn, **knob)
    _close(ours, theirs)
    if kid == "K4":
        direct = conv_ops.conv2d_pool_lrn_halo(_t(x), _t(w), _t(b), stride,
                                               padding, relu, **tail, **lrn)
    else:
        direct = conv_ops.conv2d_pool_carry(_t(x), _t(w), _t(b), stride,
                                            padding, relu, **tail)
    _close(direct, theirs)


@pytest.mark.parametrize("case", ["two_stage_no_pool", "three_stage_pool",
                                  "pad2_avg"])
@pytest.mark.parametrize("obf", [1, 4])
def test_chain_cell_knob_matches_jax(case, obf):
    xs, stages, pool, _ = K2_CASES[case]
    rng = np.random.default_rng(30 + len(case) + obf)
    x, c = _arr(rng, *xs), xs[1]
    ws, bs = [], []
    for oc, k, _, _, _ in stages:
        ws.append(_arr(rng, oc, c, k, k, scale=(c * k * k) ** -0.5))
        bs.append(_arr(rng, oc, scale=0.1))
        c = oc
    strides = tuple((s, s) for _, _, s, _, _ in stages)
    pads = tuple((p, p) for _, _, _, p, _ in stages)
    relus = tuple(r for *_, r in stages)
    tail = dict(pool_kernel=pool[0] if pool else None,
                pool_stride=pool[1] if pool else None,
                pool_kind=pool[2] if pool else "max")
    assert tm.chain_cell(ws[-1].shape[0], obf, None) == ("K6", obf)
    theirs = _jit(jm.conv2d_chain_fused, method=jm.Method.ADVANCED_SIMD_8,
                  strides=strides, paddings=pads, relus=relus, **tail,
                  oc_block_final=obf)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs])
    ours = tm.conv2d_chain_fused(_t(x), [_t(w) for w in ws],
                                 [_t(b) for b in bs],
                                 tm.Method.ADVANCED_SIMD_8, strides, pads,
                                 relus, **tail, oc_block_final=obf)
    _close(ours, theirs)
    _close(conv_ops.conv2d_chain_ocb(_t(x), [_t(w) for w in ws],
                                     [_t(b) for b in bs], strides, pads,
                                     relus, **tail, oc_block_final=obf),
           theirs)


def test_chain_cell_keeps_k2_at_full_width():
    assert tm.chain_cell(256, None, None) == ("K2", None)
    assert tm.chain_cell(256, 256, None) == ("K2", None)
    assert tm.chain_cell(256, 512, None) == ("K2", None)
    assert tm.chain_cell(256, 8, None) == ("K6", 8)


@pytest.mark.parametrize("net,unfuse,args", GROUPS,
                         ids=[f"{n}-{'unfused' if u else 'fused'}-{a[0]}"
                              for n, u, a in GROUPS])
@pytest.mark.parametrize("method", ["advanced_simd_4", "advanced_simd_8"])
def test_resolvers_agree_with_jax(net, unfuse, args, method):
    """Halo width: the JAX rule itself (its auto rule keeps full width on
    every group, as the port's None does).  Pool carry: the same rule on
    the same band; the port reads it on its own band (``k5_bands``), and
    where that differs from the TPU's band the JAX package, run on its own
    band, may only say no because the TPU keeps the frame in one band."""
    from repro.core.fusion import group_band_params
    from repro.core.methods import Method as JM
    from repro.core.netdefs import NETWORKS as JN
    from repro.core.plan import compile_plan as jcompile
    from repro.kernels.conv2d import kernels as jk
    from repro.kernels.conv2d.ops import SUBLANES

    name, in_chw, w_shape, stride, padding, pool4, lrn = args
    c, h, w = in_chw
    oc, _, kh, kw = w_shape
    ow = (w + 2 * padding[1] - kw) // stride[1] + 1
    cp = -(-c // SUBLANES) * SUBLANES
    block = conv_ops.ADVANCED_OC_BLOCK[method]
    for knob in (None, True, False):
        theirs = jk.resolve_lrn_ocb(oc, block, lrn, knob, ow,
                                    w + 2 * padding[1], cp, kh, kw,
                                    stride[0], pool4)
        assert conv_ops.resolve_lrn_ocb(oc, block, lrn, knob) == theirs
    halo = conv_ops.resolve_lrn_ocb(oc, block, lrn, True)[1]
    assert halo == (lrn[0] - 1 if lrn is not None and block < oc else 0)
    stages = conv_ops.make_stages(in_chw, [w_shape], [stride], [padding],
                                  [True])
    phb, n_bands = conv_ops.k5_bands(stages, conv_ops.Pool(*pool4, "max"))
    for knob in (True, False):
        assert (conv_ops.resolve_pool_carry(knob, lrn, pool4, phb, n_bands)
                == jk.resolve_pool_carry(knob, True, lrn, pool4, phb,
                                         n_bands))
    assert not conv_ops.resolve_pool_carry(None, lrn, pool4, phb, n_bands)
    # against the JAX package on its own (TPU) band
    jnet = JN[net]()
    off = {l.name: False for l in jnet.layers if l.kind == "lrn"}
    jplan = jcompile(jnet, method=JM(method), verify=False,
                     per_layer_fuse=off if unfuse else None)
    step = next(s for s in jplan.steps if s.kind == "fused"
                and s.group.name == name)
    tpu = group_band_params(step.group, step.method, step.in_shape, None,
                            pool_carry=True)
    ours = conv_ops.resolve_pool_carry(True, lrn, pool4, phb, n_bands)
    if bool(tpu["carry"]) != ours:
        assert ours and tpu["n_tiles"] == 1 and n_bands > 1


@pytest.mark.parametrize("group", sorted(K5_GROUPS))
def test_k5_and_k1_agree_bit_for_bit_in_emulation(group, monkeypatch):
    """On a group without LRN, the K5 wrapper hands the stage-major launch
    what the K1 wrapper hands it (the same tensors, stage, pool and plan;
    only the C entry differs), and the groups resolve to K5 under the
    pool-carry knob: the emulated schedule at batch 2 gives K5 and K1 the
    same bits, frame 0 the bits of frame 0 alone, and equals the plain
    version and the JAX package's jnp path within 1e-4."""
    in_chw, w_shape, stride, padding = K5_GROUPS[group]
    calls = []
    monkeypatch.setattr(conv_ops, "check_cuda_f32", lambda *a: None)
    monkeypatch.setattr(conv_ops, "_launch_stage_major",
                        lambda wrapper, entry, *a: calls.append(
                            (wrapper, entry, a)))
    rng = np.random.default_rng(len(group))
    x = _arr(rng, 2, *in_chw)
    w = _arr(rng, *w_shape, scale=(2.0 / np.prod(w_shape[1:])) ** 0.5)
    b = _arr(rng, w_shape[0], scale=0.05)
    tail = dict(pool_kernel=(3, 3), pool_stride=(2, 2))
    xc, tw_, tb = _OnCard(_t(x)), _t(w), _t(b)
    conv_ops.conv2d_pool_fused(xc, tw_, tb, stride, padding, True, **tail)
    conv_ops.conv2d_pool_carry(xc, tw_, tb, stride, padding, True, **tail)
    (w1, e1, a1), (w5, e5, a5) = calls
    assert (w1, e1) == (conv_ops.conv2d_pool_fused, "conv_pool_lrn_f32")
    assert (w5, e5) == (conv_ops.conv2d_pool_carry, "conv_pool_carry_f32")
    assert a1[0] is a5[0] is xc and a1[1][0] is a5[1][0] is tw_
    assert a1[2][0] is a5[2][0] is tb and a1[3:] == a5[3:]
    _, _, _, strides, pads, relus, pool, pool_relu, lrn = a1
    assert lrn is None and pool == POOL32 and not pool_relu
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), None, pool_carry=True) == "K5"
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), None) == "K1"
    emu = partial(_emulate_chain, ws=[tw_], bs=[tb], strides=strides,
                  pads=pads, relus=relus, pool=pool, lrn=lrn)
    k1, k5 = emu(_t(x)), emu(_t(x))
    assert torch.equal(k1, k5)
    assert torch.equal(emu(_t(x[:1]))[0], k1[0])
    ref = conv_ops.conv2d_pool_fused_ref(_t(x), tw_, tb, stride, padding,
                                         True, **tail)
    tol = TOL * max(1.0, ref.abs().max().item())
    _close(k1, ref.numpy(), tol)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=True, **tail,
                  pool_carry=True)(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b))
    _close(k1, theirs, tol)


@pytest.mark.parametrize("group", sorted(ALEX_GROUPS))
@pytest.mark.parametrize("n", [1, 16])
def test_k4_plan_is_k1s_at_alexnet(group, n, monkeypatch):
    """K4 at AlexNet's two LRN groups, full width, batch 1 and 16: the
    groups resolve to K4 under the LRN-blocking knob (to K1 without it),
    the K4 wrapper hands the stage-major launch what the K1 wrapper hands
    it (the same tensors, stage, pool and LRN; only the C entry differs),
    so ``chain_launch`` gives both one plan: K1's one-stage plan, whose
    tail holds every channel of a pixel (no halo), with the geometry the
    C entry checks (one stage, a pool, an LRN)."""
    in_chw, w_shape, stride, padding = ALEX_GROUPS[group]
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), ALEX_LRN[0],
                         lrn_oc_block=True) == "K4"
    assert tm.fused_cell(tm.Method.ADVANCED_SIMD_8, in_chw, w_shape, stride,
                         padding, (3, 3), (2, 2), ALEX_LRN[0]) == "K1"
    calls = _record_stage_major(monkeypatch)
    x = _OnCard(torch.zeros(1).expand(n, *in_chw))
    w, b = torch.zeros(w_shape), torch.zeros(w_shape[0])
    conv_ops.conv2d_pool_fused(x, w, b, stride, padding, True,
                               **ALEX_LRN_TAIL)
    conv_ops.conv2d_pool_lrn_halo(x, w, b, stride, padding, True,
                                  **ALEX_LRN_TAIL)
    (w1, e1, a1), (w4, e4, a4) = calls
    assert (w1, e1) == (conv_ops.conv2d_pool_fused, "conv_pool_lrn_f32")
    assert (w4, e4) == (conv_ops.conv2d_pool_lrn_halo,
                        "conv_pool_lrn_halo_f32")
    assert a1[0] is a4[0] is x and a1[1][0] is a4[1][0] is w
    assert a1[2][0] is a4[2][0] is b and a1[3:] == a4[3:]
    _, _, _, strides, pads, relus, pool, pool_relu, lrn = a4
    assert pool == POOL32 and lrn == ALEX_LRN and not pool_relu
    stages, plan, arrays, _ = conv_ops.chain_launch(
        n, in_chw, (w_shape,), tuple(map(tuple, strides)),
        tuple(map(tuple, pads)), tuple(relus), pool, pool_relu, lrn,
        REPORT_SMS)
    assert plan == conv_ops.chain_plan(stages, pool, n, REPORT_SMS)
    assert len(plan.stages) == 1 and plan.stages[0].ot_item == 1
    geo = arrays[0]
    assert (geo[1], geo[2], geo[8]) == (1, 1, ALEX_LRN[0])
    _, out_h, out_w = conv_ops.final_rows(stages, pool)
    assert plan.tail_items == n * out_h * out_w
    assert stages[0].OC <= conv_ops.CH_SMEM // 4


@pytest.mark.parametrize("group", sorted(K4_GROUPS))
def test_k4_and_k1_agree_bit_for_bit_in_emulation(group, monkeypatch):
    """On an LRN group, K4 hands the stage-major launch K1's arguments
    (so the two give the same bits), and the emulated schedule of those
    arguments at batch 2 gives frame 0 the bits of frame 0 alone and
    equals the plain version and the JAX package's jnp path under the
    LRN-blocking knob within 1e-4 · max(1, max|plain|)."""
    in_chw, w_shape, stride, padding = K4_GROUPS[group]
    calls = _record_stage_major(monkeypatch)
    rng = np.random.default_rng(len(group) + 4)
    x = _arr(rng, 2, *in_chw)
    w = _arr(rng, *w_shape, scale=(2.0 / np.prod(w_shape[1:])) ** 0.5)
    b = _arr(rng, w_shape[0], scale=0.05)
    xc, tw_, tb = _OnCard(_t(x)), _t(w), _t(b)
    conv_ops.conv2d_pool_fused(xc, tw_, tb, stride, padding, True,
                               **ALEX_LRN_TAIL)
    conv_ops.conv2d_pool_lrn_halo(xc, tw_, tb, stride, padding, True,
                                  **ALEX_LRN_TAIL)
    (_, _, a1), (_, _, a4) = calls
    assert a1[3:] == a4[3:]
    _, _, _, strides, pads, relus, pool, pool_relu, lrn = a4
    emu = partial(_emulate_chain, ws=[tw_], bs=[tb], strides=strides,
                  pads=pads, relus=relus, pool=pool, lrn=lrn,
                  pool_relu=pool_relu)
    k4 = emu(_t(x))
    assert torch.equal(emu(_t(x[:1]))[0], k4[0])
    ref = conv_ops.conv2d_pool_fused_ref(_t(x), tw_, tb, stride, padding,
                                         True, **ALEX_LRN_TAIL)
    tol = TOL * max(1.0, ref.abs().max().item())
    _close(k4, ref.numpy(), tol)
    theirs = _jit(jm.conv2d_pool_fused, method=jm.Method.ADVANCED_SIMD_8,
                  stride=stride, padding=padding, relu=True, **ALEX_LRN_TAIL,
                  lrn_oc_block=True)(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))
    _close(k4, theirs, tol)


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_equals_k1_on_the_cpu(case):
    """On the CPU the K4 wrapper and the K1 wrapper run one plain version:
    the same bits on every LRN case."""
    (xs, ws, stride, padding, relu, pk, ps, kind, pool_relu,
     lrn_n) = CELL_CASES[case]
    rng = np.random.default_rng(60 + len(case))
    x, w, b = _arr(rng, *xs), _arr(rng, *ws, scale=0.3), _arr(rng, ws[0])
    tail = dict(pool_kernel=pk, pool_stride=ps, pool_kind=kind,
                pool_relu=pool_relu, lrn_n=lrn_n, lrn_alpha=1e-3,
                lrn_beta=0.75, lrn_k=1.0)
    assert torch.equal(
        conv_ops.conv2d_pool_lrn_halo(_t(x), _t(w), _t(b), stride, padding,
                                      relu, **tail),
        conv_ops.conv2d_pool_fused(_t(x), _t(w), _t(b), stride, padding,
                                   relu, **tail))


@pytest.mark.parametrize("requested", [1, 8, 64, 100])
@pytest.mark.parametrize("n", [1, 16])
def test_k6_tiles_cover_the_final_stage_once(requested, n):
    """K6 runs K2's schedule with final-stage items of ``k6_ocb`` channels
    (the request rounded up to 64-wide core tiles): they cover every
    final channel once, and the earlier stages are K2's (no stage is
    recomputed per channel tile)."""
    ocb = conv_ops.k6_ocb(requested)
    assert ocb >= requested and ocb % conv_ops.ST_TO == 0
    k6 = conv_ops.chain_plan(ALEX_CHAIN, POOL32, n, REPORT_SMS, ocb)
    k2 = conv_ops.chain_plan(ALEX_CHAIN, POOL32, n, REPORT_SMS)
    assert k6.stages[:-1] == k2.stages[:-1]
    last = k6.stages[-1]
    assert last.ot_item * conv_ops.ST_TO == ocb
    owned = np.zeros((last.n_partials, 256), dtype=np.int64)
    for _, ch, _, q in _chain_items(ALEX_CHAIN[-1], last):
        assert len(ch) <= ocb
        owned[q, ch.start:ch.stop] += 1
    assert (owned == last.tiles_m).all()
    tile = conv_ops._tile(ocb, 256)
    assert tile[1] * ocb >= 256 > (tile[1] - 1) * ocb


def test_k6_emulated_by_tiles_equals_the_chain():
    rng = np.random.default_rng(2)
    x = _t(_arr(rng, 2, 4, 11, 11))
    ws = [_t(_arr(rng, 6, 4, 3, 3, scale=0.3)),
          _t(_arr(rng, 10, 6, 3, 3, scale=0.3))]
    bs = [_t(_arr(rng, 6)), _t(_arr(rng, 10))]
    args = ([(1, 1)] * 2, [(1, 1)] * 2, [True] * 2)
    ref = conv_ops.conv2d_chain_ref(x, ws, bs, *args, pool_kernel=(3, 3),
                                    pool_stride=(2, 2))
    ocb = 4
    parts = [conv_ops.conv2d_chain_ref(
        x, [ws[0], ws[1][u:u + ocb]], [bs[0], bs[1][u:u + ocb]], *args,
        pool_kernel=(3, 3), pool_stride=(2, 2)) for u in range(0, 10, ocb)]
    assert torch.equal(torch.cat(parts, dim=1), ref)

"""The port's language-model stack (``repro_torch.core.config``,
``configs``, ``nn``, ``models``, ``serving.engine``) against the JAX
package, on the CPU, with the same weights carried across by
``params_from_jax``.

The JAX side runs its jnp paths (``use_pallas=False``: ``dense`` as
einsum, ``chunked_attention``), never Pallas (ROADMAP.md §3, R1).  The
two packages' PRNGs differ, so weights and inputs come from the JAX
package's init or from numpy, never from a shared seed.
"""
import dataclasses
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.kernels.matmul_fused.ref import matmul_fused_ref as jax_mm_ref
from repro.models import registry as jregistry
from repro.nn import embedding as jemb
from repro.nn import norm as jnorm
from repro.nn import rope as jrope
from repro.serving import engine as jengine
from repro_torch.core import config as tconfig
from repro_torch.kernels import _build
from repro_torch.kernels.matmul_fused import ops as mm_ops
from repro_torch.kernels.matmul_fused.ops import (TILED_MIN_M, k3_path,
                                                  matmul_fused, split_k)
from repro_torch.kernels.matmul_fused.ref import _ACTS
from repro_torch.models import registry as tregistry
from repro_torch.models.common import CACHE_BATCH_AXIS, params_from_jax
from repro_torch.nn import embedding as temb
from repro_torch.nn import norm as tnorm
from repro_torch.nn import rope as trope
from repro_torch.nn.param import Param, init_tree, tree_leaves
from repro_torch.nn.sampling import sample
from repro_torch.serving import engine as tengine
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ["gemma2-2b", "internlm2-20b"]


def _cfgs(arch, dtype="float32"):
    j = dataclasses.replace(jconfig.get_arch(arch).reduced(), dtype=dtype,
                            param_dtype=dtype)
    t = dataclasses.replace(tconfig.get_arch(arch).reduced(), dtype=dtype,
                            param_dtype=dtype)
    return j, t


_MODELS = {}


def _models(arch, dtype="float32"):
    """(JAX model, JAX params, port model) with the same weights: the JAX
    package's init, carried over by ``params_from_jax``."""
    key = (arch, dtype)
    if key not in _MODELS:
        jcfg, tcfg = _cfgs(arch, dtype)
        jm = jregistry.get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tm = tregistry.get_model(tcfg)
        tm.load_tree(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tcfg, device="cpu"))
        _MODELS[key] = (jm, jp, tm)
    return _MODELS[key]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, tol):
    """max |ours - ref| <= tol * max(1, max |ref|)."""
    a, b = _f32(ours), _f32(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


#: relative to max(1, max|ref|).  float32: the same fp32 arithmetic in
#: another order (K3's plain version against XLA's einsum, K10's against
#: the chunked scan) — 1e-4 on the logits.  The caches and the decode
#: logits read a bf16 cache (the JAX default at every param dtype): a k or
#: v that differs in its last fp32 bits may round to the neighbouring bf16
#: value, one ulp (2^-7 relative) of that element — the caches are held
#: to 2^-7, the decode logits to 2e-3.  bfloat16 params: every activation
#: is rounded to bf16 (2^-8) some ten times a block, at places the two
#: packages choose differently (JAX applies dense's activation after its
#: bf16 cast, K3 before; JAX's chunked attention casts p to bf16, K10
#: does not) — 2^-4 on the logits, 2^-5 on the caches.
TOL = {"float32": {"logits": 1e-4, "cache": 2.0 ** -7, "decode": 2e-3},
       "bfloat16": {"logits": 2.0 ** -4, "cache": 2.0 ** -5,
                    "decode": 2.0 ** -4}}


# -- configs ------------------------------------------------------------------


def test_config_registry_matches_jax():
    assert tconfig.list_archs() == jconfig.list_archs()


@pytest.mark.parametrize("arch", jconfig.list_archs())
def test_configs_match_jax(arch):
    j, t = jconfig.get_arch(arch), tconfig.get_arch(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert t.padded_vocab == j.padded_vocab


@pytest.mark.parametrize("arch", jconfig.list_archs())
def test_get_model_dense_only(arch):
    """Every arch builds, dense, MoE, RWKV6 (``ssm``), zamba2 (``hybrid``)
    and the cross-attention families (``vlm``, ``audio``), with JAX's
    parameter counts: all, active (an MoE model's experts at k of E) and
    without the embedding (rwkv6-1.6b: 1,599,673,856 at full width;
    qwen3-moe-30b-a3b: 30,532,122,624, 3,353,032,704 active,
    29,909,792,768 without the embedding; zamba2-1.2b: 1,279,542,144;
    llama-3.2-vision-11b: 9,791,938,576 and 8,741,265,424;
    seamless-m4t-large-v2: 1,633,850,368 and 1,109,038,080).  The name
    is the one the test had while only the text families built."""
    cfg = tconfig.get_arch(arch)
    assert cfg.family in ("dense", "ssm", "moe", "hybrid", "vlm", "audio")
    jcfg = jconfig.get_arch(arch)
    counts = [tregistry.analytic_param_count(cfg, **kw) for kw in (
        {}, {"active_only": True}, {"non_embedding": True})]
    assert counts == [jregistry.analytic_param_count(jcfg, **kw)
                      for kw in ({}, {"active_only": True},
                                 {"non_embedding": True})]
    assert (cfg.num_params(), cfg.active_params()) == (
        jcfg.num_params(), jcfg.active_params()) == tuple(counts[:2])
    assert type(tregistry.get_model(cfg)).__name__ == type(
        jregistry.get_model(jcfg)).__name__
    if cfg.family == "ssm":
        assert cfg.num_params() == 1_599_673_856
    if cfg.family == "hybrid":
        assert cfg.num_params() == 1_279_542_144
    if arch == "qwen3-moe-30b-a3b":
        assert counts == [30_532_122_624, 3_353_032_704,
                          29_909_792_768]
    if cfg.family == "vlm":
        assert counts[::2] == [9_791_938_576, 8_741_265_424]
    if cfg.family == "audio":
        assert counts[::2] == [1_633_850_368, 1_109_038_080]
    if cfg.moe is None:
        assert counts[1] == counts[0]


def test_gemma2_full_width_shape():
    cfg = tconfig.get_arch("gemma2-2b")
    m = tregistry.get_model(cfg)
    assert (m.n_scan, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
                13, 2304, 8, 4, 256, 9216, 256000)
    assert len(m.layers) == 13 and set(m.layers[0]._modules) == {
        "local", "global"}
    assert all(p.device.type == "meta" for p in m.parameters())
    assert 2.6e9 < cfg.num_params() < 2.7e9
    # the JAX cache spec, [n_scan, batch, S, kvh, hd], bf16
    spec = m.cache_spec(4, 8192)
    assert spec["local"]["k"].shape == (13, 4, 4096, 4, 256)
    assert spec["global"]["k"].shape == (13, 4, 8192, 4, 256)
    assert CACHE_BATCH_AXIS == 1


# -- parameters ---------------------------------------------------------------


def test_init_tree_rules():
    """normal / embed / fan_in (2-D: rows; 3-D: the middle axis, the stack
    axis not counting) / zeros / ones, in the spec's dtype."""
    spec = {"a": Param((400, 300), ("x", "y"), init="fan_in"),
            "b": Param((5, 100, 300), ("l", "x", "y"), init="fan_in",
                       scale=2.0),
            "c": Param((200, 100), ("x", "y"), init="normal", scale=0.5),
            "e": Param((300, 64), ("x", "y"), init="embed", scale=0.02,
                       dtype="float32"),
            "o": Param((7,), ("x",), init="ones"),
            "z": Param((7,), ("x",), init="zeros", dtype="float32")}
    t = init_tree(spec, torch.Generator().manual_seed(0), "bfloat16")
    assert t["a"].dtype == torch.bfloat16 and t["e"].dtype == torch.float32
    for name, std in (("a", 400 ** -0.5), ("b", 2 * 100 ** -0.5),
                      ("c", 0.5), ("e", 0.02)):
        assert abs(t[name].float().std().item() / std - 1) < 0.05, name
    assert torch.equal(t["o"], torch.ones(7, dtype=torch.bfloat16))
    assert torch.equal(t["z"], torch.zeros(7))
    again = init_tree(spec, torch.Generator().manual_seed(0), "bfloat16")
    assert all(torch.equal(x, y) for x, y in
               zip(tree_leaves(t), tree_leaves(again)))


def test_params_from_jax_is_bit_exact_for_bf16():
    """bf16 leaves cross through their bits (ml_dtypes -> uint16 ->
    torch.bfloat16) and come back unchanged."""
    jm, jp, tm = _models("gemma2-2b", "bfloat16")
    jl = jax.tree_util.tree_leaves(jp)
    tl = tree_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                     tm.cfg, device="cpu"))
    assert len(jl) == len(tl) and any(x.dtype == jnp.bfloat16 for x in jl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        if a.dtype == jnp.bfloat16:
            assert b.dtype == torch.bfloat16
            assert np.array_equal(a.view(np.uint16),
                                  b.view(torch.int16).numpy().view(np.uint16))
            back = np.asarray(b.view(torch.int16).numpy()).view(jnp.bfloat16)
            assert np.array_equal(back.view(np.uint16), a.view(np.uint16))
        else:
            assert np.array_equal(a, b.numpy())
    # the model's parameters are those tensors, per layer unit
    w = tm.layers[0]["global"]["attn"]["wq"]["w"]
    assert np.array_equal(
        np.asarray(jp["layers"]["global"]["attn"]["wq"]["w"][0]).view(
            np.uint16), w.view(torch.int16).numpy().view(np.uint16))


def test_params_from_jax_checks_the_tree():
    jm, jp, tm = _models("internlm2-20b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    bad = dict(tree, ln_f={"scale": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, tm.cfg)
    with pytest.raises(ValueError, match="keys"):
        params_from_jax(dict(tree, extra={}), tm.cfg)


def test_params_from_jax_without_a_device_needs_a_gpu(monkeypatch):
    """No device and no GPU: it raises instead of building the tree on
    the CPU (the model would then quietly run there); with one asked for,
    the leaves land on it."""
    jm, jp, tm = _models("internlm2-20b")
    tree = jax.tree_util.tree_map(np.asarray, jp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(tree, tm.cfg)
    leaves = tree_leaves(params_from_jax(tree, tm.cfg, device="cpu"))
    assert leaves and all(x.device.type == "cpu" for x in leaves)


# -- layers -------------------------------------------------------------------


@pytest.mark.parametrize("plus_one", [False, True])
def test_norms_match_jax(plus_one):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6),
                         (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)):
        tx, jx = torch.from_numpy(x).to(dt), jnp.asarray(x, jdt)
        _close(tnorm.rmsnorm_apply({"scale": torch.from_numpy(w)}, tx,
                                   plus_one=plus_one),
               jnorm.rmsnorm_apply({"scale": jnp.asarray(w)}, jx,
                                   plus_one=plus_one), tol)
        p = {"scale": w, "bias": bias}
        _close(tnorm.layernorm_apply(
            {k: torch.from_numpy(v) for k, v in p.items()}, tx),
            jnorm.layernorm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                  jx), tol)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 4, 64)).astype(np.float32)
    pos = np.arange(100, 109)[None, :]
    for theta in (10000.0, 1e6):
        _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta),
               jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               1e-5)


def test_embedding_and_logits_match_jax():
    jcfg, tcfg = _cfgs("gemma2-2b")
    jcfg = dataclasses.replace(jcfg, vocab_size=500)  # a padded vocab
    tcfg = dataclasses.replace(tcfg, vocab_size=500)
    rng = np.random.default_rng(2)
    tok = rng.standard_normal((tcfg.padded_vocab, 256)).astype(np.float32)
    ids = rng.integers(0, 500, (2, 7))
    x = temb.embed_tokens({"tok": torch.from_numpy(tok)},
                          torch.from_numpy(ids), tcfg, scale_by_dim=True)
    jx = jemb.embed_tokens({"tok": jnp.asarray(tok)}, jnp.asarray(ids), jcfg,
                           scale_by_dim=True)
    _close(x, jx, 0.0)
    lg = temb.lm_logits({"tok": torch.from_numpy(tok)}, x, tcfg)
    jlg = jemb.lm_logits({"tok": jnp.asarray(tok)}, jx, jcfg)
    assert lg.dtype == torch.float32 and lg.shape == (2, 7, 512)
    assert torch.all(lg[..., 500:] == -1e30)
    _close(lg, jlg, 1e-5)


@pytest.mark.parametrize("act", ["none", "gelu", "silu"])
@pytest.mark.parametrize("m", [4, 70])
def test_k3_plain_version_takes_bf16(act, m):
    """K3's plain version on bf16 operands: upcast, fp32 sums, bias and
    activation, one cast to bf16 — JAX's ``matmul_fused_ref`` does the
    same, so both give one rounding of the same fp32 result."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)
    b = rng.standard_normal(40).astype(np.float32)
    ours = matmul_fused(torch.from_numpy(x).bfloat16(),
                        torch.from_numpy(w).bfloat16(), torch.from_numpy(b),
                        act)
    assert ours.dtype == torch.bfloat16
    ref = jax_mm_ref(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                     jnp.asarray(b), act)
    _close(ours, ref, 2.0 ** -7)


#: K3's projection shapes (K, N) in a gemma2-2b block (q, k/v, o, gate/up,
#: down), an rwkv6-1.6b layer (2048 -> 2048, the channel mix's key and
#: value), a qwen3-moe-30b-a3b attention (q, k/v, o), a starcoder2-15b
#: block (q/o, k/v, up, down; grok-1-314b's q/o too), internlm2-20b's (k/v
#: and grok-1-314b's, gate/up, down) and qwen1.5-32b's (q/k/v/o, gate/up,
#: down).  starcoder2's up and qwen1.5's gate/up stream in one K slice
#: on 132 SMs
LM_K3_SHAPES = ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
                (9216, 2304), (2048, 2048), (2048, 7168), (7168, 2048),
                (2048, 4096), (2048, 512), (4096, 2048),
                (6144, 6144), (6144, 512), (6144, 24576), (24576, 6144),
                (6144, 1024), (6144, 16384), (16384, 6144),
                (5120, 5120), (5120, 27392), (27392, 5120))
#: the shapes whose weight stream takes one K slice on 132 SMs: every
#: column block alone, no cluster reduction
ONE_SLICE_SHAPES = ((6144, 24576), (5120, 27392))
#: the M of the served prompts (16, 300, 1500, 4500 tokens), a decode step
#: at 4 slots, and the edges of the tiled paths
LM_K3_ROWS = (1, 4, 16, 63, 64, 300, 1500, 4500)


@pytest.mark.parametrize("m,path", [(1, "stream"), (4, "stream"),
                                    (16, "stream"), (63, "stream"),
                                    (64, "tiled"), (300, "tiled"),
                                    (4500, "tiled"), (64, "wgmma"),
                                    (300, "wgmma"), (1500, "wgmma"),
                                    (4500, "wgmma")])
def test_k3_paths_at_lm_shapes(m, path):
    """A decode step (M = 4) and short prompts stream the weights in one
    launch, in K slices of one cluster that leave no partial sums in
    global memory; a prefill of 64 tokens and more takes a tiled path: the
    tensor-core tile (TMA + wgmma) for the bf16 served model at every
    projection shape, the CUDA-core tile for fp32."""
    if path == "wgmma":
        for k, n in LM_K3_SHAPES:
            assert k3_path(torch.bfloat16, m, k, n) == "wgmma"
            assert k3_path(torch.float32, m, k, n) == "tiles"
        return
    assert (m >= TILED_MIN_M) == (path == "tiled")
    if path == "tiled":
        return
    for k, n in ((2304, 2048), (2304, 1024), (2048, 2304), (2304, 9216),
                 (9216, 2304)):
        assert k3_path(torch.bfloat16, m, k, n) == "stream"
        splits, kchunk = split_k(torch.bfloat16, k, n, 132)
        assert kchunk % mm_ops.STREAM_BK[torch.bfloat16] == 0
        assert (splits - 1) * kchunk < k <= splits * kchunk
        # one cluster of slices; every block's partial tile of the call's
        # rows (padded to the row tile) stays in its own shared memory
        assert 1 <= splits <= mm_ops.STREAM_CLUSTER
        rows = _stream_rows(torch.bfloat16, m)
        assert m <= rows and 2 * rows * mm_ops.STREAM_BN * 4 <= \
            _stream_smem(torch.bfloat16, m)


@pytest.mark.parametrize("m", LM_K3_ROWS)
@pytest.mark.parametrize("k,n", LM_K3_SHAPES)
def test_k3_path_choice(m, k, n):
    """K3's path comes from the type, M, K, N and the pointers alone: the
    weight stream below 64 rows in either type; from 64 on, wgmma for bf16
    that TMA can describe and the CUDA-core tile otherwise — fp32, a row
    stride that is not a multiple of 16 bytes (K or N not a multiple of
    8), a base that is not 16-byte aligned."""
    want = "stream" if m < 64 else "wgmma"
    assert k3_path(torch.bfloat16, m, k, n) == want
    assert k3_path(torch.bfloat16, m, k, n, 256, 1 << 20) == want
    tiled = "stream" if m < 64 else "tiles"
    assert k3_path(torch.float32, m, k, n) == tiled
    assert k3_path(torch.bfloat16, m, k, n + 4) == tiled
    assert k3_path(torch.bfloat16, m, k + 4, n) == tiled
    assert k3_path(torch.bfloat16, m, k, n, x_ptr=8) == tiled
    assert k3_path(torch.bfloat16, m, k, n, w_ptr=2) == tiled


def test_k3_path_counters_start_at_zero_and_the_cpu_moves_none():
    """The wrapper counts its launches by path; the plain version on the
    CPU launches nothing."""
    assert set(matmul_fused.path_launches) == {"stream", "tiles", "wgmma"}
    before = (matmul_fused.launches, dict(matmul_fused.path_launches))
    matmul_fused(torch.ones(70, 16, dtype=torch.bfloat16),
                 torch.ones(16, 8, dtype=torch.bfloat16))
    assert (matmul_fused.launches, matmul_fused.path_launches) == before


def _wgmma_constants():
    """The wgmma path's integer constants (``WG_BM``, ``WG_BN``,
    ``WG_BK``, ``WG_STAGES``, ``WG_THREADS``) as the kernel's source
    declares them."""
    src = (_build.CSRC / "matmul_fused.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"\b(WG_[A-Z]+) = (\d+)[,;]", src)}


#: N columns of one w box (``tensor_map(&wmap, ..., WG_BK, 64)``: a
#: 128-byte swizzle row of bf16)
WG_BOX_N = 64
#: dynamic shared memory a block may opt in to on the H100 (227 KB)
SMEM_LIMIT = 232448


def wgmma_geometry(m, k, n):
    """What the wgmma kernel launches for an ``[m, k] x [k, n]`` bf16
    product, from its source's constants: the tile (``bm`` x ``bn``,
    whatever the shape), the grid in launch order (M first when M < N),
    the K steps, the TMA boxes (inner extent first, in elements) with their
    row strides in bytes, the bytes one stage's loads bring and the ring's
    dynamic shared memory (``WG_SMEM`` in the source)."""
    c = _wgmma_constants()
    bm, bn, bk, stages = c["WG_BM"], c["WG_BN"], c["WG_BK"], c["WG_STAGES"]
    x_box, w_box = (bk, bm), (WG_BOX_N, bk)
    tiles = (math.ceil(n / bn), math.ceil(m / bm))
    stage = 2 * (x_box[0] * x_box[1] + bn // WG_BOX_N * w_box[0] * w_box[1])
    return {"bm": bm, "bn": bn, "bk": bk, "stages": stages,
            "threads": c["WG_THREADS"],
            "grid": tiles[::-1] if m < n else tiles,
            "k_steps": math.ceil(k / bk),
            "x_box": x_box, "w_box": w_box, "w_boxes": bn // WG_BOX_N,
            "x_stride": 2 * k, "w_stride": 2 * n, "stage_bytes": stage,
            "smem": stages * stage + 1024 + 2 * stages * 8}


@pytest.mark.parametrize("m", [64, 300, 1500, 4500])
@pytest.mark.parametrize("k,n", LM_K3_SHAPES)
def test_wgmma_geometry_at_lm_shapes(m, k, n):
    """The wgmma kernel's geometry, read from its source: one tile shape
    whatever the rows (a row's sums never depend on M), two consumer
    warpgroups of 64 rows each beside the producer, tiles that cover the
    output once, a ring that fits the 227 KB a block may opt in to, TMA
    boxes with inner extents of at most 128 bytes (the 128-byte swizzle's
    row) and row strides that are multiples of 16 bytes, and w's boxes
    covering the tile's width."""
    g = wgmma_geometry(m, k, n)
    assert (g["bm"], g["bn"], g["bk"]) == (128, 128, 64)
    assert g["threads"] == 128 * (1 + g["bm"] // 64)
    tiles = g["grid"] if m >= n else g["grid"][::-1]
    assert (tiles[0] - 1) * g["bn"] < n <= tiles[0] * g["bn"]
    assert (tiles[1] - 1) * g["bm"] < m <= tiles[1] * g["bm"]
    assert g["k_steps"] * g["bk"] >= k > (g["k_steps"] - 1) * g["bk"]
    assert g["smem"] <= SMEM_LIMIT
    for box in (g["x_box"], g["w_box"]):
        assert 2 * box[0] <= 128 and (2 * box[0]) % 16 == 0
        assert max(box) <= 256
    assert g["x_box"] == (g["bk"], g["bm"])
    assert g["w_box"][1] == g["bk"] and g["w_boxes"] * g["w_box"][0] == g["bn"]
    assert g["x_stride"] % 16 == 0 and g["w_stride"] % 16 == 0
    assert g["stage_bytes"] == 2 * (g["bm"] * g["bk"] + g["bk"] * g["bn"])
    # the epilogue stages a warpgroup's 64 x bn bf16 rows in its halves of
    # the ring's x boxes
    assert g["stages"] * g["bm"] // 2 * g["bk"] * 2 >= 64 * g["bn"] * 2


def _wgmma_emulated(x, w, b, act):
    """The wgmma path's tile walk in plain PyTorch: 128 x bn output tiles,
    each summing K in steps of 64 from boxes that TMA fills with zeros past
    M, K and N, the bias and the activation on the fp32 sums, one cast to
    bf16, the rows and columns past M and N dropped."""
    m, k = x.shape
    n = w.shape[1]
    g = wgmma_geometry(m, k, n)
    bm, bn, bk = g["bm"], g["bn"], g["bk"]
    tiles = g["grid"] if m >= n else g["grid"][::-1]
    xp = torch.zeros(tiles[1] * bm, g["k_steps"] * bk)
    xp[:m, :k] = x.float()
    wp = torch.zeros(g["k_steps"] * bk, tiles[0] * bn)
    wp[:k, :n] = w.float()
    y = torch.empty(m, n, dtype=torch.bfloat16)
    for i in range(tiles[1]):
        for j in range(tiles[0]):
            acc = torch.zeros(bm, bn)
            for s in range(g["k_steps"]):
                acc += (xp[i * bm:(i + 1) * bm, s * bk:(s + 1) * bk]
                        @ wp[s * bk:(s + 1) * bk, j * bn:(j + 1) * bn])
            if b is not None:
                bt = torch.zeros(bn)
                cols = b[j * bn:(j + 1) * bn]
                bt[:len(cols)] = cols
                acc += bt
            out = _ACTS[act](acc).to(torch.bfloat16)
            rows = min(bm, m - i * bm)
            ncols = min(bn, n - j * bn)
            y[i * bm:i * bm + rows, j * bn:j * bn + ncols] = \
                out[:rows, :ncols]
    return y


@pytest.mark.parametrize("m,k,n,act", [(200, 72, 136, "silu"),
                                       (130, 264, 40, "gelu"),
                                       (64, 64, 128, "relu"),
                                       (70, 1040, 200, "none")])
def test_wgmma_schedule_matches_jax(m, k, n, act):
    """The tile walk that the wgmma kernel's source declares covers the
    output once and zero-fills the boxes past M, K and N without changing
    a sum — ragged M, a K tail inside the last 64-wide box, N narrower than
    a tile or past the last whole one — so it reproduces JAX's
    ``matmul_fused_ref`` on the same bf16 operands within one bf16
    rounding.  It checks the schedule, not the kernel: the card holds the
    kernel to the plain version element by element (``chip_smoke.py``)."""
    assert k3_path(torch.bfloat16, m, k, n) == "wgmma"
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ours = _wgmma_emulated(torch.from_numpy(x).bfloat16(),
                           torch.from_numpy(w).bfloat16(),
                           torch.from_numpy(b), act)
    ref = jax_mm_ref(jnp.asarray(x, jnp.bfloat16),
                     jnp.asarray(w, jnp.bfloat16), jnp.asarray(b), act)
    _close(ours, ref, 2.0 ** -7)


# -- K3's weight stream (M < 64) -----------------------------------------------


def _stream_constants():
    """The weight stream's integer constants (``SW_*``) as the kernel's
    source declares them."""
    src = (_build.CSRC / "matmul_fused.cu").read_text()
    return {name: int(v) for name, v in
            re.findall(r"\b(SW_[A-Z0-9_]+) = (\d+)[,;]", src)}


def _stream_rows(dtype, m):
    """Rows of the stream's block tile for ``m`` rows, as ``launch_stream``
    picks them: 16-row m tiles for bf16 (the tensor cores' m16), 4, 8,
    16, 32 or 64 for fp32."""
    if dtype == torch.bfloat16:
        return 16 * math.ceil(m / 16)
    return next(r for r in (4, 8, 16, 32, 64) if m <= r)


def _stream_smem(dtype, m):
    """The stream's dynamic shared memory at ``m`` rows, from the source's
    constants (``sw_smem16`` / ``sw_smem32``): ``SW_STAGES`` stages of
    w's [stage rows, SW_BN] tile and x's [rows, stage rows] tile, bf16
    rows padded by ``SW_PAD16``."""
    c = _stream_constants()
    rows = _stream_rows(dtype, m)
    if dtype == torch.bfloat16:
        return (c["SW_STAGES"] * (c["SW_BK16"] + rows)
                * (c["SW_BN"] + c["SW_PAD16"]) * 2)
    return c["SW_STAGES"] * c["SW_BK32"] * (c["SW_BN"] + rows) * 4


#: AlexNet's fc layers (K, N), fp32: fc6, fc7, fc8
ALEX_FC = ((9216, 4096), (4096, 4096), (4096, 1000))
#: the cross families' projections (K, N), bf16: seamless-m4t-large-v2's
#: q/k/v/o (8 K slices of 2 ring stages), MLP up and down;
#: llama-3.2-vision-11b's q/o, k/v, gate/up and down
CROSS_K3_SHAPES = ((1024, 1024), (1024, 8192), (8192, 1024), (4096, 4096),
                   (4096, 1024), (4096, 14336), (14336, 4096))
#: every stream shape of the main paths: the language models' projections
#: in bf16, AlexNet's fc layers in fp32
STREAM_SHAPES = ([("bfloat16", k, n) for k, n in LM_K3_SHAPES
                  + CROSS_K3_SHAPES]
                 + [("float32", k, n) for k, n in ALEX_FC])
#: SMs of the cards the slicing is checked for: H100 SXM, H100 PCIe, and
#: a small one
STREAM_SMS = (132, 114, 20)


def test_stream_constants_match_the_wrapper():
    """The wrapper's copies of the stream's constants agree with the
    source; the ring has at least three stages, a cluster is within the
    portable 8 blocks, and the row tiles reach past the 63 rows the stream
    takes."""
    c = _stream_constants()
    assert c["SW_BN"] == mm_ops.STREAM_BN
    assert (c["SW_BK16"], c["SW_BK32"]) == (
        mm_ops.STREAM_BK[torch.bfloat16], mm_ops.STREAM_BK[torch.float32])
    assert c["SW_STAGES"] >= 3
    assert c["SW_CLUSTER"] == mm_ops.STREAM_CLUSTER <= 8
    assert c["SW_BLOCKS_PER_SM"] == mm_ops.STREAM_BLOCKS_PER_SM
    assert 16 * c["SW_MT"] >= TILED_MIN_M - 1
    assert c["SW_BM32"] >= TILED_MIN_M - 1
    assert _build.SIGNATURES["matmul_fused_bf16"] == \
        _build.SIGNATURES["matmul_fused_f32"] == \
        [_build._P] * 4 + [_build._I] * 7 + [_build._P]


class _Entry:
    """A stand-in of K3's C entries that records each call's arguments and
    whether each pointer it gets is the data of a tensor that is alive
    when it is called."""

    def __init__(self, tensors=()):
        import weakref

        self.refs = [weakref.ref(t) for t in tensors]
        self.calls = []

    def track(self, t):
        import weakref

        self.refs.append(weakref.ref(t))
        return t

    def __call__(self, *args):
        live = {t.data_ptr() for t in (r() for r in self.refs)
                if t is not None}
        self.calls.append((args, [p in live for p in args[:4]
                                  if p is not None]))
        return 0


def _stand_in(monkeypatch, entry, sms=132):
    """Route ``_launch`` to ``entry`` with CPU tensors standing in for the
    card's, and record every tensor ``torch.empty`` makes."""
    made = []
    empty = torch.empty

    def recording(*a, **kw):
        made.append(entry.track(empty(*a, **kw)))
        return made[-1]

    lib = type("Lib", (), {"matmul_fused_bf16": entry,
                           "matmul_fused_f32": entry})()
    monkeypatch.setattr(mm_ops, "check_cuda", lambda *a, **kw: None)
    monkeypatch.setattr(mm_ops, "sm_count", lambda dev: sms)
    monkeypatch.setattr(mm_ops, "_stream", lambda dev: 7)
    monkeypatch.setattr(mm_ops.torch, "empty", recording)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(matmul_fused, "launches", 0)
    monkeypatch.setattr(matmul_fused, "path_launches",
                        dict.fromkeys(mm_ops.PATH_CODES, 0))
    return made


@pytest.mark.parametrize("dtype,k,n", STREAM_SHAPES)
def test_stream_slicing_is_the_same_for_every_m(dtype, k, n, monkeypatch):
    """``_launch`` at every M from 1 to 63 hands the C entry the stream's
    path code and one K slicing (splits, rows a slice): a row's sum order
    never depends on how many rows share the call."""
    dt = getattr(torch, dtype)
    entry = _Entry()
    _stand_in(monkeypatch, entry)
    w = torch.zeros(1, dtype=dt).expand(k, n)
    for m in range(1, TILED_MIN_M):
        mm_ops._launch(torch.zeros(1, dtype=dt).expand(m, k), w, None,
                       "none")
    slicings = {args[8:10] for args, _ in entry.calls}
    assert len(entry.calls) == TILED_MIN_M - 1
    assert slicings == {split_k(dt, k, n, 132)}
    assert {args[4:8] for args, _ in entry.calls} == {
        (m, n, k, mm_ops.PATH_CODES["stream"]) for m in range(1, 64)}
    assert matmul_fused.path_launches["stream"] == TILED_MIN_M - 1


@pytest.mark.parametrize("dtype,k,n", STREAM_SHAPES)
def test_stream_slices_cover_k_once(dtype, k, n):
    """The slices [s kchunk, min(K, (s + 1) kchunk)) of every card's
    slicing are whole ring stages, none empty, and cover K once."""
    dt = getattr(torch, dtype)
    for sms in STREAM_SMS:
        splits, kchunk = split_k(dt, k, n, sms)
        assert kchunk % mm_ops.STREAM_BK[dt] == 0
        rows = [r for s in range(splits)
                for r in range(s * kchunk, min(k, (s + 1) * kchunk))]
        assert rows == list(range(k))
        assert all(s * kchunk < k for s in range(splits))


@pytest.mark.parametrize("dtype,k,n", STREAM_SHAPES)
def test_stream_fits_the_card(dtype, k, n):
    """At every M below 64: the cluster (the slices of a column block) is
    within ``SW_CLUSTER``; the ring fits the 227 KB a block may opt in to
    and also holds the partial tiles (bf16: two of the row tile; fp32:
    the k-way tree's four); the stages in flight keep at least 16 KB of
    weights a block; the grid's column blocks are within CUDA's 65535."""
    c = _stream_constants()
    dt = getattr(torch, dtype)
    splits, _ = split_k(dt, k, n, 132)
    assert 1 <= splits <= c["SW_CLUSTER"]
    assert math.ceil(n / c["SW_BN"]) <= 65535
    bf16 = dt == torch.bfloat16
    bk = c["SW_BK16"] if bf16 else c["SW_BK32"]
    elt = 2 if bf16 else 4
    assert (c["SW_STAGES"] - 1) * bk * c["SW_BN"] * elt >= 16 * 1024
    for m in range(1, TILED_MIN_M):
        rows = _stream_rows(dt, m)
        ring = _stream_smem(dt, m)
        parts = (2 if bf16 else 4) * rows * c["SW_BN"] * 4
        assert ring <= SMEM_LIMIT
        assert parts <= ring and m <= rows


def _fma(acc, a, b):
    """fmaf in float64: the product of two fp32 (or bf16) values is exact
    there; the sum is rounded once to float64, then to fp32."""
    return (acc.double() + a.double() * b.double()).float()


def _stream_emulated(x, w, b, act, sms=132):
    """The weight stream's summation order in plain PyTorch, for every row
    of ``x`` at once, with ``split_k``'s slicing and the source's
    constants: per K slice, fp32 (8 warps, warp j the stage rows 4 j to
    4 j + 3 by FMA, then the tree ((w0 + w4) + (w2 + w6)) + ((w1 + w5) +
    (w3 + w7))) or bf16 (each k16 step one tensor-core product, its 16 products
    summed exactly and added to the accumulator with one rounding; warps
    0-3 the even steps of a stage, 4-7 the odd ones, then even + odd);
    then the slices in rank order, the bias, the activation and one cast.
    Rows past K are zeros, which change no sum."""
    c = _stream_constants()
    m, k = x.shape
    n = w.shape[1]
    bf16 = x.dtype == torch.bfloat16
    bk = c["SW_BK16"] if bf16 else c["SW_BK32"]
    splits, kchunk = split_k(x.dtype, k, n, sms)
    xf, wf = x.float(), w.float()
    parts = []
    for s in range(splits):
        k0, k1 = s * kchunk, min(k, (s + 1) * kchunk)
        if bf16:
            acc = [torch.zeros(m, n), torch.zeros(m, n)]  # even, odd steps
            for t0 in range(k0, k1, bk):
                for j in range(bk // 16):
                    lo, hi = t0 + 16 * j, min(k1, t0 + 16 * j + 16)
                    if lo >= hi:
                        continue
                    prod = xf[:, lo:hi].double() @ wf[lo:hi].double()
                    acc[j % 2] = (acc[j % 2].double() + prod).float()
            parts.append(acc[0] + acc[1])
        else:
            acc = [torch.zeros(m, n) for _ in range(8)]
            for r in range(k0, k1):
                j = (r - k0) % bk // 4
                acc[j] = _fma(acc[j], xf[:, r:r + 1], wf[r:r + 1])
            parts.append(((acc[0] + acc[4]) + (acc[2] + acc[6]))
                         + ((acc[1] + acc[5]) + (acc[3] + acc[7])))
    v = parts[0]
    for p in parts[1:]:
        v = v + p
    if b is not None:
        v = v + b
    return _ACTS[act](v).to(x.dtype)


#: a stream shape of several K slices with a ragged K tail and a ragged
#: last column block
STREAM_EMU = (300, 100)


def test_one_slice_shapes_are_the_lm_shapes_with_one_slice():
    """On 132 SMs the stream slices K once exactly at starcoder2-15b's up
    (6144 -> 24576, 384 column blocks) and qwen1.5-32b's gate/up (5120 ->
    27392, 428): ``(1, K)``, K a whole number of ring stages; every
    other language-model shape takes 2 to 8 slices."""
    for k, n in LM_K3_SHAPES:
        splits, kchunk = split_k(torch.bfloat16, k, n, 132)
        if (k, n) in ONE_SLICE_SHAPES:
            assert (splits, kchunk) == (1, k)
            assert k % mm_ops.STREAM_BK[torch.bfloat16] == 0
            assert math.ceil(n / mm_ops.STREAM_BN) >= \
                mm_ops.STREAM_BLOCKS_PER_SM * 132
        else:
            assert 2 <= splits <= mm_ops.STREAM_CLUSTER, (k, n)


#: a one-slice stream shape on a card of ``ONE_SLICE_EMU[2]`` SMs, with a
#: ragged K tail and a ragged last column block
ONE_SLICE_EMU = (300, 580, 4)


@pytest.mark.parametrize("m", [1, 4, 16, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_slice_stream_order_matches_jax(dtype, m):
    """The stream's summation order with one K slice (no cluster sum: the
    block's own partial tile, the bias, the activation, one cast)
    reproduces JAX's ``matmul_fused_ref`` within today's tolerance, as
    the sliced order does."""
    k, n, sms = ONE_SLICE_EMU
    dt = getattr(torch, dtype)
    assert split_k(dt, k, n, sms) == (1, math.ceil(
        k / mm_ops.STREAM_BK[dt]) * mm_ops.STREAM_BK[dt])
    rng = np.random.default_rng(m + 100)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ours = _stream_emulated(torch.from_numpy(x).to(dt),
                            torch.from_numpy(w).to(dt), torch.from_numpy(b),
                            "gelu", sms=sms)
    ref = jax_mm_ref(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                     jnp.asarray(b), "gelu")
    _close(ours, ref, 2.0 ** -7 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("m", [1, 4, 16, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_order_matches_jax(dtype, m):
    """The stream's summation order (``_stream_emulated``) over several K
    slices reproduces JAX's ``matmul_fused_ref`` on the same operands
    within today's tolerance: one bf16 rounding (2^-7) for bf16, 1e-4 for
    fp32."""
    k, n = STREAM_EMU
    dt = getattr(torch, dtype)
    assert split_k(dt, k, n, 132)[0] > 1
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ours = _stream_emulated(torch.from_numpy(x).to(dt),
                            torch.from_numpy(w).to(dt), torch.from_numpy(b),
                            "gelu")
    ref = jax_mm_ref(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                     jnp.asarray(b), "gelu")
    _close(ours, ref, 2.0 ** -7 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
def test_stream_launch_is_one_call_with_live_tensors(dtype, bias,
                                                     monkeypatch):
    """``_launch`` on the stream makes one call of the C entry with the
    stream's path code, the slicing of ``split_k`` and pointers to x, w,
    the bias and y that are alive when it is called (y is the tensor it
    returns), allocates nothing but y (no partial sums), and steps the
    stream's counter once."""
    dt = getattr(torch, dtype)
    x = torch.ones(5, 40, dtype=dt)
    w = torch.ones(40, 24, dtype=dt)
    b = torch.ones(24) if bias else None
    entry = _Entry([t for t in (x, w, b) if t is not None])
    made = _stand_in(monkeypatch, entry)
    y = mm_ops._launch(x, w, b, "silu")
    assert len(entry.calls) == 1 and len(made) == 1 and made[0] is y
    assert y.shape == (5, 24) and y.dtype == dt
    args, live = entry.calls[0]
    assert args[:4] == (x.data_ptr(), w.data_ptr(),
                        b.data_ptr() if bias else None, y.data_ptr())
    assert live == [True] * (4 if bias else 3)
    assert args[4:] == (5, 24, 40, mm_ops.PATH_CODES["stream"],
                        *split_k(dt, 40, 24, 132), mm_ops.ACT_CODES["silu"], 7)
    assert matmul_fused.launches == 1
    assert matmul_fused.path_launches == {
        **dict.fromkeys(mm_ops.PATH_CODES, 0), "stream": 1}
    # the stream takes no call of 64 rows or more
    with pytest.raises(ValueError, match="path"):
        mm_ops._launch(torch.ones(64, 40, dtype=dt), w, b, "none",
                       path="stream")
    assert len(entry.calls) == 1


# -- models -------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """Prefill logits at every position and the caches written, then one
    ``decode_step`` per request at per-request positions — past the local
    layers' 64-slot ring buffer for gemma2."""
    jm, jp, tm = _models(arch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, tm.cfg.vocab_size, (2, 80))
    jc = jm.init_cache(2, 96)
    jl, jc, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)},
                           mode="prefill", cache=jc)
    tc = tm.init_cache(2, 96)
    with torch.no_grad():
        tl, tc, _ = tm({"tokens": torch.from_numpy(toks)}, mode="prefill",
                       cache=tc)
    assert tl.dtype == torch.float32 and tl.shape == (2, 80, 512)
    _close(tl, jl, tol["logits"])
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        assert a.dtype == torch.bfloat16
        _close(a, b, tol["cache"])
    nxt = rng.integers(0, tm.cfg.vocab_size, (2, 1))
    pos = np.array([80, 80], np.int32)
    jl2, jc = jm.decode_step(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
    with torch.no_grad():
        tl2, tc = tm.decode_step(torch.from_numpy(nxt),
                                 torch.from_numpy(pos), tc)
    _close(tl2, jl2, tol["decode"])
    for a, b in zip(tree_leaves(tc), jax.tree_util.tree_leaves(jc)):
        _close(a, b, tol["cache"])


def test_forward_without_cache_matches_jax():
    jm, jp, tm = _models("gemma2-2b")
    toks = np.random.default_rng(4).integers(0, 512, (1, 33))
    jl, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)}, mode="prefill")
    with torch.no_grad():
        tl, aux = tm({"tokens": torch.from_numpy(toks)}, mode="prefill")
    _close(tl, jl, TOL["float32"]["logits"])


# -- serving ------------------------------------------------------------------


def _requests(vocab, n, seed=5, temperature=0.0):
    rng = np.random.default_rng(seed)
    return [Request(rid, rng.integers(0, vocab, int(rng.integers(3, 20))
                                      ).tolist(),
                    max_new_tokens=int(rng.integers(2, 9)),
                    temperature=temperature) for rid in range(n)]


def _serve(engine_cls, model, params, reqs, **kw):
    eng = engine_cls(model, params, max_batch=2, max_len=64, **kw)
    for r in reqs:
        eng.submit(dataclasses.replace(r))
    return eng.run_until_drained()


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax_greedy(arch):
    """More requests than slots, float32 params (as
    ``tests/test_train_serve.py``): the port's engine gives the JAX
    engine's token lists."""
    jm, jp, tm = _models(arch)
    reqs = _requests(tm.cfg.vocab_size, 5)
    ours = _serve(ServingEngine, tm, None, reqs, device="cpu")
    theirs = _serve(jengine.ServingEngine, jm, jp, reqs)
    assert sorted(ours) == list(range(5))
    assert ours == theirs


def test_serving_matches_manual_greedy_decode():
    _, _, tm = _models("internlm2-20b")
    prompt, n_new = [3, 1, 4, 1, 5], 6
    cache = tm.init_cache(1, 64)
    with torch.no_grad():
        logits, cache, _ = tm({"tokens": torch.tensor([prompt])},
                              mode="prefill", cache=cache)
        manual = [int(torch.argmax(logits[0, -1]))]
        for i in range(n_new - 1):
            lg, cache = tm.decode_step(torch.tensor([[manual[-1]]]),
                                       torch.tensor([len(prompt) + i]), cache)
            manual.append(int(torch.argmax(lg[0, 0])))
    done = _serve(ServingEngine, tm, None,
                  [Request(0, prompt, max_new_tokens=n_new)], device="cpu")
    assert done[0] == manual


def test_oversized_prompt_rejected():
    """The JAX engine's admission rule: a prompt needs one free KV row
    past it (``tests/test_serving_sampling.py``)."""
    _, _, tm = _models("gemma2-2b")
    eng = ServingEngine(tm, max_batch=2, max_len=8, device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(Request(0, list(range(8)), max_new_tokens=1))
    with pytest.raises(ValueError, match="max_len"):
        eng._prefill_into_slot(0, Request(1, list(range(9)),
                                          max_new_tokens=1))
    eng.submit(Request(2, list(range(7)), max_new_tokens=1))
    done = eng.run_until_drained()
    assert 2 in done and len(done[2]) >= 1


def test_prefill_writes_only_its_slot():
    """The slot's batch row of every cache leaf is indexed explicitly:
    prefilling slot 1 leaves slot 0's rows as they were."""
    _, _, tm = _models("gemma2-2b")
    eng = ServingEngine(tm, max_batch=3, max_len=32, device="cpu")
    eng._prefill_into_slot(0, Request(0, [1, 2, 3], max_new_tokens=2))
    before = [t.narrow(CACHE_BATCH_AXIS, 0, 1).clone()
              for t in tree_leaves(eng.cache)]
    eng._prefill_into_slot(1, Request(1, [4, 5, 6, 7], max_new_tokens=2))
    after = tree_leaves(eng.cache)
    for b, a in zip(before, after):
        assert torch.equal(b, a.narrow(CACHE_BATCH_AXIS, 0, 1))
        assert a.narrow(CACHE_BATCH_AXIS, 1, 1).abs().sum() > 0
        assert torch.all(a.narrow(CACHE_BATCH_AXIS, 2, 1) == 0)


def test_temperature_zero_is_deterministic():
    """Greedy requests do not depend on the engine's seed."""
    _, _, tm = _models("gemma2-2b")
    reqs = [Request(0, [3, 1, 4], max_new_tokens=5)]
    assert (_serve(ServingEngine, tm, None, reqs, seed=0, device="cpu")
            == _serve(ServingEngine, tm, None, reqs, seed=123, device="cpu"))


def test_sampling_is_repeatable_for_a_seed(monkeypatch):
    """Sampled requests repeat for a seed, use their own temperatures and
    draw once per generated token.  (They cannot equal the JAX engine's
    tokens: ``jax.random`` and ``torch.Generator`` give different numbers
    for the same seed.)"""
    _, _, tm = _models("gemma2-2b")
    reqs = [Request(0, [3, 1, 4], max_new_tokens=4, temperature=0.7),
            Request(1, [2, 7, 1], max_new_tokens=4, temperature=1.3)]
    a = _serve(ServingEngine, tm, None, reqs, seed=0, device="cpu")
    b = _serve(ServingEngine, tm, None, reqs, seed=0, device="cpu")
    assert a == b and sorted(a) == [0, 1]
    calls = []
    real = tengine.sample

    def spy(logits, generator, temperature=0.0, top_k=0):
        calls.append(temperature)
        return real(logits, generator, temperature=temperature, top_k=top_k)

    monkeypatch.setattr(tengine, "sample", spy)
    assert _serve(ServingEngine, tm, None, reqs, seed=0, device="cpu") == a
    assert sorted(set(calls)) == [0.7, 1.3] and len(calls) == 8
    many = {tuple(_serve(ServingEngine, tm, None, reqs[:1], seed=s,
                         device="cpu")[0]) for s in range(6)}
    assert len(many) > 1  # the seed matters at temperature > 0


def test_greedy_request_never_samples(monkeypatch):
    _, _, tm = _models("gemma2-2b")

    def boom(*a, **kw):  # pragma: no cover - failure path
        raise AssertionError("greedy request must not hit the sampler")

    monkeypatch.setattr(tengine, "sample", boom)
    done = _serve(ServingEngine, tm, None,
                  [Request(0, [1, 2, 3], max_new_tokens=4)], device="cpu")
    assert len(done[0]) == 4


def test_sample_top_k_keeps_the_top():
    logits = torch.tensor([[0.0, 5.0, 4.0, -1.0, 4.5]])
    g = torch.Generator().manual_seed(0)
    draws = {int(sample(logits, g, temperature=2.0, top_k=2)[0])
             for _ in range(200)}
    assert draws == {1, 4}
    assert int(sample(logits, g)[0]) == 1


def test_engine_runs_on_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm = _models("gemma2-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm, max_batch=1, max_len=8)

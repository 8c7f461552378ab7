"""The port's sharding specs against the JAX package's, on the CPU.

For every registered arch, on the JAX package's two pods, its tiny mesh
and the 1 x 4 and 2 x 2 meshes of a node of cards, at the four input
shapes: ``rules_for``'s rules and notes, the spec of every parameter,
cache and AdamW-moment leaf (``logical_to_spec``; a JAX
``PartitionSpec`` compared as ``tuple(P)``), ``input_specs``'
shapes, dtypes and axes, ``kv_cache_spec`` on a grid, and
``apply_variants`` on the chains the JAX package's tests use.  The JAX
package's properties hold on the port's specs too: no mesh axis twice in
a spec, and every sharded dimension divides.

One layout differs by design: the VLM's self-attention cache is stacked
once in the port, ``[n_groups * n_self, ...]``, where JAX stacks it
twice, ``[n_groups, n_self, ...]`` (``models/vision_lm.py``); JAX's leaf
is compared with its two leading "layers" axes merged, both unsharded.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.core import config as jconfig
from repro.launch import inputs as jinputs
from repro.launch import variants as jvariants
from repro.models import registry as jregistry
from repro.sharding import auto as jauto
from repro.sharding import rules as jrules
from repro.train import optimizer as joptimizer
from repro_torch.core import config as tconfig
from repro_torch.launch import inputs as tinputs
from repro_torch.launch import variants as tvariants
from repro_torch.models import registry as tregistry
from repro_torch.sharding import auto as tauto
from repro_torch.sharding import rules as trules
from repro_torch.train import optimizer as toptimizer

ARCHS = tconfig.list_archs()
MESHES = {"single_pod": (16, 16), "multi_pod": (2, 16, 16), "tiny": (1, 1),
          "1x4": (1, 4), "2x2": (2, 2)}
SHAPES = tuple(tconfig.SHAPES)


def _meshes(name):
    shape = MESHES[name]
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return jconfig.MeshConfig(shape, axes), tconfig.MeshConfig(shape, axes)


def _leaves(tree, path=""):
    """(path, Param) of a spec tree of either package, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    return [(path, tree)]


def _merge_layers(p):
    """A JAX Param stacked twice on "layers", stacked once."""
    if p.axes[:2] != ("layers", "layers"):
        return p
    return p._replace(shape=(p.shape[0] * p.shape[1],) + p.shape[2:],
                      axes=p.axes[1:])


def test_configs_equal():
    assert tconfig.SHAPES == {k: tconfig.ShapeConfig(*dataclasses.astuple(v))
                              for k, v in jconfig.SHAPES.items()}
    for m in ("SINGLE_POD", "MULTI_POD", "TINY_MESH"):
        j, t = getattr(jconfig, m), getattr(tconfig, m)
        assert (t.shape, t.axes) == (j.shape, j.axes)
        assert (t.dp_size, t.model_size, t.num_devices, t.dp_axes,
                t.multi_pod) == (j.dp_size, j.model_size, j.num_devices,
                                 j.dp_axes, j.multi_pod)
    assert tconfig.get_shape("long_500k").global_batch == 1
    with pytest.raises(KeyError):
        tconfig.get_shape("nope")


@pytest.mark.parametrize("shape_name", SHAPES)
@pytest.mark.parametrize("mesh_name", tuple(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch, mesh_name, shape_name):
    jmesh, tmesh = _meshes(mesh_name)
    jcfg, tcfg = jconfig.get_arch(arch), tconfig.get_arch(arch)
    jshape, tshape = jconfig.get_shape(shape_name), tconfig.get_shape(
        shape_name)
    jr, jnotes = jauto.rules_for(jcfg, jmesh, jshape)
    tr, tnotes = tauto.rules_for(tcfg, tmesh, tshape)
    assert tr.table == jr.table
    assert tnotes == jnotes
    jm, tm = jregistry.get_model(jcfg), tregistry.get_model(tcfg)
    window = tm.effective_window(tshape)
    assert window == jm.effective_window(jshape)
    fsdp = dict(tr.table).get("embed") is not None
    trees = [(jm.param_spec(), tm.param_spec()),
             (jm.cache_spec(jshape.global_batch, jshape.seq_len, window),
              tm.cache_spec(tshape.global_batch, tshape.seq_len, window))]
    if shape_name == "train_4k":
        trees.append(tuple(
            opt.adamw_init_spec(spec, zero1=True, dp_size=tmesh.dp_size,
                                fsdp=fsdp)
            for opt, spec in ((joptimizer, trees[0][0]),
                              (toptimizer, trees[0][1]))))
    sizes = dict(zip(tmesh.axes, tmesh.shape))
    for jtree, ttree in trees:
        jl, tl = _leaves(jtree), _leaves(ttree)
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, jp), (_, tp) in zip(jl, tl):
            if jtree is trees[1][0]:
                jp = _merge_layers(jp)
            assert (tp.shape, tp.axes, tp.dtype) == (jp.shape, jp.axes,
                                                     jp.dtype), path
            spec = trules.logical_to_spec(tp.axes, tmesh.axes, tr)
            assert spec == tuple(jrules.logical_to_spec(jp.axes, jmesh.axes,
                                                        jr)), path
            _no_dup(spec, sizes)
            for dim, entry in zip(tp.shape, spec):
                n = int(np.prod([sizes[a] for a in trules.entry_axes(entry)]))
                assert dim % n == 0, (path, tp.shape, spec)
    jspecs, jaxes = jinputs.input_specs(jcfg, jshape)
    tspecs, taxes = tinputs.input_specs(tcfg, tshape)
    assert taxes == jaxes
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in tspecs.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.items()}
    assert all(v.device.type == "meta" for v in tspecs.values())
    if shape_name != "train_4k":
        jc, jca = jinputs.cache_specs(jm, jshape.global_batch,
                                      jshape.seq_len, window)
        tc, tca = tinputs.cache_specs(tm, tshape.global_batch,
                                      tshape.seq_len, window)
        jl, tl = _leaves(jca), _leaves(tca)
        if jm.cfg.family != "vlm":  # the VLM's self cache: stacked once
            assert tl == jl
            assert [(tuple(t.shape), str(t.dtype).split(".")[-1])
                    for _, t in _leaves(tc)] == [
                (tuple(j.shape), str(j.dtype)) for _, j in _leaves(jc)]
    assert trules.batch_spec(tmesh.axes, tr) == tuple(
        jrules.batch_spec(jmesh.axes, jr))


def _no_dup(spec, sizes):
    """No mesh axis of more than one device twice in ``spec`` (FSDP's
    "embed" over a data axis of size 1 may meet itself, in both packages,
    and cuts nothing)."""
    seen = []
    for entry in spec:
        for a in trules.entry_axes(entry):
            if sizes[a] > 1:
                assert a not in seen, spec
                seen.append(a)


@pytest.mark.parametrize("mesh_name", ("single_pod", "multi_pod", "1x4",
                                       "2x2"))
def test_kv_cache_spec_equal_jax_on_a_grid(mesh_name):
    jmesh, tmesh = _meshes(mesh_name)
    for batch in (1, 2, 3, 4, 16, 128):
        for kvh in (1, 2, 4, 8, 40):
            for dp, model in ((1, 1), (1, 4), (2, 2), (16, 16), (32, 16)):
                for rules in (trules.DEFAULT_RULES,
                              trules.DEFAULT_RULES.replace(heads=None),
                              trules.DEFAULT_RULES.replace(batch=None)):
                    jr = jrules.AxisRules(rules.table)
                    ours = trules.kv_cache_spec(batch, kvh, dp, model,
                                                tmesh.axes, rules)
                    try:
                        want = tuple(jrules.kv_cache_spec(
                            batch, kvh, dp, model, jmesh.axes, jr))
                    except ValueError as e:
                        # JAX's PartitionSpec refuses the nested tuple
                        # its rule builds: the port flattens it
                        assert "nested tuple" in str(e)
                        assert ours == (None, ("pod", "data", "model"),
                                        None, None)
                        continue
                    assert ours == want


#: the chains the JAX package's tests and its dry run name
CHAINS = [(n,) for n in jvariants.VARIANTS] + [
    ("head_pad", "int8kv", "mb4"), ("head_pad", "seq_sp"),
    ("int8kv", "chunk4k", "mb16"), ("head_pad", "int8kv", "chunk2k", "mb2")]


@pytest.mark.parametrize("arch", ("qwen1.5-32b", "internlm2-20b",
                                  "gemma2-2b", "grok-1-314b"))
@pytest.mark.parametrize("chain", CHAINS, ids=["+".join(c) for c in CHAINS])
def test_apply_variants_equal_jax(arch, chain):
    for model_size in (16, 4):
        jmesh = jconfig.MeshConfig((16 * 16 // model_size, model_size))
        tmesh = tconfig.MeshConfig((16 * 16 // model_size, model_size))
        jcfg, tcfg = jconfig.get_arch(arch), tconfig.get_arch(arch)
        jr, _ = jauto.rules_for(jcfg, jmesh, None)
        tr, _ = tauto.rules_for(tcfg, tmesh, None)
        j = jvariants.apply_variants(chain, jcfg, jr, model_size)
        t = tvariants.apply_variants(chain, tcfg, tr, model_size)
        assert dataclasses.asdict(t[0]) == dataclasses.asdict(j[0])
        assert t[1].table == j[1].table
        assert t[2:] == j[2:]
    assert set(tvariants.VARIANTS) == set(jvariants.VARIANTS)


def test_local_shape_and_slice():
    """A shard's shape and slice: the dims divided by their entries'
    shard counts, each rank's slice at its row-major index, every slice
    together the whole tensor once."""
    import torch

    mesh = tconfig.MeshConfig((2, 2, 3), ("pod", "data", "model"))
    spec = (("pod", "data"), None, "model")
    t = torch.arange(8 * 5 * 6).reshape(8, 5, 6)
    assert trules.local_shape(t.shape, spec, mesh) == (2, 5, 2)
    seen = torch.zeros_like(t)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                s = trules.local_slice(t, spec, mesh,
                                       {"pod": p, "data": d, "model": m})
                i = 2 * p + d
                assert torch.equal(s, t[2 * i:2 * i + 2, :, 2 * m:2 * m + 2])
                seen[2 * i:2 * i + 2, :, 2 * m:2 * m + 2] += 1
    assert bool((seen == 1).all())
    with pytest.raises(ValueError, match="does not divide"):
        trules.local_shape((7, 5, 6), spec, mesh)


@given(heads=st.integers(1, 64), kv=st.integers(1, 64),
       ff=st.integers(1, 64))
@settings(max_examples=30, deadline=None)
def test_rules_drop_non_divisible(heads, kv, ff):
    """The JAX package's property, on the port's ``rules_for``, and its
    rules and notes equal to JAX's."""
    changes = dict(num_heads=heads, num_kv_heads=kv, d_ff=ff * 128,
                   head_dim=128)
    tcfg = dataclasses.replace(tconfig.get_arch("internlm2-20b"), **changes)
    jcfg = dataclasses.replace(jconfig.get_arch("internlm2-20b"), **changes)
    rules, notes = tauto.rules_for(tcfg, tconfig.SINGLE_POD, None)
    t = dict(rules.table)
    assert (t["heads"] is None) == (heads % 16 != 0)
    assert (t["kv_heads"] is None) == (kv % 16 != 0)
    assert (t["ff"] is None) == ((ff * 128) % 16 != 0)
    jr, jnotes = jauto.rules_for(jcfg, jconfig.SINGLE_POD, None)
    assert (rules.table, notes) == (jr.table, jnotes)


@given(arch=st.sampled_from(ARCHS),
       dp=st.sampled_from((1, 2, 4, 8, 16)),
       model=st.sampled_from((1, 2, 4, 8, 16)),
       shape_name=st.sampled_from(SHAPES))
@settings(max_examples=40, deadline=None)
def test_port_specs_valid_on_any_node_mesh(arch, dp, model, shape_name):
    """Every sharded dimension divides on any data x model mesh, and no
    mesh axis of more than one device appears twice in a spec — the JAX
    package's properties, which its rules break in one place beyond its
    pods: FSDP's "embed" over a data axis of more than one device meets
    itself in a [d, d] leaf whose axes are both "embed" (rwkv6's
    ``chan/wr``).  ``local_shape`` refuses exactly those."""
    mesh = tconfig.MeshConfig((dp, model), ("data", "model"))
    cfg, shape = tconfig.get_arch(arch), tconfig.get_shape(shape_name)
    rules, _ = tauto.rules_for(cfg, mesh, shape)
    fsdp = dict(rules.table)["embed"] is not None
    m = tregistry.get_model(cfg)
    window = m.effective_window(shape)
    for tree in (m.param_spec(), m.cache_spec(shape.global_batch,
                                              shape.seq_len, window)):
        for path, p in _leaves(tree):
            spec = trules.logical_to_spec(p.axes, mesh.axes, rules)
            if fsdp and dp > 1 and p.axes.count("embed") == 2:
                with pytest.raises(ValueError, match="twice"):
                    trules.local_shape(p.shape, spec, mesh)
                continue
            _no_dup(spec, dict(zip(mesh.axes, mesh.shape)))
            trules.local_shape(p.shape, spec, mesh)  # raises if it does not

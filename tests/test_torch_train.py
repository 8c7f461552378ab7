"""The port's trainer (``repro_torch.train``, ``launch.train``) against the
JAX package's (``repro.train``), on the CPU: the optimizer's pieces on the
same trees, one ``make_train_step`` step of every registered arch in fp32
from the JAX init's weights (``params_from_jax``; a VLM's tree through
``vision_redraw``, the cross families with seeded media or frames),
microbatching, the corpus, and checkpoints crossing between the packages
both ways.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro.train import checkpoint as jckpt
from repro.train import data as jdata
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch.core import config as tconfig
from repro_torch.launch import train as tlaunch
from repro_torch.models import registry as tregistry
from repro_torch.models.common import params_from_jax
from repro_torch.models.vision_lm import vision_redraw
from repro_torch.nn.param import Param, init_tree, tree_leaves, tree_map
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import data as tdata
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

ARCHS = ["gemma2-2b", "qwen3-moe-30b-a3b", "rwkv6-1.6b", "zamba2-1.2b",
         "starcoder2-15b", "internlm2-20b", "qwen1.5-32b", "grok-1-314b",
         "llama-3.2-vision-11b", "seamless-m4t-large-v2"]
#: the batch key a cross family's forward reads its media (frames) from
MEDIA_KEY = {"vlm": "media_embeds", "audio": "frames"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, tol):
    """max |ours - ref| <= tol * max(1, max |ref|)."""
    a, b = _np(ours), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict)
                else rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}


SHAPES = {"a": {"w": (3, 4), "b": (4,)}, "c": (2, 3, 5), "s": (1,)}


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's torch ops on one intra-op thread: the shapes are small,
    and thousands of small parallel regions a train step slow to a crawl
    when several test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the optimizer's pieces ---------------------------------------------------


def test_lr_schedule_matches_jax():
    """Within 2 fp32 ulps: torch's and XLA's fp32 cos differ in the last
    bit."""
    for tc in ((1e-3, 10, 100), (3e-4, 0, 50), (2e-3, 7, 7)):
        jt = jconfig.TrainConfig(*tc)
        tt = tconfig.TrainConfig(*tc)
        for s in (0, 1, 5, 7, 10, 40, 99, 100, 150):
            ours = topt.lr_schedule(torch.tensor(s, dtype=torch.int32), tt)
            ref = jopt.lr_schedule(jnp.asarray(s, jnp.int32), jt)
            assert ours.dtype == torch.float32
            assert abs(float(ours) - float(ref)) <= 2.0 ** -22 * abs(
                float(ref)), s


def test_global_norm_matches_jax():
    tree = _tree(np.random.default_rng(0), SHAPES)
    ours = topt.global_norm(tree_map(torch.from_numpy, tree))
    ref = jopt.global_norm(jax.tree_util.tree_map(jnp.asarray, tree))
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)


@pytest.mark.parametrize("scale", [1e-3, 10.0])  # unclipped, clipped
def test_adamw_update_matches_jax(scale):
    """Two updates from the same tree: new parameters, moments and step
    (in place for the port), grad norm and lr; the weight decay on the
    leaves of two dims and more only."""
    rng = np.random.default_rng(1)
    p, g1, g2 = (_tree(rng, SHAPES) for _ in range(3))
    tc = dict(learning_rate=1e-2, warmup_steps=1, total_steps=10,
              weight_decay=0.5)
    jt, tt = jconfig.TrainConfig(**tc), tconfig.TrainConfig(**tc)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    js = jopt.adamw_init(jp)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), p)
    ts = topt.adamw_init(tp)
    for g in (g1, g2):
        g = jax.tree_util.tree_map(lambda a: a * scale, g)
        jp, js, jm = jopt.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), js, jp, jt)
        out_p, out_s, tm = topt.adamw_update(
            tree_map(torch.from_numpy, g), ts, tp, tt)
        assert out_p is tp and out_s is ts
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
            _close(a, b, 1e-6)
        for part in ("m", "v"):
            for a, b in zip(tree_leaves(ts[part]),
                            jax.tree_util.tree_leaves(js[part])):
                _close(a, b, 1e-6)
        assert int(ts["step"]) == int(js["step"])
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0


def test_adamw_init_spec_matches_jax():
    from repro.nn.param import Param as JParam
    spec = {"w": Param((8, 6), ("embed", None)), "b": Param((6,), (None,))}
    jspec = {"w": JParam((8, 6), ("embed", None)), "b": JParam((6,), (None,))}
    for kw in (dict(), dict(dp_size=2), dict(dp_size=2, fsdp=True),
               dict(zero1=False, dp_size=2, moment_dtype="bfloat16")):
        ours = topt.adamw_init_spec(spec, **kw)
        ref = jopt.adamw_init_spec(jspec, **kw)
        for part in ("m", "v"):
            for k in spec:
                assert tuple(ours[part][k]) == tuple(ref[part][k]), (kw, k)
        assert tuple(ours["step"]) == tuple(ref["step"])


def test_cross_entropy_matches_jax():
    """A padded vocab (the tail at NEG_INF, as ``lm_logits`` masks it):
    the gather equals JAX's masked sum."""
    rng = np.random.default_rng(2)
    logits = (rng.standard_normal((2, 5, 24)) * 4).astype(np.float32)
    logits[..., 20:] = -1e30
    labels = rng.integers(0, 20, (2, 5))
    ours = tstep.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), 20)
    ref = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 20)
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)


# -- one train step against JAX's ---------------------------------------------


def _cfgs(arch):
    kw = dict(dtype="float32", param_dtype="float32")
    return (dataclasses.replace(jconfig.get_arch(arch).reduced(), **kw),
            dataclasses.replace(tconfig.get_arch(arch).reduced(), **kw))


def _step_both(arch, microbatches=1, b=2, s=24):
    """One train step of each package from the JAX init's weights on the
    same batch -> (JAX's new params, opt state, metrics; the port's; the
    JAX lr).  A VLM's tree goes through ``vision_redraw`` before both
    packages get it (at the init its gates are 0 and its self matrices at
    std 1/sqrt(n_groups) swamp the gated residual); the cross families
    get seeded media (frames)."""
    jcfg, tcfg = _cfgs(arch)
    jm = jregistry.get_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                           device="cpu")
    if tcfg.family == "vlm":
        vision_redraw(tree, torch.Generator().manual_seed(1))
        jp = jax.tree_util.tree_map(lambda t: jnp.array(t.numpy()), tree)
    tm = tregistry.get_model(tcfg).load_tree(tree)
    tc = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tcfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if tcfg.family in MEDIA_KEY:
        xa = tcfg.cross_attn
        batch[MEDIA_KEY[tcfg.family]] = rng.standard_normal(
            (b, xa.num_media_tokens, xa.media_dim)).astype(np.float32)
    jfn = jax.jit(jstep.make_train_step(jm, jconfig.TrainConfig(**tc),
                                        microbatches=microbatches))
    j_out = jfn(jp, jopt.adamw_init(jp),
                {k: jnp.asarray(v) for k, v in batch.items()})
    tfn = tstep.make_train_step(tm, tconfig.TrainConfig(**tc),
                                microbatches=microbatches)
    t_out = tfn(tree, topt.adamw_init(tree),
                {k: torch.from_numpy(v) for k, v in batch.items()})
    return j_out, t_out, tree


def _check_step(j_out, t_out, tree):
    (jp, js, jm), (tp, ts, tm) = j_out, t_out
    assert tp is tree
    assert set(jm) <= set(tm)
    for k in tm:
        ref = jm.get(k, 0.0)
        assert abs(float(tm[k]) - float(ref)) <= 1e-5 * max(
            1.0, abs(float(ref))), (k, float(tm[k]), float(ref))
    lr = float(jm["lr"])
    for part in ("m", "v"):
        for a, b in zip(tree_leaves(ts[part]),
                        jax.tree_util.tree_leaves(js[part])):
            _close(a, b, 1e-4)
    # an element whose gradient is tiny against its leaf's may flip the
    # sign of its Adam step (u = g / (|g| + eps)): 2 lr apart at most
    for a, b, m in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp),
                       jax.tree_util.tree_leaves(js["m"])):
        a, b, m = _np(a), _np(b), np.abs(_np(m))
        tiny = m <= 1e-3 * max(float(m.max()), 1e-30)
        err = np.abs(a - b)
        assert (err[~tiny] <= 1e-6 * np.maximum(1.0, np.abs(b[~tiny]))
                + 1e-3 * lr).all()
        assert (err[tiny] <= 2.02 * lr + 1e-6).all()
    assert int(ts["step"]) == int(js["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    """Reduced fp32 gemma2 (local/global pairs, softcaps, the tied
    embedding), qwen3-moe and grok (the aux losses, the experts, the
    fixed-order dispatch backward), rwkv6 (K11's backward), zamba2 (the
    Mamba2 block, the shared block's gradients from each call site),
    starcoder2 (LayerNorm, biases on q/k/v and the plain gelu MLP, the
    window), internlm2, qwen1.5 (q/k/v biases), llama-3.2-vision (the
    gated cross layers over the media) and seamless (the encoder over the
    frames, the cross layers): loss, CE, aux losses, grad norm, lr, every
    moment and every new parameter."""
    _check_step(*_step_both(arch))


def test_train_step_microbatches_match_jax():
    """``microbatches=2``: JAX's strided split, fp32 accumulation, the
    gradients and metrics divided by 2."""
    _check_step(*_step_both("gemma2-2b", microbatches=2, b=4, s=16))


def test_train_step_microbatches_match_jax_moe():
    """``microbatches=2`` for qwen3-moe: each microbatch routes its own
    tokens, and the aux losses of the two routings are summed and divided
    by 2 with the CE, as JAX's scan divides its metrics."""
    _check_step(*_step_both("qwen3-moe-30b-a3b", microbatches=2, b=4,
                            s=16))


def test_train_step_grads_land_in_the_stacked_tree():
    """After a step every model parameter is trainable, still a view of
    the tree, and its ``.grad`` the view of the gradient tree at the same
    place; the gradient tree has the tree's stacked shapes: autograd
    accumulated in place."""
    _, tcfg = _cfgs("gemma2-2b")
    tm = tregistry.get_model(tcfg)
    params = init_tree(tm.param_spec(), torch.Generator().manual_seed(0),
                       "float32")
    tm.load_tree(params)
    grads = tstep.bind_grads(tm, params, {})
    toks = torch.randint(0, tcfg.vocab_size, (2, 9))
    loss, _ = tstep.make_loss_fn(tm)({"tokens": toks[:, :-1],
                                      "labels": toks[:, 1:]})
    loss.backward()
    pairs = list(zip(tree_leaves(params), tree_leaves(grads)))
    n = 0
    for p in tm.parameters():
        assert p.requires_grad
        t, g = next((t, g) for t, g in pairs
                    if 0 <= p.data_ptr() - t.data_ptr() < t.numel() * 4)
        off = p.data_ptr() - t.data_ptr()
        assert p.grad.data_ptr() - g.data_ptr() == off
        assert torch.equal(p.grad, g.view(-1)[off // 4:][:p.numel()].view(
            p.shape))
        n += 1
    assert n == len(list(tm.parameters())) > 20
    assert [tuple(g.shape) for g in tree_leaves(grads)] == [
        tuple(t.shape) for t in tree_leaves(params)]
    assert all(g.abs().sum() > 0 for g in tree_leaves(grads["layers"]))


def test_train_step_reloads_a_tree_the_model_does_not_hold():
    _, tcfg = _cfgs("rwkv6-1.6b")
    tm = tregistry.get_model(tcfg).init(torch.Generator().manual_seed(0))
    params = init_tree(tm.param_spec(), torch.Generator().manual_seed(1),
                       "float32")
    tstep.bind_grads(tm, params, {})
    assert tm.embed["tok"].data_ptr() == params["embed"]["tok"].data_ptr()


def test_training_reduces_loss():
    """The port's copy of ``tests/test_train_serve.py``'s test: reduced
    internlm2 at vocab 128, 40 AdamW steps on the Markov corpus."""
    cfg = dataclasses.replace(
        tconfig.get_arch("internlm2-20b").reduced(), vocab_size=128)
    model = tregistry.get_model(cfg)
    params = init_tree(model.param_spec(), torch.Generator().manual_seed(0),
                       cfg.param_dtype)
    model.load_tree(params)
    opt = topt.adamw_init(params)
    tc = tconfig.TrainConfig(learning_rate=3e-3, warmup_steps=5,
                             total_steps=40)
    step = tstep.make_train_step(model, tc)
    lm = tdata.MarkovLM(cfg.vocab_size, seed=0)
    it = tdata.batches(lm, 8, 64, seed=1)
    first = last = None
    for i in range(40):
        tokens, labels = next(it)
        batch = {"tokens": torch.from_numpy(tokens).long(),
                 "labels": torch.from_numpy(labels).long()}
        params, opt, metrics = step(params, opt, batch)
        if i == 0:
            first = float(metrics["ce"])
        last = float(metrics["ce"])
    assert last < first - 0.1, (first, last)
    assert last > lm.entropy() - 0.05  # cannot beat the entropy floor


# -- the corpus -----------------------------------------------------------------


def test_markov_corpus_matches_jax():
    ours, ref = tdata.MarkovLM(64, seed=3), jdata.MarkovLM(64, seed=3)
    assert np.array_equal(ours.P, ref.P)
    assert ours.entropy() == ref.entropy()
    it_t, it_j = tdata.batches(ours, 3, 17, seed=5), \
        jdata.batches(ref, 3, 17, seed=5)
    for _ in range(3):
        (a, b), (c, d) = next(it_t), next(it_j)
        assert np.array_equal(a, c) and np.array_equal(b, d)


# -- checkpoints ------------------------------------------------------------------


def _bf16_trees():
    """The JAX init of reduced bf16 gemma2 and its AdamW state after one
    update, in both packages."""
    cfg = jconfig.get_arch("gemma2-2b").reduced()
    jp = jregistry.get_model(cfg).init(jax.random.PRNGKey(1))
    js = jopt.adamw_init(jp)
    js["step"] = jnp.asarray(3, jnp.int32)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         tconfig.get_arch("gemma2-2b").reduced(),
                         device="cpu")
    ts = topt.adamw_init(tp)
    ts["step"].fill_(3)
    return jp, js, tp, ts


def _same(t, j):
    tl, jl = tree_leaves(t), jax.tree_util.tree_leaves(j)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        assert str(b.dtype) == {torch.bfloat16: "bfloat16",
                                torch.float32: "float32",
                                torch.int32: "int32"}[a.dtype]
        assert np.array_equal(_np(a), b.astype(np.float32))


def test_checkpoint_port_to_jax(tmp_path):
    jp, js, tp, ts = _bf16_trees()
    tckpt.save_checkpoint(tmp_path / "ck", tp, ts, 7, {"arch": "g"})
    p2, o2, step, extra = jckpt.load_checkpoint(tmp_path / "ck")
    assert step == 7 and extra == {"arch": "g"}
    _same(tp, p2)
    _same(ts, o2)
    assert not (tmp_path / "ck.tmp").exists()


def test_checkpoint_jax_to_port(tmp_path):
    jp, js, tp, ts = _bf16_trees()
    jckpt.save_checkpoint(tmp_path / "ck", jp, js, 9, {"arch": "g"})
    p2, o2, step, extra = tckpt.load_checkpoint(tmp_path / "ck",
                                                device="cpu")
    assert step == 9 and extra == {"arch": "g"}
    _same(p2, jp)
    _same(o2, js)
    # the port's own round trip, written over the first
    tckpt.save_checkpoint(tmp_path / "ck", p2, o2, 10)
    p3, o3, step, _ = tckpt.load_checkpoint(tmp_path / "ck", device="cpu")
    assert step == 10
    for a, b in zip(tree_leaves(p3), tree_leaves(p2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the launcher -----------------------------------------------------------------


def test_launcher_trains_on_the_cpu(tmp_path):
    out = tlaunch.main(["--arch", "rwkv6-1.6b", "--reduced", "--steps", "3",
                        "--batch", "2", "--seq", "16", "--log-every", "1",
                        "--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    assert [s for s, _ in out["history"]] == [1, 2, 3]
    assert all(np.isfinite(ce) for _, ce in out["history"])
    _, opt, step, extra = tckpt.load_checkpoint(tmp_path / "ck",
                                                device="cpu")
    assert step == 3 and int(opt["step"]) == 3
    assert extra == {"arch": "rwkv6-1.6b", "reduced": True}


def test_train_entry_points_need_a_gpu_unless_asked(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--arch", "gemma2-2b", "--reduced", "--steps", "1"])
    jp, js, _, _ = _bf16_trees()
    jckpt.save_checkpoint(tmp_path / "ck", jp, js, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tckpt.load_checkpoint(tmp_path / "ck")
    tckpt.load_checkpoint(tmp_path / "ck", device="cpu")

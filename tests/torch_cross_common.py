"""Helpers shared by the tests of the port's cross-attention families
(``tests/test_torch_cross_attention.py``, ``test_torch_vision_lm.py``,
``test_torch_encdec.py``): the configs, the models of both packages on the
same weights, the conversions and the comparison rule."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import config as jconfig
from repro.models import registry as jregistry
from repro_torch.core import config as tconfig
from repro_torch.models import registry as tregistry
from repro_torch.models.common import params_from_jax
from repro_torch.models.vision_lm import vision_redraw
from repro_torch.nn.param import tree_map

VLM = "llama-3.2-vision-11b"
AUDIO = "seamless-m4t-large-v2"
#: the batch key each family's forward reads its media from
MEDIA_KEY = {VLM: "media_embeds", AUDIO: "frames"}

#: relative to max(1, max|ref|), as tests/test_torch_zamba2.py.  float32:
#: the same fp32 arithmetic in another order — 1e-4 on the prefill
#: logits; the caches are bf16 (the self cache by the JAX default, the
#: cross cache by its explicit rounding), where a k or v that differs in
#: its last fp32 bits may round to the neighbouring bf16 value (2^-7 of
#: that element), and the decode logits read them: 2e-3.  bfloat16: the
#: activations are rounded to bf16 some ten times a block, at places the
#: two packages choose differently (the bias and activation before the
#: cast in ``dense``, p in the attention) — 2^-4 on the logits and
#: every cache leaf.
TOL = {"float32": {"logits": 1e-4, "kv": 2.0 ** -7, "decode": 2e-3},
       "bfloat16": {"logits": 2.0 ** -4, "kv": 2.0 ** -4,
                    "decode": 2.0 ** -4}}


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def close(ours, ref, tol):
    """max |ours - ref| <= tol * max(1, max |ref|), every element finite;
    returns the error."""
    a, b = f32(ours), f32(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(a).all()
    err, top = float(np.abs(a - b).max()), float(np.abs(b).max())
    assert err <= tol * max(1.0, top), (err, top)
    return err


def to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


def spec_rows(spec, path=""):
    """(path, shape, axes, init, scale, dtype) of every Param of a spec
    tree, keys in sorted order."""
    if isinstance(spec, dict):
        return [r for k in sorted(spec)
                for r in spec_rows(spec[k], f"{path}/{k}")]
    return [(path, tuple(spec.shape), tuple(spec.axes), spec.init,
             spec.scale, spec.dtype)]


def cfgs(arch, dtype="float32", **changes):
    """The reduced config of ``arch`` in both packages, in ``dtype``."""
    kw = dict(changes, dtype=dtype, param_dtype=dtype)
    return (dataclasses.replace(jconfig.get_arch(arch).reduced(), **kw),
            dataclasses.replace(tconfig.get_arch(arch).reduced(), **kw))


_MODELS = {}


def models(arch, dtype="float32", redraw=True):
    """(JAX model, JAX params, port model, jitted JAX forward with a
    cache, jitted JAX decode step) on the same weights: the JAX init
    carried over by ``params_from_jax``, ``vision_redraw`` applied to a
    VLM's tree (``redraw``), the result handed back to the JAX side."""
    key = (arch, dtype, redraw)
    if key not in _MODELS:
        jcfg, tcfg = cfgs(arch, dtype)
        jm = jregistry.get_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tree = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tcfg,
                               device="cpu")
        if redraw and tcfg.family == "vlm":
            vision_redraw(tree, torch.Generator().manual_seed(1))
        tm = tregistry.get_model(tcfg).load_tree(tree)
        mk = MEDIA_KEY[arch]
        fwd = jax.jit(lambda p, t, m, c: jm.forward(
            p, {"tokens": t, mk: m}, mode="prefill", cache=c))
        dec = jax.jit(lambda p, t, pos, c: jm.decode_step(p, t, pos, c))
        _MODELS[key] = (jm, tree_map(to_jax, tree), tm, fwd, dec)
    return _MODELS[key]


def media(cfg, b, seed):
    """Seeded fp32 media (frames) [b, num_media_tokens, media_dim]."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.cross_attn.num_media_tokens,
                                cfg.cross_attn.media_dim)).astype(np.float32)


def both(arr, dtype):
    """A numpy array as a torch tensor and a JAX array of ``dtype``."""
    return (torch.from_numpy(arr).to(getattr(torch, dtype)),
            jnp.asarray(arr, getattr(jnp, dtype)))


def prefill_and_decode(arch, dtype, check_cache, steps=3, s=9, b=2):
    """A prompt of ``s`` tokens and its media prefilled into a cache by
    both packages, then ``steps`` decode steps; the logits held to
    ``TOL``, the caches by ``check_cache(port cache, JAX cache, tol)``
    after the prefill and after every step."""
    jm, jp, tm, fwd, dec = models(arch, dtype)
    tol = TOL[dtype]
    rng = np.random.default_rng(20)
    toks = rng.integers(0, tm.cfg.vocab_size, (b, s))
    tmed, jmed = both(media(tm.cfg, b, 21), dtype)
    jl, jc, _ = fwd(jp, jnp.asarray(toks), jmed, jm.init_cache(b, 32))
    tc = tm.init_cache(b, 32)
    with torch.no_grad():
        tl, tc2, aux = tm({"tokens": torch.from_numpy(toks),
                           MEDIA_KEY[arch]: tmed}, mode="prefill", cache=tc)
    assert tc2 is tc and tl.dtype == torch.float32
    assert tl.shape == (b, s, tm.cfg.padded_vocab)
    assert set(aux) == {"load_balance_loss", "router_z_loss"}
    assert all(float(v) == 0.0 for v in aux.values())
    close(tl, jl, tol["logits"])
    check_cache(tc, jc, tol["kv"])
    pos = np.full((b,), s, np.int32)
    for _ in range(steps):
        nxt = rng.integers(0, tm.cfg.vocab_size, (b, 1))
        jl, jc = dec(jp, jnp.asarray(nxt), jnp.asarray(pos), jc)
        with torch.no_grad():
            tl, tc = tm.decode_step(torch.from_numpy(nxt),
                                    torch.from_numpy(pos), tc)
        assert tl.shape == (b, 1, tm.cfg.padded_vocab)
        close(tl, jl, tol["decode"])
        check_cache(tc, jc, tol["kv"])
        pos = pos + 1

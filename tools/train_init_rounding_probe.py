"""How far does fp32 rounding alone move one train step of reduced
llama-3.2-vision-11b at the JAX init's weights?

``tests/test_torch_train.py`` holds one fp32 train step of every arch
against the JAX package's, the grad norm within 1e-5 relative.  A VLM's
tree goes through ``vision_redraw`` first.  At the JAX init (gates 0, the
self matrices at std 1/sqrt(n_groups)) the gradients are large, and the
two packages' grad norms part by about 4e-5.  This probe runs the JAX
package's own step on the same fp32 init weights twice, once in float32
and once cast to float64 (x64 mode), on the test's batch, and prints both
grad norms and losses with their relative gaps: a gap in JAX alone larger
than the test's limit says the packages' gap at that init is rounding.

Run on the CPU (the JAX package only; it changes nothing):
  PYTHONPATH=src python tools/train_init_rounding_probe.py
"""
import dataclasses
import json

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import config as jconfig  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402

ARCH = "llama-3.2-vision-11b"


def step_metrics(dtype: str) -> dict:
    """One JAX train step in ``dtype`` from the fp32 init weights."""
    cfg = jconfig.get_arch(ARCH).reduced()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    cfg_dt = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, dtype),
        jregistry.get_model(cfg32).init(jax.random.PRNGKey(0)))
    model = jregistry.get_model(cfg_dt)
    rng = np.random.default_rng(7)
    b, s = 2, 24
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1))
    xa = cfg.cross_attn
    media = rng.standard_normal((b, xa.num_media_tokens, xa.media_dim))
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:]),
             "media_embeds": jnp.asarray(media.astype(np.float32), dtype)}
    fn = jax.jit(jstep.make_train_step(model, jconfig.TrainConfig(
        learning_rate=1e-3, warmup_steps=2, total_steps=10)))
    _, _, m = fn(params, jopt.adamw_init(params), batch)
    return {"grad_norm": float(m["grad_norm"]), "loss": float(m["loss"])}


def main():
    f32, f64 = step_metrics("float32"), step_metrics("float64")
    gap = {k: abs(f32[k] - f64[k]) / abs(f64[k]) for k in f32}
    print(json.dumps({"arch": ARCH, "float32": f32, "float64": f64,
                      "relative_gap": gap, "test_limit": 1e-5}))


if __name__ == "__main__":
    main()

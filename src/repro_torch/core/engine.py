"""The CNNdroid inference engine in PyTorch: the port of
``repro.core.engine``.

``CNNEngine(net)`` compiles its network into an ``ExecutionPlan``
(``repro_torch.core.plan``) once per fuse setting and runs it with a thin
step loop.  At the defaults (``ADVANCED_SIMD_8``, fusion on) every conv
group runs on the K1/K2 CUDA kernels and every fc on K3; the other rungs
of the method ladder run on K7 (basic SIMD), K8 (basic parallel) and the
standalone pool K9 (``repro_torch.core.methods``).  The engine runs on
``cuda`` unless it is given ``device="cpu"``, where the plain PyTorch
versions run; with no GPU and no device it raises.

* ``forward_batched`` is the serving path (``repro_torch.serving.cnn``):
  it pads a batch with zero frames up to its power-of-two bucket, runs
  the forward and slices the real rows back out.  Bucket ``m`` always
  runs the kernels at batch ``m``, so a frame's row has the same bits
  whatever its batchmates.  The engine records the ``(fuse, bucket)``
  keys it served and counts them as the JAX package counts its bucket
  compilations (there is no compiled artifact per bucket yet): batch
  sizes ``1..max_batch`` cost at most ``log2(max_batch)+1``.
* ``verify`` / ``switch_verified`` gate a configuration change on the
  shape-flow verifier (``repro_torch.analysis.verifier``): the
  degradation ladder's check before a rung is served.
* Assigning ``method`` / ``fuse_pool`` / ``fuse_relu``, or mutating a
  ``per_layer_*`` map, drops the memoized plans and bucket records so
  the next call compiles against the new configuration.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple, Union

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.core.methods import Method
from repro_torch.core.netdefs import NetworkDef
from repro_torch.core.plan import ExecutionPlan, compile_plan, infer_param_shapes
from repro_torch.kernels.common import resolve_device


class _KnobDict(dict):
    """A per-layer knob map that invalidates the owning engine's plans on
    any mutation — ``eng.per_layer_fuse["conv1"] = False`` after a forward
    must re-plan, not keep serving the memoized stale plan."""

    def __init__(self, on_change, data=None):
        super().__init__(data or {})
        self._on_change = on_change

    def __setitem__(self, k, v):
        # no-op writes don't invalidate
        changed = k not in self or self[k] != v
        super().__setitem__(k, v)
        if changed:
            self._on_change()

    def __delitem__(self, k):
        super().__delitem__(k)
        self._on_change()

    def update(self, *args, **kwargs):
        before = dict(self)
        super().update(*args, **kwargs)
        if dict(self) != before:
            self._on_change()

    def __ior__(self, other):
        # dict.__ior__ bypasses update(): |= must invalidate too
        self.update(other)
        return self

    def setdefault(self, k, default=None):
        if k in self:  # pure read
            return self[k]
        super().__setitem__(k, default)
        self._on_change()
        return default

    def pop(self, *args):
        out = super().pop(*args)
        self._on_change()
        return out

    def popitem(self):
        out = super().popitem()
        self._on_change()
        return out

    def clear(self):
        super().clear()
        self._on_change()


_UNSET = object()


def _knob(name: str):
    """A config property whose assignment drops the memoized plans.
    Re-assigning the current value is a no-op."""
    attr = "_" + name

    def get(self):
        return getattr(self, attr)

    def set_(self, value):
        cur = getattr(self, attr, _UNSET)
        if cur is not _UNSET and (cur is value or cur == value):
            return
        setattr(self, attr, value)
        self.clear_caches()

    return property(get, set_)


def _dict_knob(name: str):
    """A per-layer map knob: reassignment re-wraps into a ``_KnobDict``
    (invalidating only on a real content change); in-place mutation
    invalidates via the wrapper."""
    attr = "_" + name

    def get(self):
        return getattr(self, attr)

    def set_(self, value):
        changed = dict(getattr(self, attr, {})) != dict(value or {})
        setattr(self, attr, _KnobDict(self.clear_caches, value))
        if changed:
            self.clear_caches()

    return property(get, set_)


class CNNEngine:
    """Forward-path executor for a trained CNN."""

    method = _knob("method")
    fuse_relu = _knob("fuse_relu")
    fuse_pool = _knob("fuse_pool")
    per_layer_methods = _dict_knob("per_layer_methods")
    per_layer_fuse = _dict_knob("per_layer_fuse")
    per_layer_pool_carry = _dict_knob("per_layer_pool_carry")
    per_layer_lrn_oc_block = _dict_knob("per_layer_lrn_oc_block")
    per_layer_oc_block_final = _dict_knob("per_layer_oc_block_final")

    def __init__(self, net: NetworkDef, method: Method = Method.ADVANCED_SIMD_8,
                 fuse_relu: bool = True,
                 per_layer_methods: Optional[Dict[str, Method]] = None,
                 fuse_pool: bool = True,
                 per_layer_fuse: Optional[Dict[str, bool]] = None,
                 per_layer_pool_carry: Optional[Dict[str, bool]] = None,
                 per_layer_lrn_oc_block: Optional[Dict[str, bool]] = None,
                 per_layer_oc_block_final: Optional[Dict[str, int]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.net = net
        self.device = resolve_device(device)
        # plan and bucket caches (created first: the knob setters below
        # clear them).  _buckets: the (fuse, bucket) keys served since the
        # last clear; each bucket only ever sees its one padded batch
        # shape, so their number is the compile count
        self._plans: Dict[bool, ExecutionPlan] = {}
        self._buckets: Set[Tuple[bool, int]] = set()
        self.method = method
        self.fuse_relu = fuse_relu
        self.per_layer_methods = per_layer_methods or {}
        # super-layer fusion; per_layer_fuse maps a conv/pool/lrn layer
        # name -> False to opt it out
        self.fuse_pool = fuse_pool
        self.per_layer_fuse = per_layer_fuse or {}
        self.per_layer_pool_carry = per_layer_pool_carry or {}
        self.per_layer_lrn_oc_block = per_layer_lrn_oc_block or {}
        self.per_layer_oc_block_final = per_layer_oc_block_final or {}
        self._shapes = infer_param_shapes(net)

    def clear_caches(self) -> None:
        """Drop the memoized execution plans and bucket records (the knob
        setters call it)."""
        self._plans.clear()
        self._buckets.clear()

    # -- parameters -----------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None
             ) -> Dict[str, Dict[str, torch.Tensor]]:
        """He-normal weights and zero biases, drawn from ``generator``
        (default: a CPU generator seeded with 0) and placed on the
        engine's device.  Conv weights are OIHW, fc weights
        ``[d_in, d_out]``, as in the JAX package."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        params = {}
        for spec in self.net.layers:
            if spec.kind not in ("conv", "fc"):
                continue
            shape = self._shapes[spec.name]
            if spec.kind == "conv":
                oc, ic, kh, kw = shape
                fan_in, n_out = ic * kh * kw, oc
            else:
                fan_in, n_out = shape
            w = torch.randn(shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            params[spec.name] = {
                "w": ((2.0 / fan_in) ** 0.5 * w).to(self.device),
                "b": torch.zeros((n_out,), dtype=torch.float32,
                                 device=self.device),
            }
        return params

    # -- forward ----------------------------------------------------------------
    def plan(self, fuse: Optional[bool] = None) -> ExecutionPlan:
        """The compiled ``ExecutionPlan`` for this configuration, memoized
        per fuse flag."""
        use_fuse = self.fuse_pool if fuse is None else bool(fuse)
        if use_fuse not in self._plans:
            self._plans[use_fuse] = compile_plan(
                self.net, method=self.method,
                per_layer_methods=self.per_layer_methods,
                fuse=use_fuse, fuse_relu=self.fuse_relu,
                per_layer_fuse=self.per_layer_fuse,
                per_layer_pool_carry=self.per_layer_pool_carry,
                per_layer_lrn_oc_block=self.per_layer_lrn_oc_block,
                per_layer_oc_block_final=self.per_layer_oc_block_final)
        return self._plans[use_fuse]

    def verify(self, fuse: Optional[bool] = None) -> List[Finding]:
        """Every finding of the shape-flow verifier on this engine's
        compiled plan."""
        from repro_torch.analysis.verifier import verify_plan

        return verify_plan(self.plan(fuse))

    #: knob names switch_verified accepts: the port's plan-invalidating
    #: configuration surface (the _knob/_dict_knob descriptors above; the
    #: JAX package's use_pallas and oh_block have no counterpart here)
    KNOBS = ("method", "fuse_relu", "fuse_pool", "per_layer_methods",
             "per_layer_fuse", "per_layer_pool_carry",
             "per_layer_lrn_oc_block", "per_layer_oc_block_final")

    def switch_verified(self, **knobs) -> Tuple[bool, List[Finding]]:
        """Apply a candidate knob configuration only if its compiled plan
        has no error-severity finding; otherwise roll every knob back.
        Returns ``(switched, findings)``.  Unknown knob names raise — a
        typo must not silently verify the unchanged configuration."""
        unknown = set(knobs) - set(self.KNOBS)
        if unknown:
            raise ValueError(f"unknown knob(s): {sorted(unknown)}")
        snapshot = {k: (dict(getattr(self, k)) if k.startswith("per_layer")
                        else getattr(self, k)) for k in knobs}
        for k, v in knobs.items():
            setattr(self, k, v)
        findings = self.verify()
        if any(f.severity == "error" for f in findings):
            for k, v in snapshot.items():
                setattr(self, k, v)
            return False, findings
        return True, findings

    def forward(self, params, x, collect: Optional[dict] = None,
                fuse: Optional[bool] = None):
        """x: [N, C, H, W] (a batch of frames, paper §4), moved to the
        engine's device.  ``collect`` (optional dict) receives per-layer
        outputs — it forces the un-fused plan so every activation exists.
        ``fuse`` overrides ``fuse_pool`` for this call."""
        if collect is not None:
            fuse = False  # instrumentation needs every per-layer output
        x = torch.as_tensor(x, device=self.device).contiguous()
        return self.plan(fuse).execute(params, x, collect=collect)

    # -- batch-bucketed forward (serving path) --------------------------------
    @staticmethod
    def batch_bucket(n: int) -> int:
        """The power-of-two bucket a batch of ``n`` requests rounds up
        to: every batch size in ``1..max_batch`` lands in one of the
        ``log2(max_batch)+1`` buckets ``{1, 2, 4, ..., max_batch}``."""
        if n < 1:
            raise ValueError(f"batch must be >= 1, got {n}")
        return 1 << (int(n) - 1).bit_length()

    def forward_batched(self, params, x, fuse: Optional[bool] = None):
        """``forward`` at the batch's power-of-two bucket: pad the batch
        with zero frames (on the engine's device), record the bucket, run
        the forward, slice the real rows back out."""
        use_fuse = self.fuse_pool if fuse is None else bool(fuse)
        x = torch.as_tensor(x, device=self.device)
        n = x.shape[0]
        bucket = self.batch_bucket(n)
        self._buckets.add((use_fuse, bucket))
        if bucket != n:
            pad = torch.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype,
                              device=self.device)
            x = torch.cat([x, pad], dim=0)
        return self.forward(params, x, fuse=use_fuse)[:n]

    def bucket_stats(self) -> dict:
        """The live ``(fuse, bucket)`` keys and the bucket compilations
        this engine has paid since its caches were last cleared."""
        return {"buckets": sorted(self._buckets),
                "compiles": len(self._buckets)}

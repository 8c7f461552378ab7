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
  plan verifier (``repro_torch.analysis.verifier``) at the batch buckets
  served and the engine's SMs (the card's on cuda): the degradation
  ladder's check before a rung is served.  ``plan`` compiles with
  ``compile_plan``'s own check, so a plan with an error finding raises
  ``PlanVerificationError`` before anything launches.
* Assigning ``method`` / ``fuse_pool`` / ``fuse_relu``, or mutating a
  ``per_layer_*`` map, drops the memoized plans, forwards and bucket
  records so the next call compiles against the new configuration.
* The timing helpers, as the JAX engine's: ``forward_fn`` (the cached
  forward a fuse setting runs, JAX's ``jit_forward``), ``time_forward``
  (seconds a call, on the host clock with the card synchronized after
  each call), ``heaviest_conv`` (the conv with the most MACs and its
  input) and ``conv_layer_fn`` (one conv through the method dispatch:
  K1, K7 or K8 on the card).  ``repro_torch.tools.cost_fit`` measures
  the cost model's rows with ``time_forward``.
"""
from __future__ import annotations

import time
from functools import partial
from typing import Callable, Dict, List, Optional, Set, Tuple, Union

import torch

from repro_torch.analysis.findings import Finding
from repro_torch.core.methods import Method, conv2d
from repro_torch.core.netdefs import NetworkDef
from repro_torch.core.plan import ExecutionPlan, compile_plan, infer_param_shapes
from repro_torch.kernels.common import resolve_device, sm_count


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
        self._forwards: Dict[bool, Callable] = {}
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
        """Drop the memoized execution plans, forwards and bucket records
        (the knob setters call it)."""
        self._plans.clear()
        self._forwards.clear()
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
    def _compile(self, use_fuse: bool, verify: bool) -> ExecutionPlan:
        return compile_plan(
            self.net, method=self.method,
            per_layer_methods=self.per_layer_methods,
            fuse=use_fuse, fuse_relu=self.fuse_relu,
            per_layer_fuse=self.per_layer_fuse,
            per_layer_pool_carry=self.per_layer_pool_carry,
            per_layer_lrn_oc_block=self.per_layer_lrn_oc_block,
            per_layer_oc_block_final=self.per_layer_oc_block_final,
            verify=verify)

    def plan(self, fuse: Optional[bool] = None) -> ExecutionPlan:
        """The compiled ``ExecutionPlan`` for this configuration, memoized
        per fuse flag; raises ``PlanVerificationError`` when it has an
        error finding (``compile_plan``'s check)."""
        use_fuse = self.fuse_pool if fuse is None else bool(fuse)
        if use_fuse not in self._plans:
            self._plans[use_fuse] = self._compile(use_fuse, True)
        return self._plans[use_fuse]

    @property
    def sms(self) -> int:
        """SMs the kernels' geometry is planned for: the card's on cuda,
        the verifier's default (an H100 SXM's 132) elsewhere."""
        from repro_torch.analysis.verifier import DEFAULT_SMS

        return (sm_count(self.device) if self.device.type == "cuda"
                else DEFAULT_SMS)

    def verify(self, fuse: Optional[bool] = None,
               batches: Optional[Tuple[int, ...]] = None) -> List[Finding]:
        """Every finding of the plan verifier on this engine's compiled
        plan, at ``batches`` (default: the buckets of ``max_batch`` 16)
        on the engine's SMs.  Returns the findings of a plan that
        ``plan`` would refuse too."""
        from repro_torch.analysis.verifier import DEFAULT_BATCHES, verify_plan

        use_fuse = self.fuse_pool if fuse is None else bool(fuse)
        plan = self._plans.get(use_fuse)
        if plan is None:
            plan = self._compile(use_fuse, False)
        return verify_plan(plan, batches=batches or DEFAULT_BATCHES,
                           sms=self.sms)

    #: knob names switch_verified accepts: the port's plan-invalidating
    #: configuration surface (the _knob/_dict_knob descriptors above; the
    #: JAX package's use_pallas and oh_block have no counterpart here)
    KNOBS = ("method", "fuse_relu", "fuse_pool", "per_layer_methods",
             "per_layer_fuse", "per_layer_pool_carry",
             "per_layer_lrn_oc_block", "per_layer_oc_block_final")

    def switch_verified(self, *, batches: Optional[Tuple[int, ...]] = None,
                        **knobs) -> Tuple[bool, List[Finding]]:
        """Apply a candidate knob configuration only if its compiled plan
        has no error-severity finding at ``batches`` (``verify``'s
        default if None); otherwise roll every knob back.  Returns
        ``(switched, findings)``.  Unknown knob names raise — a typo must
        not silently verify the unchanged configuration."""
        unknown = set(knobs) - set(self.KNOBS)
        if unknown:
            raise ValueError(f"unknown knob(s): {sorted(unknown)}")
        snapshot = {k: (dict(getattr(self, k)) if k.startswith("per_layer")
                        else getattr(self, k)) for k in knobs}
        for k, v in knobs.items():
            setattr(self, k, v)
        findings = self.verify(batches=batches)
        if any(f.severity == "error" for f in findings):
            for k, v in snapshot.items():
                setattr(self, k, v)
            return False, findings
        return True, findings

    def fusion_report(self, fuse: Optional[bool] = None) -> List[dict]:
        """Executed geometry of every fused group of this configuration's
        plan: layer names, chain depth, the final-row band a block owns
        (``rows_per_cell`` × ``n_tiles``), the output size, and the kernel
        (``cell``) with its channel block
        (``ExecutionPlan.fusion_report``)."""
        return self.plan(fuse).fusion_report()

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

    def forward_fn(self, fuse: Optional[bool] = None) -> Callable:
        """The forward of one fuse setting as a callable ``fn(params, x)``,
        memoized per setting — JAX's ``jit_forward``.  There is nothing to
        trace: the plan is compiled once (``plan``) and its kernels are
        built at their first launch, so repeated calls (``time_forward``)
        reuse both."""
        key = self.fuse_pool if fuse is None else bool(fuse)
        if key not in self._forwards:
            self._forwards[key] = partial(self.forward, fuse=key)
        return self._forwards[key]

    def time_forward(self, params, x, iters: int = 3,
                     fuse: Optional[bool] = None) -> float:
        """Seconds a forward takes: one warm-up call (which builds the
        kernels), then the host clock over ``iters`` calls, with the card
        synchronized after each one on cuda (JAX's ``block_until_ready``
        after each call)."""
        fn = self.forward_fn(fuse)
        x = torch.as_tensor(x, device=self.device)
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        fn(params, x)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(params, x)
            sync()
        return (time.perf_counter() - t0) / iters

    def heaviest_conv(self, params, x) -> Tuple[str, torch.Tensor]:
        """The conv layer with the most MACs (paper Table 4's target) and
        its input activation, from one unfused ``forward(collect=...)``."""
        best, best_macs, best_in = None, -1, None
        acts: dict = {}
        x = torch.as_tensor(x, device=self.device)
        self.forward(params, x, collect=acts)
        cur = x
        for spec in self.net.layers:
            if spec.kind == "conv":
                _, ic, kh, kw = self._shapes[spec.name]
                macs = acts[spec.name].numel() * ic * kh * kw
                if macs > best_macs:
                    best, best_macs, best_in = spec, macs, cur
            cur = acts[spec.name]
        return best.name, best_in

    def conv_layer_fn(self, name: str, method: Method,
                      oh_block: Optional[int] = None) -> Callable:
        """``fn(params, x)``: conv ``name`` alone (with its ReLU) through
        the method dispatch of ``core.methods`` — on the card K1 for the
        advanced methods, K7 for basic SIMD, K8 for basic parallel.
        ``oh_block`` is JAX's row band, accepted and not applied (the
        port's kernels have no row bands)."""
        spec = next(s for s in self.net.layers if s.name == name)

        def fn(params, x):
            p = params[name]
            x = torch.as_tensor(x, device=self.device).contiguous()
            return conv2d(x, p["w"], p["b"], method, spec.stride,
                          spec.padding, True)

        return fn

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

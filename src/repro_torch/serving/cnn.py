"""Batched CNN serving front-end — the paper's actual deployment
scenario (forward-only classification of incoming frames, §6.2 runs
batches of 16): the port of ``repro.serving.cnn`` over the port's
``CNNEngine``.  Everything but the engine call is the JAX package's numpy
code; the batch goes to the engine's device as one tensor (zero pad rows
made there) and the probabilities come back through ``.cpu().numpy()``.

``CNNServer`` queues per-image classification requests and serves them
in **dynamic batches**:

* ``submit`` enqueues an ``ImageRequest`` (one ``[C, H, W]`` frame)
  after admission control: the frame is validated (shape AND
  finiteness — a NaN frame would poison every batchmate's softmax),
  the bounded queue rejects on full, and a request whose deadline is
  already unmeetable is shed up front.  A shed request resolves to a
  typed ``ShedResult`` (returned AND recorded in ``done``) — never a
  silent drop;
* ``step`` first expires queued requests whose deadline has passed,
  then forms at most one batch: it flushes when ``max_batch`` requests
  are waiting OR the oldest request has aged past ``max_delay_s``,
  taking the oldest ``max_batch`` requests FIFO;
* the batch runs under a **supervised executor**: transient engine
  faults retry with capped exponential backoff, a repeatedly-failing
  batch bisects to isolate the poison request (the bad frame fails
  alone with a typed ``FailedResult``; its batchmates still get
  answers — bisection sub-batches keep the parent batch's pow2 bucket,
  so the kernels run at the same batch and surviving rows are
  byte-identical to a fault-free run), and
  non-finite output rows become per-request failures instead of
  garbage top-k;
* a **circuit breaker** trips the server into an unhealthy state after
  repeated supervisor-level failures (admission sheds while open,
  half-open probe after ``breaker_reset_s``), and an optional
  **degradation controller** (``serving.degrade``) walks the method
  ladder under sustained queue pressure or p95-vs-SLO drift — every
  candidate rung pre-validated through ``CNNEngine.switch_verified``
  before it is served;
* each served request resolves to an ``ImageResult`` with its top-k
  classes and probabilities plus the submit→complete latency and the
  dynamic batch it rode in.

``stats()`` reports the serving-scale numbers the benchmarks record
(requests served, batches, p50/p95 latency, throughput over busy time)
plus the robustness counters (shed/rejected/expired/retried/failed/
degraded/breaker trips); ``health()`` snapshots the live state.  The
clock, the backoff sleep, and the engine-fault schedule
(``serving.faults``) are all injectable, so every recovery path is
deterministic under test — no real sleeps anywhere.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core.engine import CNNEngine
from repro_torch.serving.degrade import DegradeController
from repro_torch.serving.faults import FaultInjector, TransientEngineFault


class NonFiniteInputError(ValueError):
    """A submitted frame contains NaN/Inf — rejected at admission (one
    non-finite frame would otherwise poison every batchmate's softmax)."""


class ServerWedgedError(RuntimeError):
    """``run_until_drained`` exhausted its step budget with requests
    still pending — the queue is wedged (e.g. breaker open), and the
    caller must not mistake that for a drained server.  Carries the
    undrained ``report``."""

    def __init__(self, report: dict):
        self.report = report
        super().__init__(
            f"server not drained after {report['steps']} steps: "
            f"{report['pending']} request(s) still pending "
            f"(rids {report['pending_rids']}); health={report['health']}")


@dataclasses.dataclass
class ImageRequest:
    """One classification request: a single ``[C, H, W]`` frame.

    ``deadline_s`` is the per-request SLO, relative to submit time
    (``None`` falls back to the server's ``default_deadline_s``; both
    ``None`` means no deadline).  A request that cannot make its
    deadline is shed at admission or expired from the queue — never
    served late into a consumer that already gave up on it.
    """
    rid: int
    image: "np.ndarray"
    top_k: int = 5
    deadline_s: Optional[float] = None


@dataclasses.dataclass
class ImageResult:
    """Top-k classes (descending probability) plus serving metadata."""
    rid: int
    top_indices: List[int]
    top_probs: List[float]
    latency_s: float      # submit -> result available
    batch_size: int       # real requests in the dynamic batch it rode in
    bucket: int           # the padded power-of-two bucket that executed
    ok: bool = True


@dataclasses.dataclass
class ShedResult:
    """A request the server declined to serve — typed, never silent.

    ``reason`` is one of ``queue_full`` (bounded admission queue),
    ``admission_deadline`` (the deadline is unmeetable even if served
    immediately), ``deadline_expired`` (aged out while queued), or
    ``breaker_open`` (the circuit breaker is shedding load).
    """
    rid: int
    reason: str
    detail: str = ""
    waited_s: float = 0.0
    ok: bool = False


@dataclasses.dataclass
class FailedResult:
    """A request the supervised executor could not serve — typed.

    ``error`` is ``engine_fault`` (the request fails alone after
    retry + bisection) or ``non_finite_output`` (its output row was
    NaN/Inf — detected, not served as garbage top-k).
    """
    rid: int
    error: str
    detail: str
    latency_s: float
    batch_size: int
    bucket: int
    ok: bool = False


#: everything a request can terminally resolve to
Result = Union[ImageResult, ShedResult, FailedResult]


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Retry/backoff + circuit-breaker policy for the supervised
    executor.  Backoff for attempt ``i`` is
    ``min(backoff_cap_s, backoff_base_s * 2**i)`` through the
    injectable ``sleep``; the breaker opens after
    ``breaker_threshold`` *consecutive* steps that produced at least
    one terminal failure, and half-opens ``breaker_reset_s`` after it
    tripped (one probe batch: success closes, failure re-opens)."""
    max_retries: int = 2
    backoff_base_s: float = 0.01
    backoff_cap_s: float = 0.25
    breaker_threshold: int = 3
    breaker_reset_s: float = 1.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff times must be >= 0")
        if self.breaker_threshold < 1:
            raise ValueError("breaker_threshold must be >= 1")
        if self.breaker_reset_s < 0:
            raise ValueError("breaker_reset_s must be >= 0")


#: queued entry: (request, submit time, absolute deadline or None)
_Pending = Tuple[ImageRequest, float, Optional[float]]

_COUNTERS = ("shed", "rejected", "expired", "retried", "failed",
             "degraded", "recovered", "breaker_trips", "bisections")


class CNNServer:
    """Dynamic-batching, fault-tolerant front-end over a ``CNNEngine``.

    The server is step-driven (no background threads): callers submit
    requests, then drive ``step()`` — each call serves at most one
    dynamic batch — or ``run_until_drained()``.  Batches never mix
    configurations: a degradation move lands between steps (the knob
    setters invalidate the plan and bucket caches, so the next batch
    runs the newly-verified plan).
    """

    def __init__(self, engine: CNNEngine, params, *, max_batch: int = 16,
                 max_delay_s: float = 2e-3, fuse: Optional[bool] = None,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue: int = 1024,
                 default_deadline_s: Optional[float] = None,
                 supervisor: Optional[SupervisorConfig] = None,
                 degrade: Optional[DegradeController] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 sleep: Callable[[float], None] = time.sleep):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.engine = engine
        self.params = params
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.fuse = fuse
        self.clock = clock
        self.max_queue = max_queue
        self.default_deadline_s = default_deadline_s
        self.supervisor = supervisor or SupervisorConfig()
        self.degrade = degrade
        self.fault_injector = fault_injector
        self.sleep = sleep
        self._input_shape = tuple(engine.net.input_shape)
        self._pending: Deque[_Pending] = deque()
        self.done: Dict[int, Result] = {}
        # circuit breaker: closed -> (threshold consecutive failing
        # steps) -> open -> (reset_s) -> half_open -> closed/open
        self._breaker = "closed"
        self._breaker_opened_t = 0.0
        self._consec_failures = 0
        # EWMA of measured batch service time (admission's "can this
        # deadline possibly be met" floor); 0.0 until the first batch
        self._service_ewma_s = 0.0
        self.events: Deque[dict] = deque(maxlen=256)
        # sliding window feeding the degradation controller's p95 —
        # distinct from _latencies_s so reset_stats keeps pressure
        # detection alive across bench warm-up resets
        self._recent_lat_s: Deque[float] = deque(maxlen=128)
        self.reset_stats()

    # -- client API -----------------------------------------------------------
    def submit(self, req: ImageRequest) -> Optional[ShedResult]:
        """Admission control + enqueue.  Returns ``None`` when the
        request was admitted (it is served by a later ``step()``), or
        the typed ``ShedResult`` (also recorded in ``done``) when it
        was shed at admission.  Invalid frames (wrong shape, NaN/Inf)
        raise — they are caller bugs, not load."""
        img = np.asarray(req.image)
        if tuple(img.shape) != self._input_shape:
            raise ValueError(
                f"request {req.rid}: image shape {tuple(img.shape)} does not "
                f"match the network input {self._input_shape}")
        if not np.all(np.isfinite(img)):
            raise NonFiniteInputError(
                f"request {req.rid}: image contains non-finite values "
                f"(NaN/Inf frames are rejected at admission — one would "
                f"poison every batchmate's softmax)")
        now = self.clock()
        if self._breaker == "open" and not self._breaker_ready(now):
            return self._shed(req, "breaker_open",
                              "circuit breaker is open", waited_s=0.0)
        deadline_s = (req.deadline_s if req.deadline_s is not None
                      else self.default_deadline_s)
        if deadline_s is not None and (
                deadline_s <= 0.0 or deadline_s < self._service_ewma_s):
            return self._shed(
                req, "admission_deadline",
                f"deadline {deadline_s:g}s cannot be met (estimated "
                f"service time {self._service_ewma_s:g}s)", waited_s=0.0)
        if len(self._pending) >= self.max_queue:
            self._counters["rejected"] += 1
            return self._shed(req, "queue_full",
                              f"admission queue at max_queue={self.max_queue}",
                              waited_s=0.0)
        deadline_t = None if deadline_s is None else now + deadline_s
        self._pending.append((req, now, deadline_t))
        return None

    def pending(self) -> int:
        return len(self._pending)

    def pop_result(self, rid: int) -> Optional[Result]:
        """Retrieve-and-remove a finished request's result (None when not
        done yet).  Long-lived servers should drain ``done`` through this
        — results otherwise accumulate for the server's lifetime."""
        return self.done.pop(rid, None)

    # -- shedding ---------------------------------------------------------------
    def _shed(self, req: ImageRequest, reason: str, detail: str,
              waited_s: float) -> ShedResult:
        res = ShedResult(rid=req.rid, reason=reason, detail=detail,
                         waited_s=waited_s)
        self.done[req.rid] = res
        self._counters["shed"] += 1
        self.events.append({"kind": "shed", "rid": req.rid, "reason": reason})
        return res

    def _expire_deadlines(self, now: float) -> List[ShedResult]:
        """Shed every queued request whose absolute deadline has passed
        (FIFO order preserved among the survivors)."""
        if not any(d is not None for _, _, d in self._pending):
            return []
        out: List[ShedResult] = []
        keep: Deque[_Pending] = deque()
        for req, t_sub, deadline_t in self._pending:
            if deadline_t is not None and now >= deadline_t:
                self._counters["expired"] += 1
                out.append(self._shed(
                    req, "deadline_expired",
                    f"deadline passed after {now - t_sub:g}s in queue",
                    waited_s=now - t_sub))
            else:
                keep.append((req, t_sub, deadline_t))
        self._pending = keep
        return out

    # -- breaker ----------------------------------------------------------------
    def _breaker_ready(self, now: float) -> bool:
        return (now - self._breaker_opened_t) >= self.supervisor.breaker_reset_s

    def _trip_breaker(self, now: float) -> None:
        self._breaker = "open"
        self._breaker_opened_t = now
        self._counters["breaker_trips"] += 1
        self.events.append({"kind": "breaker_open", "t": now})

    def _breaker_after_step(self, now: float, any_failed: bool) -> None:
        if any_failed:
            self._consec_failures += 1
            if self._breaker == "half_open":
                self._trip_breaker(now)  # the probe failed: re-open
            elif (self._breaker == "closed" and self._consec_failures
                    >= self.supervisor.breaker_threshold):
                self._trip_breaker(now)
        else:
            self._consec_failures = 0
            if self._breaker == "half_open":
                self._breaker = "closed"
                self.events.append({"kind": "breaker_closed", "t": now})

    # -- supervised execution ---------------------------------------------------
    def _invoke(self, xs: np.ndarray, rids: Sequence[int],
                bucket: int) -> np.ndarray:
        """One engine invocation, padded to ``bucket`` on the engine's
        device — bisection sub-batches keep the PARENT batch's bucket, so
        the kernels run at the same batch and surviving rows stay
        byte-identical to a fault-free run (zero-pad rows are inert
        batchmates).  Returns the real rows' probabilities as numpy."""
        dev = self.engine.device
        x = torch.from_numpy(xs).to(dev)
        if x.shape[0] < bucket:
            pad = torch.zeros((bucket - x.shape[0], *x.shape[1:]),
                              dtype=x.dtype, device=dev)
            x = torch.cat([x, pad], dim=0)

        def call(arr):
            return self.engine.forward_batched(self.params, arr,
                                               fuse=self.fuse).cpu().numpy()

        if self.fault_injector is not None:
            probs = self.fault_injector(call, x, rids)
        else:
            probs = call(x)
        return np.asarray(probs)[:len(rids)]

    def _supervise(self, xs: np.ndarray, rids: List[int],
                   bucket: int) -> List[Tuple[str, object]]:
        """Run one (sub-)batch with retry/backoff, bisecting on
        unrecoverable failure.  Returns one ``("ok", probs_row)`` or
        ``("fail", detail)`` per request, in request order."""
        sup = self.supervisor
        attempt = 0
        last_err: Optional[BaseException] = None
        while True:
            try:
                probs = self._invoke(xs, rids, bucket)
                return [("ok", probs[i]) for i in range(len(rids))]
            except TransientEngineFault as e:
                last_err = e  # typed transient: retry with backoff
                if attempt >= sup.max_retries:
                    break
                self._counters["retried"] += 1
                self.sleep(min(sup.backoff_cap_s,
                               sup.backoff_base_s * (2 ** attempt)))
                attempt += 1
            except Exception as e:  # noqa: BLE001 — recorded, then bisected
                last_err = e  # persistent/unknown: retrying cannot help
                break
        detail = f"{type(last_err).__name__}: {last_err}"
        if len(rids) == 1:
            self.events.append({"kind": "request_failed", "rid": rids[0],
                                "detail": detail})
            return [("fail", detail)]
        # bisect to isolate the poison request: each half re-enters the
        # supervisor with a fresh retry budget and the parent's bucket
        self._counters["bisections"] += 1
        self.events.append({"kind": "bisect", "rids": list(rids),
                            "detail": detail})
        mid = (len(rids) + 1) // 2
        return (self._supervise(xs[:mid], rids[:mid], bucket)
                + self._supervise(xs[mid:], rids[mid:], bucket))

    # -- serving loop -----------------------------------------------------------
    def _should_flush(self, force: bool) -> bool:
        if not self._pending:
            return False
        if force or len(self._pending) >= self.max_batch:
            return True
        oldest_t = self._pending[0][1]
        return (self.clock() - oldest_t) >= self.max_delay_s

    def step(self, force: bool = False) -> List[Result]:
        """Serve at most one dynamic batch.  Returns every request that
        reached a terminal result during this step — ``ImageResult``\\ s
        for the served batch, plus any ``ShedResult``\\ s expired from
        the queue and ``FailedResult``\\ s the supervisor isolated.
        Flushes when a full ``max_batch`` is waiting, the oldest request
        has exceeded the ``max_delay_s`` deadline, or ``force`` is set;
        otherwise serves nothing and keeps queueing."""
        now = self.clock()
        if self._breaker == "open":
            if not self._breaker_ready(now):
                self._observe_degrade()
                return []
            self._breaker = "half_open"  # one probe batch allowed
            self.events.append({"kind": "breaker_half_open", "t": now})
        results: List[Result] = list(self._expire_deadlines(now))
        if not self._should_flush(force):
            self._observe_degrade()
            return results
        take = min(len(self._pending), self.max_batch)
        batch = [self._pending.popleft() for _ in range(take)]
        xs = np.stack([np.asarray(r.image, np.float32)
                       for r, _, _ in batch])
        rids = [r.rid for r, _, _ in batch]
        bucket = CNNEngine.batch_bucket(take)
        t0 = self.clock()
        rows = self._supervise(xs, rids, bucket)
        t1 = self.clock()
        self._busy_s += t1 - t0
        self._batch_sizes.append(take)
        dt = t1 - t0
        self._service_ewma_s = (dt if self._service_ewma_s == 0.0
                                else 0.5 * self._service_ewma_s + 0.5 * dt)
        any_failed = False
        for (req, t_sub, _), (status, payload) in zip(batch, rows):
            res: Result
            if status == "fail":
                res = FailedResult(
                    rid=req.rid, error="engine_fault", detail=str(payload),
                    latency_s=t1 - t_sub, batch_size=take, bucket=bucket)
            else:
                p = np.asarray(payload)
                if not np.all(np.isfinite(p)):
                    res = FailedResult(
                        rid=req.rid, error="non_finite_output",
                        detail="output row contains NaN/Inf",
                        latency_s=t1 - t_sub, batch_size=take, bucket=bucket)
                else:
                    k = max(1, min(req.top_k, p.shape[-1]))
                    top = np.argsort(-p, kind="stable")[:k]
                    res = ImageResult(
                        rid=req.rid, top_indices=[int(j) for j in top],
                        top_probs=[float(p[j]) for j in top],
                        latency_s=t1 - t_sub, batch_size=take, bucket=bucket)
                    self._latencies_s.append(res.latency_s)
                    self._recent_lat_s.append(res.latency_s)
            if not res.ok:
                any_failed = True
                self._counters["failed"] += 1
            self.done[req.rid] = res
            results.append(res)
        self._breaker_after_step(t1, any_failed)
        self._observe_degrade()
        return results

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, Result]:
        """Serve everything queued (forcing ragged final batches rather
        than waiting out the deadline) and return ``{rid: result}``.
        Raises ``ServerWedgedError`` when ``max_steps`` is exhausted with
        requests still pending — a wedged queue (e.g. the breaker is
        open) must never be mistaken for a drained one."""
        steps = 0
        while self._pending and steps < max_steps:
            self.step(force=True)
            steps += 1
        if self._pending:
            raise ServerWedgedError({
                "steps": steps,
                "pending": len(self._pending),
                "pending_rids": [r.rid for r, _, _ in self._pending],
                "health": self.health(),
            })
        return self.done

    # -- degradation ------------------------------------------------------------
    def _recent_p95_s(self) -> Optional[float]:
        if not self._recent_lat_s:
            return None
        return float(np.percentile(np.asarray(self._recent_lat_s), 95))

    def _observe_degrade(self) -> None:
        if self.degrade is None:
            return
        action = self.degrade.observe(queue_depth=len(self._pending),
                                      p95_s=self._recent_p95_s())
        if action is not None:
            self._apply_rung(action)

    def _apply_rung(self, direction: str) -> None:
        """Walk the ladder in ``direction``, committing the first rung
        whose plan ``CNNEngine.switch_verified`` statically blesses —
        an unverifiable rung is skipped (recorded), never served."""
        ctl = self.degrade
        for idx in ctl.candidates(direction):
            rung = ctl.ladder[idx]
            ok, findings = self.engine.switch_verified(
                method=rung.method, fuse_pool=rung.fuse)
            if ok:
                self.fuse = None  # serve on the engine's verified fuse_pool
                ctl.commit(idx)
                key = "degraded" if direction == "down" else "recovered"
                self._counters[key] += 1
                self.events.append({"kind": key, "rung": rung.label,
                                    "index": idx})
                return
            self.events.append({
                "kind": "rung_rejected", "rung": rung.label, "index": idx,
                "findings": [str(f) for f in findings
                             if f.severity == "error"]})

    # -- stats / health ---------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the latency/throughput accumulators and robustness
        counters (results in ``done`` and live state — breaker,
        degradation rung — are kept; benches call this after warm-up so
        compile time never pollutes the serving numbers)."""
        self._latencies_s: List[float] = []
        self._batch_sizes: List[int] = []
        self._busy_s = 0.0
        self._counters: Dict[str, int] = {k: 0 for k in _COUNTERS}

    def stats(self) -> dict:
        """Serving-scale numbers since the last ``reset_stats()``:
        requests/batches served, mean batch size, p50/p95 submit→done
        latency (us), throughput (requests per second of server busy
        time — ``0.0`` when no busy time was accrued, never ``inf``),
        and the robustness counters."""
        served = len(self._latencies_s)
        out = {
            "served": served,
            "batches": len(self._batch_sizes),
            "mean_batch": (float(np.mean(self._batch_sizes))
                           if self._batch_sizes else 0.0),
            "busy_s": self._busy_s,
            "buckets": self.engine.bucket_stats()["buckets"],
            **self._counters,
        }
        if served:
            lat = np.asarray(self._latencies_s)
            out["p50_latency_us"] = float(np.percentile(lat, 50) * 1e6)
            out["p95_latency_us"] = float(np.percentile(lat, 95) * 1e6)
            out["throughput_rps"] = (served / self._busy_s
                                     if self._busy_s > 0 else 0.0)
        return out

    def health(self) -> dict:
        """Live robustness snapshot: overall ``state`` (``healthy`` /
        ``degraded`` — running below the top rung or probing half-open
        — / ``unhealthy`` — breaker open), breaker detail, queue depth,
        and the committed degradation rung."""
        if self._breaker == "open":
            state = "unhealthy"
        elif (self._breaker == "half_open"
                or (self.degrade is not None and self.degrade.rung > 0)):
            state = "degraded"
        else:
            state = "healthy"
        return {
            "state": state,
            "breaker": self._breaker,
            "consecutive_failures": self._consec_failures,
            "pending": len(self._pending),
            "method": self.engine.method.value,
            "service_estimate_s": self._service_ewma_s,
            "degrade": (None if self.degrade is None
                        else self.degrade.snapshot()),
        }

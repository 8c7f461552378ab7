"""Deterministic fault-injection harness for the CNN serving path: a copy
of ``repro.serving.faults`` (numpy only), with the same names, so one
``FaultScript`` drives the JAX server and the port's alike.

Every recovery path in ``CNNServer`` (retry/backoff, poison-batch
bisection, non-finite-row detection, circuit breaker, degradation under
latency drift) is exercised in the tests through this module — no real
sleeps, no flaky timing: faults fire on a **scripted schedule** keyed by
the engine-invocation index and by request id.

* ``FaultScript`` — the schedule.  ``transient_calls`` /
  ``persistent_calls`` name the 0-based invocation indices that raise
  ``TransientEngineFault`` / ``PersistentEngineFault``;
  ``latency_spikes`` maps an invocation index to seconds added through
  the injectable clock-advance hook (so p95-vs-SLO drift is scriptable
  under a fake clock); ``poison_rids`` fail every invocation whose
  sub-batch contains one of those request ids (the bisection target: a
  poison frame fails any batch it rides in, alone included);
  ``corrupt_rids`` overwrite those requests' output rows with NaN (the
  garbage-top-k class the server must convert into typed per-request
  failures).
* ``FaultInjector`` — wraps the engine call.  ``CNNServer`` passes every
  supervised invocation (initial attempt, each retry, each bisection
  half) through ``injector(call, x, rids)``; the injector consults the
  script, records an event, and either raises, delays, or corrupts.

The invocation counter deliberately counts *attempts*, not batches:
``transient_calls={0, 1}`` scripts "fail twice, then succeed", which is
exactly the shape the retry/backoff tests assert.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, List, Mapping, Optional, Sequence

import numpy as np


class EngineFault(RuntimeError):
    """Base of the injected engine-fault taxonomy (supervised by
    ``CNNServer``: transients retry, everything else bisects)."""


class TransientEngineFault(EngineFault):
    """A fault worth retrying (the injected analogue of a transient
    allocator/transfer hiccup)."""


class PersistentEngineFault(EngineFault):
    """A fault retrying cannot fix (the injected analogue of a poison
    input or a broken compiled artifact)."""


def _as_frozenset(value) -> FrozenSet[int]:
    return frozenset(value or ())


@dataclasses.dataclass(frozen=True)
class FaultScript:
    """A deterministic schedule of engine faults (see module docstring).

    All fields default empty — an empty script injects nothing, so a
    server wired with one behaves identically to an un-instrumented
    server (asserted in tests).
    """

    transient_calls: FrozenSet[int] = frozenset()
    persistent_calls: FrozenSet[int] = frozenset()
    latency_spikes: Mapping[int, float] = dataclasses.field(
        default_factory=dict)
    poison_rids: FrozenSet[int] = frozenset()
    corrupt_rids: FrozenSet[int] = frozenset()

    def __post_init__(self):
        object.__setattr__(self, "transient_calls",
                           _as_frozenset(self.transient_calls))
        object.__setattr__(self, "persistent_calls",
                           _as_frozenset(self.persistent_calls))
        object.__setattr__(self, "latency_spikes",
                           dict(self.latency_spikes or {}))
        object.__setattr__(self, "poison_rids",
                           _as_frozenset(self.poison_rids))
        object.__setattr__(self, "corrupt_rids",
                           _as_frozenset(self.corrupt_rids))


class FaultInjector:
    """Scripted hook on the engine call.

    ``advance`` is the latency-spike hook: under test it is the fake
    clock's ``advance`` method, in a live soak it could be
    ``time.sleep``.  ``None`` (default) records the spike event without
    consuming time — an un-wired injector never slows a real server.
    """

    def __init__(self, script: FaultScript,
                 advance: Optional[Callable[[float], None]] = None):
        self.script = script
        self.advance = advance
        self.calls = 0
        self.events: List[Dict] = []

    def _record(self, kind: str, idx: int, rids: Sequence[int], **extra):
        self.events.append({"call": idx, "kind": kind,
                            "rids": list(rids), **extra})

    def __call__(self, call: Callable[[np.ndarray], "np.ndarray"],
                 x, rids: Sequence[int]) -> np.ndarray:
        """One supervised engine invocation: ``call(x)`` under the
        script.  ``x`` is the already-bucket-padded batch; ``rids`` are
        the real request ids riding rows ``0..len(rids)-1``."""
        idx = self.calls
        self.calls += 1
        spike = self.script.latency_spikes.get(idx)
        if spike is not None:
            self._record("latency", idx, rids, seconds=spike)
            if self.advance is not None:
                self.advance(spike)
        if idx in self.script.transient_calls:
            self._record("transient", idx, rids)
            raise TransientEngineFault(
                f"injected transient fault at call {idx}")
        poisoned = sorted(self.script.poison_rids.intersection(rids))
        if idx in self.script.persistent_calls or poisoned:
            self._record("persistent", idx, rids, poisoned=poisoned)
            raise PersistentEngineFault(
                f"injected persistent fault at call {idx}"
                + (f" (poison rids {poisoned})" if poisoned else ""))
        out = np.asarray(call(x))
        if self.script.corrupt_rids:
            hit = [i for i, r in enumerate(rids)
                   if r in self.script.corrupt_rids]
            if hit:
                out = out.copy()
                out[hit] = np.nan
                self._record("corrupt", idx, rids,
                             corrupted=[rids[i] for i in hit])
        return out

"""Graceful method-degradation for the CNN serving path: the port of
``repro.serving.degrade``, the same code over the port's ``Method``.

The paper's method ladder (``seq_ref → … → advanced_simd_8``) is a
latency/throughput trade the server can walk at runtime: under
sustained overload it is better to serve every request on a cheaper
rung than to miss every deadline on the fastest one (the
resource-modeling argument of arxiv 1709.09503, and the AI-Benchmark
router's load-shedding/downgrade fallback, arxiv 1810.01109).

* ``Rung`` — one candidate configuration: an execution ``Method`` plus
  the ``fuse`` flag.  ``default_ladder`` derives the conventional walk
  (``advanced_simd_8 → advanced_simd_4 → basic_simd``, then
  fused→unfused as the floor).  On the card the rungs run on K1/K2/K3,
  K1/K2/K3, K7/K2/K3 and K7/K9/K3.
* ``DegradeController`` — pure-state hysteresis logic, no engine
  coupling: ``observe(queue_depth, p95_s)`` classifies each serving
  step as pressured (queue above ``queue_high`` or p95 above the
  ``p95_slo_s`` target) or calm, and recommends ``"down"`` only after
  ``degrade_after`` *consecutive* pressured observations, ``"up"`` only
  after ``recover_after`` consecutive calm ones, with a ``cooldown``
  dead-band after every committed move so the controller cannot flap
  between adjacent rungs on oscillating load.

The controller never touches the engine.  ``CNNServer`` owns the
application: each candidate rung is pre-validated through
``CNNEngine.switch_verified`` (the static plan verifier runs before the
knobs stick — an unverifiable rung is skipped, never served), and the
knob setters' cache invalidation guarantees the next batch runs the new
plan, not a stale one.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.methods import Method

#: SIMD rungs in descending-performance order (the degradation walk);
#: seq_ref/basic_parallel stay off the ladder — they are reference
#: implementations, not serving configurations.
_DESCENT = (Method.ADVANCED_SIMD_8, Method.ADVANCED_SIMD_4,
            Method.BASIC_SIMD)


@dataclasses.dataclass(frozen=True)
class Rung:
    """One serving configuration on the degradation ladder."""
    method: Method
    fuse: bool = True

    @property
    def label(self) -> str:
        return f"{self.method.value}/{'fused' if self.fuse else 'unfused'}"


def default_ladder(method: Method = Method.ADVANCED_SIMD_8,
                   fuse: bool = True) -> Tuple[Rung, ...]:
    """The conventional walk from ``method`` down: each remaining SIMD
    rung at the caller's fuse setting, then an unfused ``basic_simd``
    floor (the cheapest configuration that still serves)."""
    start = _DESCENT.index(method) if method in _DESCENT else 0
    rungs = [Rung(m, fuse) for m in _DESCENT[start:]]
    floor = Rung(Method.BASIC_SIMD, False)
    if rungs[-1] != floor:
        rungs.append(floor)
    return tuple(rungs)


class DegradeController:
    """Hysteresis state machine over a degradation ladder.

    ``rung`` indexes the *currently committed* ladder entry (0 = the
    configured, fastest rung).  The server calls ``observe`` once per
    serving step and, when a move is recommended, tries
    ``candidates(direction)`` in order until one rung verifies, then
    ``commit``\\ s it.
    """

    def __init__(self, ladder: Sequence[Rung], *, queue_high: int = 32,
                 p95_slo_s: Optional[float] = None, degrade_after: int = 3,
                 recover_after: int = 8, cooldown: int = 4):
        if not ladder:
            raise ValueError("degradation ladder must have >= 1 rung")
        if degrade_after < 1 or recover_after < 1:
            raise ValueError("degrade_after/recover_after must be >= 1")
        if queue_high < 0 or cooldown < 0:
            raise ValueError("queue_high/cooldown must be >= 0")
        self.ladder: Tuple[Rung, ...] = tuple(ladder)
        self.queue_high = queue_high
        self.p95_slo_s = p95_slo_s
        self.degrade_after = degrade_after
        self.recover_after = recover_after
        self.cooldown = cooldown
        self.rung = 0
        self.moves: List[int] = []  # committed rung indices, in order
        self._hot = 0    # consecutive pressured observations
        self._calm = 0   # consecutive calm observations
        self._hold = 0   # cooldown observations left before the next move

    def pressured(self, queue_depth: int,
                  p95_s: Optional[float] = None) -> bool:
        """One observation's verdict: queue pressure OR p95-vs-SLO
        drift (either alone is overload)."""
        if queue_depth > self.queue_high:
            return True
        return (self.p95_slo_s is not None and p95_s is not None
                and p95_s > self.p95_slo_s)

    def observe(self, *, queue_depth: int,
                p95_s: Optional[float] = None) -> Optional[str]:
        """Classify one serving step; return ``"down"``/``"up"`` when
        the hysteresis thresholds are met (and a move is possible), else
        ``None``.  The streak counters keep accumulating through the
        cooldown dead-band — pressure during cooldown is not forgotten,
        it just cannot trigger a move yet."""
        if self.pressured(queue_depth, p95_s):
            self._hot += 1
            self._calm = 0
        else:
            self._calm += 1
            self._hot = 0
        if self._hold > 0:
            self._hold -= 1
            return None
        if self._hot >= self.degrade_after and self.rung < len(self.ladder) - 1:
            return "down"
        if self._calm >= self.recover_after and self.rung > 0:
            return "up"
        return None

    def candidates(self, direction: str) -> List[int]:
        """Rung indices to try for a move, nearest first — the server
        walks these until one statically verifies (an unverifiable rung
        is skipped, not served)."""
        if direction == "down":
            return list(range(self.rung + 1, len(self.ladder)))
        if direction == "up":
            return list(range(self.rung - 1, -1, -1))
        raise ValueError(f"unknown direction {direction!r}")

    def commit(self, idx: int) -> None:
        """Record a verified switch to ``ladder[idx]`` and arm the
        cooldown dead-band (the hysteresis half that stops flapping)."""
        if not 0 <= idx < len(self.ladder):
            raise ValueError(f"rung index {idx} out of range")
        self.rung = idx
        self.moves.append(idx)
        self._hot = 0
        self._calm = 0
        self._hold = self.cooldown

    def snapshot(self) -> dict:
        """Introspection for ``CNNServer.health()``."""
        return {"rung": self.rung, "label": self.ladder[self.rung].label,
                "ladder": [r.label for r in self.ladder],
                "hot": self._hot, "calm": self._calm, "cooldown": self._hold,
                "moves": list(self.moves)}

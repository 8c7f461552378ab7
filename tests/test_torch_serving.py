"""The port's CNN serving front end on the CPU.

Two parts:

* the semantics of the JAX package's serving tests
  (``tests/test_cnn_serving.py`` and ``tests/test_serving_faults.py``) on
  the port's ``CNNServer`` over ``CNNEngine(lenet5(), device="cpu")``:
  FIFO batching, deadline flush, ragged buckets, admission control,
  retry/backoff, poison bisection with byte-identical survivors,
  non-finite rows, the circuit breaker, the degradation ladder and
  ``switch_verified``;
* the port's server held against the JAX ``CNNServer`` over
  ``CNNEngine(use_pallas=False)`` on the same numpy weights, requests,
  fake clock and fault script: equal top indices, probabilities within
  1e-5 (fp32 sums in another order), equal ``stats()`` counters and the
  same sequence of event kinds.

Every clock and sleep is injected, so no test waits.
"""
import numpy as np
import pytest
import torch

from repro.core.engine import CNNEngine as JEngine
from repro.core.methods import Method as JMethod
from repro.core.netdefs import lenet5 as jlenet5
from repro.serving import cnn as jcnn
from repro.serving import degrade as jdegrade
from repro.serving import faults as jfaults
from repro_torch.analysis.findings import Finding
from repro_torch.core.deploy import params_from_numpy
from repro_torch.core.engine import CNNEngine
from repro_torch.core.methods import Method
from repro_torch.core.netdefs import lenet5
from repro_torch.core.plan import infer_param_shapes
from repro_torch.serving import cnn as tcnn
from repro_torch.serving import degrade as tdegrade
from repro_torch.serving import faults as tfaults
from repro_torch.serving.cnn import (CNNServer, FailedResult, ImageRequest,
                                     ImageResult, NonFiniteInputError,
                                     ServerWedgedError, ShedResult,
                                     SupervisorConfig)
from repro_torch.serving.degrade import DegradeController, Rung, default_ladder
from repro_torch.serving.faults import (FaultInjector, FaultScript,
                                        PersistentEngineFault,
                                        TransientEngineFault)

PROB_TOL = 1e-5


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, s):
        self.t += s


class FakeSleep:
    def __init__(self):
        self.delays = []

    def __call__(self, s):
        self.delays.append(s)


def he_params(shapes, seed):
    rng = np.random.default_rng(seed)
    params = {}
    for name, shp in shapes.items():
        conv = len(shp) == 4
        fan = int(np.prod(shp[1:])) if conv else shp[0]
        params[name] = {
            "w": (rng.standard_normal(shp) * np.sqrt(2.0 / fan)
                  ).astype(np.float32),
            "b": (0.05 * rng.standard_normal(shp[0] if conv else shp[1])
                  ).astype(np.float32)}
    return params


@pytest.fixture(scope="module")
def lenet():
    net = lenet5()
    np_params = he_params(infer_param_shapes(net), seed=0)
    imgs = np.random.default_rng(1).standard_normal(
        (16, *net.input_shape)).astype(np.float32)
    eng = CNNEngine(net, device="cpu")
    return net, eng, params_from_numpy(np_params, "cpu"), imgs, np_params


def _fresh_engine(net):
    return CNNEngine(net, method=Method.ADVANCED_SIMD_8, device="cpu")


def _server(eng, params, **kw):
    kw.setdefault("clock", FakeClock())
    kw.setdefault("sleep", FakeSleep())
    return CNNServer(eng, params, **kw)


def _submit(server, imgs, rids, **req_kw):
    return [server.submit(ImageRequest(rid=r, image=imgs[r % len(imgs)],
                                       **req_kw))
            for r in rids]


def _probs(eng, params, x):
    return eng.forward_batched(params, torch.from_numpy(x)).numpy()


# -- queueing and dynamic batch formation -------------------------------------


def test_fifo_queueing_and_full_batch_flush(lenet):
    net, eng, params, imgs, _ = lenet
    clock = FakeClock()
    srv = CNNServer(eng, params, max_batch=4, max_delay_s=10.0, clock=clock)
    _submit(srv, imgs, range(5))
    served = srv.step()
    assert [r.rid for r in served] == [0, 1, 2, 3]
    assert all(r.batch_size == 4 and r.bucket == 4 for r in served)
    assert srv.pending() == 1
    assert srv.step() == []
    clock.t += 11.0
    (last,) = srv.step()
    assert last.rid == 4 and last.batch_size == 1 and last.bucket == 1
    assert set(srv.done) == set(range(5))


def test_deadline_flush_with_injectable_clock(lenet):
    net, eng, params, imgs, _ = lenet
    clock = FakeClock()
    srv = CNNServer(eng, params, max_batch=8, max_delay_s=1.0, clock=clock)
    _submit(srv, imgs, range(2))
    assert srv.step() == []
    clock.t = 0.5
    assert srv.step() == []
    clock.t = 1.01
    served = srv.step()
    assert [r.rid for r in served] == [0, 1]
    assert served[0].batch_size == 2 and served[0].bucket == 2


def test_run_until_drained_forces_ragged_tail(lenet):
    net, eng, params, imgs, _ = lenet
    srv = CNNServer(eng, params, max_batch=4, max_delay_s=100.0,
                    clock=FakeClock())
    _submit(srv, imgs, range(7))
    done = srv.run_until_drained()
    assert set(done) == set(range(7))
    s = srv.stats()
    assert s["served"] == 7 and s["batches"] == 2
    assert s["mean_batch"] == pytest.approx(3.5)
    assert s["p50_latency_us"] >= 0
    assert s["p95_latency_us"] >= s["p50_latency_us"]


def test_unbatched_server_matches_per_request_exactly(lenet):
    net, eng, params, imgs, _ = lenet
    srv = CNNServer(eng, params, max_batch=1, max_delay_s=0.0)
    _submit(srv, imgs, range(4), top_k=3)
    srv.run_until_drained()
    for r in range(4):
        probs = _probs(eng, params, imgs[r:r + 1])[0]
        top = np.argsort(-probs, kind="stable")[:3]
        res = srv.done[r]
        assert res.top_indices == [int(j) for j in top]
        assert res.top_probs == [float(probs[j]) for j in top]


def test_ragged_batches_match_per_request(lenet):
    """Ragged batches padded to their bucket reproduce each request's
    unbatched output: byte-exact within a bucket (zero pad rows are inert
    batchmates), within 1e-6 across buckets."""
    net, eng, params, imgs, _ = lenet
    srv = CNNServer(eng, params, max_batch=8, max_delay_s=0.0,
                    clock=FakeClock())
    for rids in (range(0, 3), range(3, 8), range(8, 9)):
        _submit(srv, imgs, rids, top_k=4)
        srv.step(force=True)
    assert sorted(r.batch_size for r in srv.done.values()) == \
        [1] + [3] * 3 + [5] * 5
    for r in range(9):
        probs = _probs(eng, params, imgs[r:r + 1])[0]
        res = srv.done[r]
        assert np.allclose(res.top_probs, np.sort(probs)[::-1][:4],
                           atol=1e-6)
        assert res.top_indices == [
            int(j) for j in np.argsort(-probs, kind="stable")[:4]]
    a = _probs(eng, params, imgs[:3])   # bucket 4, one pad row
    b = _probs(eng, params, imgs[:4])   # bucket 4, no pad
    assert np.array_equal(a, b[:3])


def test_serving_compile_bound(lenet):
    net, _, params, imgs, _ = lenet
    eng = _fresh_engine(net)
    srv = CNNServer(eng, params, max_batch=8, max_delay_s=0.0,
                    clock=FakeClock())
    rid = 0
    for size in (1, 2, 3, 4, 5, 6, 7, 8, 3, 5, 1, 8):
        for _ in range(size):
            srv.submit(ImageRequest(rid=rid, image=imgs[rid % 16]))
            rid += 1
        srv.step(force=True)
    assert eng.bucket_stats()["compiles"] <= 4  # log2(8)+1
    assert srv.stats()["served"] == rid


def test_submit_rejects_wrong_shape(lenet):
    net, eng, params, imgs, _ = lenet
    srv = CNNServer(eng, params)
    with pytest.raises(ValueError, match="shape"):
        srv.submit(ImageRequest(rid=0, image=np.zeros((1, 28, 29))))
    with pytest.raises(ValueError, match="max_batch"):
        CNNServer(eng, params, max_batch=0)


def test_top_k_clamped_and_sorted(lenet):
    net, eng, params, imgs, _ = lenet
    srv = CNNServer(eng, params, max_batch=2, max_delay_s=0.0)
    srv.submit(ImageRequest(rid=0, image=imgs[0], top_k=99))
    srv.run_until_drained()
    res = srv.done[0]
    assert len(res.top_indices) == net.num_classes
    assert res.top_probs == sorted(res.top_probs, reverse=True)
    assert abs(sum(res.top_probs) - 1.0) < 1e-5


def test_reset_stats_keeps_results(lenet):
    net, eng, params, imgs, _ = lenet
    srv = CNNServer(eng, params, max_batch=4, max_delay_s=0.0)
    _submit(srv, imgs, range(3))
    srv.run_until_drained()
    srv.reset_stats()
    assert srv.stats()["served"] == 0 and set(srv.done) == {0, 1, 2}
    assert srv.pop_result(1).rid == 1
    assert srv.pop_result(1) is None and set(srv.done) == {0, 2}


# -- the fault harness and admission control ------------------------------------


def test_empty_script_injector_is_transparent(lenet):
    net, eng, params, imgs, _ = lenet
    plain = _server(eng, params, max_batch=4, max_delay_s=0.0)
    _submit(plain, imgs, range(4))
    plain.run_until_drained()
    inj = FaultInjector(FaultScript())
    faulted = _server(eng, params, max_batch=4, max_delay_s=0.0,
                      fault_injector=inj)
    _submit(faulted, imgs, range(4))
    faulted.run_until_drained()
    for r in range(4):
        assert faulted.done[r].top_probs == plain.done[r].top_probs
        assert faulted.done[r].top_indices == plain.done[r].top_indices
    assert inj.calls == 1 and inj.events == []


def test_injected_faults_raise_typed(lenet):
    net = lenet[0]
    inj = FaultInjector(FaultScript(transient_calls={0},
                                    persistent_calls={1}))
    x = np.zeros((1, *net.input_shape), np.float32)
    with pytest.raises(TransientEngineFault):
        inj(lambda a: a, x, [0])
    with pytest.raises(PersistentEngineFault):
        inj(lambda a: a, x, [0])
    assert [e["kind"] for e in inj.events] == ["transient", "persistent"]


def test_queue_full_rejection(lenet):
    net, eng, params, imgs, _ = lenet
    srv = _server(eng, params, max_batch=4, max_delay_s=10.0, max_queue=2)
    assert srv.submit(ImageRequest(rid=0, image=imgs[0])) is None
    assert srv.submit(ImageRequest(rid=1, image=imgs[1])) is None
    shed = srv.submit(ImageRequest(rid=2, image=imgs[2]))
    assert isinstance(shed, ShedResult) and shed.reason == "queue_full"
    assert not shed.ok and srv.done[2] is shed and srv.pending() == 2
    s = srv.stats()
    assert s["rejected"] == 1 and s["shed"] == 1


def test_non_finite_frame_rejected_at_admission(lenet):
    net, eng, params, imgs, _ = lenet
    srv = _server(eng, params)
    bad = imgs[0].copy()
    bad[0, 3, 3] = np.nan
    with pytest.raises(NonFiniteInputError, match="non-finite"):
        srv.submit(ImageRequest(rid=0, image=bad))
    bad[0, 3, 3] = np.inf
    with pytest.raises(ValueError):
        srv.submit(ImageRequest(rid=0, image=bad))
    assert srv.pending() == 0


def test_unmeetable_deadline_shed_at_admission(lenet):
    net, eng, params, imgs, _ = lenet
    clock = FakeClock()
    inj = FaultInjector(FaultScript(latency_spikes={0: 1.0}),
                        advance=clock.advance)
    srv = _server(eng, params, max_batch=1, max_delay_s=0.0, clock=clock,
                  fault_injector=inj)
    _submit(srv, imgs, [0])
    srv.run_until_drained()
    assert srv.health()["service_estimate_s"] == pytest.approx(1.0)
    shed = srv.submit(ImageRequest(rid=1, image=imgs[1], deadline_s=0.5))
    assert isinstance(shed, ShedResult)
    assert shed.reason == "admission_deadline"
    shed0 = srv.submit(ImageRequest(rid=2, image=imgs[2], deadline_s=0.0))
    assert shed0.reason == "admission_deadline"
    assert srv.submit(
        ImageRequest(rid=3, image=imgs[3], deadline_s=5.0)) is None


def test_deadline_expiry_ordering_under_injectable_clock(lenet):
    net, eng, params, imgs, _ = lenet
    clock = FakeClock()
    srv = _server(eng, params, max_batch=8, max_delay_s=100.0, clock=clock)
    srv.submit(ImageRequest(rid=0, image=imgs[0], deadline_s=1.0))
    srv.submit(ImageRequest(rid=1, image=imgs[1], deadline_s=3.0))
    srv.submit(ImageRequest(rid=2, image=imgs[2], deadline_s=0.5))
    clock.t = 0.6
    out = srv.step()
    assert [r.rid for r in out] == [2]
    assert isinstance(out[0], ShedResult)
    assert out[0].reason == "deadline_expired"
    assert out[0].waited_s == pytest.approx(0.6)
    clock.t = 1.2
    assert [r.rid for r in srv.step()] == [0]
    assert srv.pending() == 1
    (served,) = srv.step(force=True)
    assert isinstance(served, ImageResult) and served.rid == 1
    s = srv.stats()
    assert s["expired"] == 2 and s["shed"] == 2 and s["served"] == 1


def test_default_deadline_applies_to_requests_without_one(lenet):
    net, eng, params, imgs, _ = lenet
    clock = FakeClock()
    srv = _server(eng, params, max_batch=8, max_delay_s=100.0, clock=clock,
                  default_deadline_s=1.0)
    srv.submit(ImageRequest(rid=0, image=imgs[0]))
    srv.submit(ImageRequest(rid=1, image=imgs[1], deadline_s=9.0))
    clock.t = 2.0
    out = srv.step()
    assert [r.rid for r in out] == [0]
    assert out[0].reason == "deadline_expired"


# -- supervised execution -------------------------------------------------------


def test_retry_backoff_schedule(lenet):
    net, eng, params, imgs, _ = lenet
    sleep = FakeSleep()
    inj = FaultInjector(FaultScript(transient_calls={0, 1}))
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0, sleep=sleep,
                  fault_injector=inj,
                  supervisor=SupervisorConfig(max_retries=2,
                                              backoff_base_s=0.01,
                                              backoff_cap_s=0.25))
    _submit(srv, imgs, range(2))
    srv.run_until_drained()
    assert all(isinstance(srv.done[r], ImageResult) for r in range(2))
    assert sleep.delays == [0.01, 0.02]
    s = srv.stats()
    assert s["retried"] == 2 and s["failed"] == 0 and inj.calls == 3


def test_backoff_is_capped(lenet):
    net, eng, params, imgs, _ = lenet
    sleep = FakeSleep()
    inj = FaultInjector(FaultScript(transient_calls={0, 1, 2, 3}))
    srv = _server(eng, params, max_batch=1, max_delay_s=0.0, sleep=sleep,
                  fault_injector=inj,
                  supervisor=SupervisorConfig(max_retries=4,
                                              backoff_base_s=0.1,
                                              backoff_cap_s=0.25))
    _submit(srv, imgs, [0])
    srv.run_until_drained()
    assert sleep.delays == [0.1, 0.2, 0.25, 0.25]
    assert isinstance(srv.done[0], ImageResult)


def test_transient_exhaustion_falls_back_to_bisection(lenet):
    net, eng, params, imgs, _ = lenet
    inj = FaultInjector(FaultScript(transient_calls={0, 1, 2}))
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0,
                  fault_injector=inj,
                  supervisor=SupervisorConfig(max_retries=1,
                                              backoff_base_s=0.01))
    _submit(srv, imgs, range(2))
    srv.run_until_drained()
    assert all(isinstance(srv.done[r], ImageResult) for r in range(2))
    s = srv.stats()
    assert s["retried"] == 2 and s["bisections"] == 1 and s["failed"] == 0


@pytest.mark.parametrize("poison", [0, 2, 7])
def test_poison_batch_bisection_isolates_exactly_one(lenet, poison):
    """One poison request in a batch of 8 yields one typed FailedResult;
    every batchmate's result is byte-identical to a fault-free run, though
    bisection moves it to another row of the (parent-sized) bucket: the
    CPU plain path gives a row the same bits whatever the other rows and
    its position hold."""
    net, eng, params, imgs, _ = lenet
    clean = _server(eng, params, max_batch=8, max_delay_s=0.0)
    _submit(clean, imgs, range(8), top_k=10)
    clean.run_until_drained()
    inj = FaultInjector(FaultScript(poison_rids={poison}))
    srv = _server(eng, params, max_batch=8, max_delay_s=0.0,
                  fault_injector=inj,
                  supervisor=SupervisorConfig(max_retries=2))
    _submit(srv, imgs, range(8), top_k=10)
    srv.run_until_drained()
    failed = [r for r in srv.done.values() if isinstance(r, FailedResult)]
    assert [f.rid for f in failed] == [poison]
    assert failed[0].error == "engine_fault"
    assert "PersistentEngineFault" in failed[0].detail
    for r in set(range(8)) - {poison}:
        res = srv.done[r]
        assert isinstance(res, ImageResult) and res.bucket == 8
        assert res.top_probs == clean.done[r].top_probs   # byte-identical
        assert res.top_indices == clean.done[r].top_indices
    s = srv.stats()
    assert s["failed"] == 1 and s["served"] == 7 and s["bisections"] >= 1
    assert s["retried"] == 0


def test_non_finite_output_row_becomes_typed_failure(lenet):
    net, eng, params, imgs, _ = lenet
    clean = _server(eng, params, max_batch=4, max_delay_s=0.0)
    _submit(clean, imgs, range(4))
    clean.run_until_drained()
    inj = FaultInjector(FaultScript(corrupt_rids={1}))
    srv = _server(eng, params, max_batch=4, max_delay_s=0.0,
                  fault_injector=inj)
    _submit(srv, imgs, range(4))
    srv.run_until_drained()
    res = srv.done[1]
    assert isinstance(res, FailedResult) and res.error == "non_finite_output"
    for r in (0, 2, 3):
        assert srv.done[r].top_probs == clean.done[r].top_probs
        assert all(np.isfinite(srv.done[r].top_probs))
    assert srv.stats()["failed"] == 1


# -- circuit breaker ------------------------------------------------------------


def test_breaker_trips_sheds_and_resets(lenet):
    net, eng, params, imgs, _ = lenet
    clock = FakeClock()
    inj = FaultInjector(FaultScript(persistent_calls=frozenset(range(6))))
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0, clock=clock,
                  fault_injector=inj,
                  supervisor=SupervisorConfig(breaker_threshold=2,
                                              breaker_reset_s=10.0))
    _submit(srv, imgs, [0, 1])
    srv.step(force=True)
    assert srv.health()["breaker"] == "closed"
    assert srv.health()["consecutive_failures"] == 1
    _submit(srv, imgs, [2, 3])
    srv.step(force=True)
    h = srv.health()
    assert h["breaker"] == "open" and h["state"] == "unhealthy"
    assert srv.stats()["breaker_trips"] == 1
    shed = srv.submit(ImageRequest(rid=4, image=imgs[4]))
    assert isinstance(shed, ShedResult) and shed.reason == "breaker_open"
    assert srv.step(force=True) == []
    clock.t = 11.0
    assert srv.submit(ImageRequest(rid=5, image=imgs[5])) is None
    (res,) = srv.step(force=True)
    assert isinstance(res, ImageResult) and res.rid == 5
    h = srv.health()
    assert h["breaker"] == "closed" and h["state"] == "healthy"
    assert h["consecutive_failures"] == 0


def test_breaker_reopens_on_failed_probe(lenet):
    net, eng, params, imgs, _ = lenet
    clock = FakeClock()
    inj = FaultInjector(FaultScript(persistent_calls=frozenset(range(9))))
    srv = _server(eng, params, max_batch=1, max_delay_s=0.0, clock=clock,
                  fault_injector=inj,
                  supervisor=SupervisorConfig(breaker_threshold=1,
                                              breaker_reset_s=5.0))
    _submit(srv, imgs, [0])
    srv.step(force=True)
    assert srv.health()["breaker"] == "open"
    clock.t = 6.0
    assert srv.submit(ImageRequest(rid=1, image=imgs[1])) is None
    srv.step(force=True)
    assert srv.health()["breaker"] == "open"
    assert srv.stats()["breaker_trips"] == 2


def test_run_until_drained_raises_when_wedged(lenet):
    net, eng, params, imgs, _ = lenet
    inj = FaultInjector(FaultScript(persistent_calls=frozenset(range(3))))
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0,
                  fault_injector=inj,
                  supervisor=SupervisorConfig(breaker_threshold=1,
                                              breaker_reset_s=1e9))
    _submit(srv, imgs, range(4))
    with pytest.raises(ServerWedgedError, match="not drained") as ei:
        srv.run_until_drained(max_steps=5)
    assert ei.value.report["pending"] == 2
    assert ei.value.report["pending_rids"] == [2, 3]
    assert ei.value.report["health"]["breaker"] == "open"


def test_stats_throughput_zero_not_inf(lenet):
    net, eng, params, imgs, _ = lenet
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0)
    _submit(srv, imgs, range(2))
    srv.run_until_drained()
    s = srv.stats()
    assert s["served"] == 2 and s["busy_s"] == 0.0
    assert s["throughput_rps"] == 0.0


# -- degradation ladder -----------------------------------------------------------


def test_default_ladder_walks_down_to_unfused_floor():
    assert default_ladder(Method.ADVANCED_SIMD_8, fuse=True) == (
        Rung(Method.ADVANCED_SIMD_8, True), Rung(Method.ADVANCED_SIMD_4, True),
        Rung(Method.BASIC_SIMD, True), Rung(Method.BASIC_SIMD, False))
    assert default_ladder(Method.BASIC_SIMD, fuse=False) == (
        Rung(Method.BASIC_SIMD, False),)
    # the same labels as the JAX package's ladder
    assert [r.label for r in default_ladder()] == [
        r.label for r in jdegrade.default_ladder()]


def test_controller_hysteresis_and_cooldown():
    ctl = DegradeController(default_ladder(), queue_high=4, degrade_after=3,
                            recover_after=2, cooldown=2)
    assert ctl.observe(queue_depth=9) is None
    assert ctl.observe(queue_depth=9) is None
    assert ctl.observe(queue_depth=0) is None
    assert ctl.observe(queue_depth=9) is None
    assert ctl.observe(queue_depth=9) is None
    assert ctl.observe(queue_depth=9) == "down"
    ctl.commit(1)
    assert ctl.observe(queue_depth=9) is None
    assert ctl.observe(queue_depth=9) is None
    assert ctl.observe(queue_depth=9) == "down"
    ctl.commit(2)
    assert ctl.observe(queue_depth=0) is None
    assert ctl.observe(queue_depth=0) is None
    assert ctl.observe(queue_depth=0) == "up"
    ctl.commit(1)
    assert ctl.rung == 1 and ctl.moves == [1, 2, 1]


def test_controller_p95_slo_drift_is_pressure():
    ctl = DegradeController(default_ladder(), queue_high=100,
                            p95_slo_s=0.010, degrade_after=2, cooldown=0)
    assert ctl.observe(queue_depth=0, p95_s=0.030) is None
    assert ctl.observe(queue_depth=0, p95_s=0.030) == "down"
    assert ctl.pressured(queue_depth=0, p95_s=None) is False


def test_degradation_and_recovery_integration(lenet):
    net, _, params, imgs, _ = lenet
    eng = _fresh_engine(net)
    ladder = (Rung(Method.ADVANCED_SIMD_8, True),
              Rung(Method.ADVANCED_SIMD_4, True))
    ctl = DegradeController(ladder, queue_high=2, degrade_after=2,
                            recover_after=3, cooldown=0)
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0, degrade=ctl)
    _submit(srv, imgs, range(8))
    srv.step(force=True)
    assert eng.method == Method.ADVANCED_SIMD_8
    srv.step(force=True)
    assert eng.method == Method.ADVANCED_SIMD_4 and ctl.rung == 1
    assert srv.health()["state"] == "degraded"
    assert srv.stats()["degraded"] == 1
    assert not any(f.severity == "error" for f in eng.verify())
    srv.run_until_drained()
    srv.step()
    srv.step()
    assert eng.method == Method.ADVANCED_SIMD_8
    assert ctl.rung == 0 and srv.stats()["recovered"] == 1
    assert srv.health()["state"] == "healthy"
    assert all(isinstance(srv.done[r], ImageResult) for r in range(8))


def _reject_advanced_4(self, fuse=None, batches=None):
    if self.method == Method.ADVANCED_SIMD_4:
        return [Finding("error", "plan", "V101", "injected bust")]
    return []


def test_unverifiable_rung_is_skipped(lenet, monkeypatch):
    """A rung whose plan fails verification is never served:
    switch_verified rolls the knobs back and the server walks on."""
    net, _, params, imgs, _ = lenet
    eng = _fresh_engine(net)
    monkeypatch.setattr(CNNEngine, "verify", _reject_advanced_4)
    ladder = (Rung(Method.ADVANCED_SIMD_8, True),
              Rung(Method.ADVANCED_SIMD_4, True),
              Rung(Method.BASIC_SIMD, True))
    ctl = DegradeController(ladder, queue_high=1, degrade_after=1,
                            cooldown=0)
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0, degrade=ctl)
    _submit(srv, imgs, range(6))
    srv.step(force=True)
    assert eng.method == Method.BASIC_SIMD and ctl.rung == 2
    rejected = [e for e in srv.events if e["kind"] == "rung_rejected"]
    assert len(rejected) == 1
    assert rejected[0]["rung"] == "advanced_simd_4/fused"
    assert rejected[0]["findings"] == ["[V101:error] plan: injected bust"]
    srv.run_until_drained()
    assert all(isinstance(srv.done[r], ImageResult) for r in range(6))


def test_switch_verified_rolls_back_on_error(lenet, monkeypatch):
    net = lenet[0]
    eng = _fresh_engine(net)
    plan = eng.plan()
    monkeypatch.setattr(CNNEngine, "verify", _reject_advanced_4)
    ok, findings = eng.switch_verified(method=Method.ADVANCED_SIMD_4)
    assert not ok and findings[0].rule == "V101"
    assert eng.method == Method.ADVANCED_SIMD_8      # rolled back
    assert eng.plan().steps == plan.steps
    ok, findings = eng.switch_verified(method=Method.BASIC_SIMD,
                                       fuse_pool=False)
    assert ok and eng.method == Method.BASIC_SIMD and eng.fuse_pool is False
    with pytest.raises(ValueError, match="unknown knob"):
        eng.switch_verified(methd=Method.BASIC_SIMD)
    with pytest.raises(ValueError, match="unknown knob"):
        eng.switch_verified(use_pallas=True)   # no such knob in the port


def test_overload_burst_sheds_and_degrades(lenet):
    net, _, params, imgs, _ = lenet
    eng = _fresh_engine(net)
    ladder = (Rung(Method.ADVANCED_SIMD_8, True),
              Rung(Method.ADVANCED_SIMD_4, True))
    ctl = DegradeController(ladder, queue_high=1, degrade_after=1,
                            recover_after=10 ** 9, cooldown=0)
    srv = _server(eng, params, max_batch=2, max_delay_s=0.0, max_queue=4,
                  degrade=ctl)
    sheds = [r for r in _submit(srv, imgs, range(10)) if r is not None]
    assert len(sheds) == 6
    assert all(s.reason == "queue_full" for s in sheds)
    srv.run_until_drained()
    s = srv.stats()
    assert s["rejected"] == 6 and s["shed"] == 6
    assert s["degraded"] >= 1 and s["served"] == 4
    assert eng.method == Method.ADVANCED_SIMD_4
    assert all(isinstance(srv.done[r], ShedResult) for r in range(4, 10))
    assert all(isinstance(srv.done[r], ImageResult) for r in range(4))


# -- the port's server against the JAX server --------------------------------------


def _servers(lenet, script=None, ladder=None, supervisor=None, **kw):
    """``[(port server, its serving modules), (JAX server, its modules)]``
    over the same weights, each with its own fake clock and sleep and,
    when given, the same fault script (``FaultScript`` fields), degradation
    controller settings over the default ladder, and supervisor policy."""
    net, _, params, _, np_params = lenet
    out = []
    for mods, eng, p in (
            ((tcnn, tdegrade, tfaults, Method), _fresh_engine(net), params),
            ((jcnn, jdegrade, jfaults, JMethod),
             JEngine(jlenet5(), use_pallas=False), np_params)):
        cnn, deg, flt, meth = mods
        clock, extra = FakeClock(), dict(kw)
        if script is not None:
            extra["fault_injector"] = flt.FaultInjector(
                flt.FaultScript(**script), advance=clock.advance)
        if ladder is not None:
            extra["degrade"] = deg.DegradeController(
                deg.default_ladder(meth.ADVANCED_SIMD_8), **ladder)
        if supervisor is not None:
            extra["supervisor"] = cnn.SupervisorConfig(**supervisor)
        out.append((cnn.CNNServer(eng, p, clock=clock, sleep=FakeSleep(),
                                  **extra), cnn))
    return out


def _assert_same_serving(ours, theirs):
    assert set(ours.done) == set(theirs.done)
    for rid, a in ours.done.items():
        b = theirs.done[rid]
        assert type(a).__name__ == type(b).__name__, rid
        if isinstance(a, ImageResult):
            assert a.top_indices == b.top_indices, rid
            assert np.abs(np.asarray(a.top_probs)
                          - np.asarray(b.top_probs)).max() <= PROB_TOL
            assert (a.batch_size, a.bucket) == (b.batch_size, b.bucket)
        elif isinstance(a, ShedResult):
            assert (a.reason, a.waited_s) == (b.reason, b.waited_s)
        else:
            assert (a.error, a.batch_size, a.bucket) == (
                b.error, b.batch_size, b.bucket)
    assert ours.stats() == theirs.stats()
    assert [e["kind"] for e in ours.events] == [e["kind"]
                                                 for e in theirs.events]
    assert ours.health() == theirs.health()


def test_degrade_walk_matches_jax_server(lenet):
    """Ragged waves walk every rung of the default ladder: a wave below
    max_batch waits one step in the queue (pressure at queue_high=0),
    which moves the ladder one rung down before the wave is served; a
    full wave is served at once."""
    imgs = lenet[3]
    servers = _servers(lenet, ladder=dict(queue_high=0, degrade_after=1,
                                          cooldown=0),
                       max_batch=4, max_delay_s=1.0)
    rungs = {0: [], 1: []}
    rid = 0
    for wave in (4, 3, 1, 2, 4):
        for i, (srv, cnn) in enumerate(servers):
            for r in range(rid, rid + wave):
                srv.submit(cnn.ImageRequest(rid=r, image=imgs[r % 16]))
            if wave < 4:
                assert srv.step() == []     # queued: pressure moves a rung
            rungs[i].append(srv.health()["degrade"]["label"])
            srv.step(force=True)
        rid += wave
    assert rungs[0] == rungs[1] == [
        "advanced_simd_8/fused", "advanced_simd_4/fused",
        "basic_simd/fused", "basic_simd/unfused", "basic_simd/unfused"]
    (ours, _), (theirs, _) = servers
    assert ours.stats()["degraded"] == 3
    assert ours.engine.bucket_stats() == theirs.engine.bucket_stats()
    _assert_same_serving(ours, theirs)


def test_faults_match_jax_server(lenet):
    """Retry, bisection of a poison request, a corrupt output row and a
    latency spike under the same script give the same results, counters,
    fault events and server events."""
    imgs = lenet[3]
    servers = _servers(lenet, script=dict(
        transient_calls={0}, poison_rids={5}, corrupt_rids={2},
        latency_spikes={1: 0.25}), max_batch=4, max_delay_s=0.0)
    for srv, cnn in servers:
        for r in range(10):
            srv.submit(cnn.ImageRequest(rid=r, image=imgs[r], top_k=3))
        srv.run_until_drained()
    (ours, _), (theirs, _) = servers
    assert isinstance(ours.done[5], FailedResult)
    assert ours.done[2].error == "non_finite_output"
    assert ours.stats()["bisections"] >= 1 and ours.stats()["retried"] == 1
    assert ours.fault_injector.events == theirs.fault_injector.events
    _assert_same_serving(ours, theirs)


def test_breaker_and_deadlines_match_jax_server(lenet):
    """A failing batch trips the breaker (admission sheds), the half-open
    probe closes it, and requests queued past their deadline expire: the
    same trail on both servers."""
    imgs = lenet[3]
    servers = _servers(lenet, script=dict(persistent_calls={0, 1, 2}),
                       supervisor=dict(breaker_threshold=1,
                                       breaker_reset_s=2.0),
                       max_batch=2, max_delay_s=0.5, default_deadline_s=4.0)
    for srv, cnn in servers:
        for r in range(6):
            srv.submit(cnn.ImageRequest(rid=r, image=imgs[r]))
        srv.step(force=True)                # fails alone: breaker opens
        shed = srv.submit(cnn.ImageRequest(rid=6, image=imgs[6]))
        assert shed.reason == "breaker_open"
        srv.clock.t = 2.5                   # half-open probe succeeds
        srv.step()
        srv.clock.t = 5.0                   # the rest has expired
        srv.step()
        srv.run_until_drained()
    (ours, _), (theirs, _) = servers
    assert ours.stats()["expired"] >= 1 and ours.stats()["breaker_trips"] == 1
    _assert_same_serving(ours, theirs)

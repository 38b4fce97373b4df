"""The reference's scenarios of ``tests/test_serve_queue_batcher.py``, held against the
port: each test keeps its name there.

Serve-subsystem units: admission queue backpressure, schedulers,
bucketed packing, open-loop arrivals, and latency/goodput accounting."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import (AdmissionQueue, Completion, ContinuousBatcher,  # noqa: E402
                               DeadlineAware, FCFS, OpenLoopSource, Request,
                               ServeMetrics, ShortestJobFirst, default_schemes,
                               make_scheduler, pseudo_poisson_times,
                               substream_seed)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


# -- admission queue -----------------------------------------------------------

def test_submit_stamps_arrival_and_fifo_take():
    clock = FakeClock()
    q = AdmissionQueue(clock=clock)
    reqs = []
    for _ in range(3):
        r = Request()
        assert q.submit(r)
        reqs.append(r)
        clock.advance(1.0)
    assert [r.arrival_t for r in reqs] == [0.0, 1.0, 2.0]
    assert q.take(2) == reqs[:2]          # FIFO without a key
    assert len(q) == 1


def test_backpressure_rejects_at_capacity():
    q = AdmissionQueue(depth=2, policy="reject")
    a, b, c = Request(), Request(), Request()
    assert q.submit(a) and q.submit(b)
    assert not q.submit(c)                # full: newcomer refused
    assert c.shed
    stats = q.stats()
    assert stats["rejected"] == 1 and stats["accepted"] == 2
    assert stats["shed_errors"] == 0
    assert q.take(10) == [a, b]           # waiters untouched


def test_shed_oldest_drops_head_and_admits_newcomer():
    q = AdmissionQueue(depth=2, policy="shed-oldest")
    a, b, c = Request(), Request(), Request()
    q.submit(a), q.submit(b)
    assert q.submit(c)                    # admitted by shedding the oldest
    assert a.shed and not c.shed
    assert q.stats()["shed"] == 1
    assert q.take(10) == [b, c]


def test_on_shed_callback_errors_are_counted_not_raised():
    def boom(req):
        raise RuntimeError("shed handler bug")

    q = AdmissionQueue(depth=1, policy="reject", on_shed=boom)
    q.submit(Request())
    assert not q.submit(Request())        # must not raise
    assert q.stats()["shed_errors"] == 1


def test_closed_queue_rejects():
    q = AdmissionQueue()
    q.close()
    assert not q.submit(Request())
    assert q.stats()["rejected"] == 1


def test_take_orders_by_scheduler_key():
    def filled_queue():
        clock = FakeClock()
        q = AdmissionQueue(clock=clock)
        long_ = Request(max_new_tokens=50, prompt_tokens=1)
        short = Request(max_new_tokens=2, prompt_tokens=1)
        urgent = Request(max_new_tokens=20, deadline_s=0.5)
        for r in (long_, short, urgent):
            q.submit(r)
            clock.advance(0.1)
        return q, clock, long_, short, urgent

    # SJF: fewest remaining tokens first.
    q, clock, long_, short, urgent = filled_queue()
    assert q.take(3, key=ShortestJobFirst().key(clock())) == \
        [short, urgent, long_]
    # EDF: explicit deadline outranks the engine-wide default SLO.
    q, clock, long_, short, urgent = filled_queue()
    assert q.take(3, key=DeadlineAware().key(clock(), slo_s=10.0))[0] \
        is urgent
    # FCFS: arrival order.
    q, clock, long_, short, urgent = filled_queue()
    assert q.take(3, key=FCFS().key(clock())) == [long_, short, urgent]


def test_make_scheduler_names():
    assert isinstance(make_scheduler("fcfs"), FCFS)
    assert isinstance(make_scheduler("sjf"), ShortestJobFirst)
    assert isinstance(make_scheduler("deadline"), DeadlineAware)
    with pytest.raises(ValueError):
        make_scheduler("lifo")


# -- open-loop arrivals --------------------------------------------------------

def test_pseudo_poisson_deterministic_and_phased():
    a = pseudo_poisson_times([(1.0, 50.0), (1.0, 200.0)], seed=3)
    b = pseudo_poisson_times([(1.0, 50.0), (1.0, 200.0)], seed=3)
    assert a == b                                     # same seed, same load
    assert a == sorted(a) and a[-1] < 2.0
    lo = sum(1 for t in a if t < 1.0)
    hi = sum(1 for t in a if t >= 1.0)
    assert hi > 2 * lo                                # the ramp ramps


def test_pseudo_poisson_phase_rates_unbiased_at_boundaries():
    # Regression: the sampler used to carry a slow phase's overshoot
    # arrival into the next phase, so a fast phase following a slow one
    # started with an exponential gap drawn at the *slow* rate — shaving
    # a chunk off every fast phase's arrival count.  Each phase must
    # restart memorylessly at its own rate: per-phase counts then track
    # rate * duration, for fast phases preceded by slow ones too.
    phases = [(1.0, 2.0), (1.0, 40.0)] * 50   # slow on even s, fast on odd
    ts = pseudo_poisson_times(phases, seed=11)
    assert ts == sorted(ts) and ts[-1] < 100.0
    slow = sum(1 for t in ts if int(t) % 2 == 0)
    fast = sum(1 for t in ts if int(t) % 2 == 1)
    assert slow == pytest.approx(100, rel=0.35)    # nominal 2 * 50
    assert fast == pytest.approx(2000, rel=0.08)   # nominal 40 * 50
    # every fast phase gets arrivals — the carried-gap bug left phases
    # after a slow stretch starting empty for ~E[slow gap] seconds
    for k in range(1, 100, 2):
        assert any(k <= t < k + 1 for t in ts), f"fast phase {k} empty"


def test_substream_seed_deterministic_per_replica():
    # Same (root, replica) -> same seed; every replica gets a distinct
    # substream, so fleet schedules never replay each other's bursts.
    assert substream_seed(7, 0) == substream_seed(7, 0)
    assert substream_seed(7, "0") == substream_seed(7, "0")
    seeds = {substream_seed(7, i) for i in range(16)}
    assert len(seeds) == 16
    assert substream_seed(7, 1) != substream_seed(8, 1)   # root matters
    # and the substreams drive genuinely different arrival processes:
    a = pseudo_poisson_times([(1.0, 100.0)], seed=substream_seed(3, 1))
    b = pseudo_poisson_times([(1.0, 100.0)], seed=substream_seed(3, 2))
    assert a != b
    assert a == pseudo_poisson_times([(1.0, 100.0)],
                                     seed=substream_seed(3, 1))


def test_open_loop_source_pumps_due_arrivals_only():
    clock = FakeClock()
    q = AdmissionQueue(clock=clock)
    reqs = [Request() for _ in range(3)]
    src = OpenLoopSource(q, [(0.0, reqs[0]), (1.0, reqs[1]), (2.0, reqs[2])])
    assert src.pump(clock()) == 1
    assert src.pump(clock.advance(1.5)) == 1
    assert not src.exhausted
    assert src.next_due(clock()) == pytest.approx(0.5)
    assert src.pump(clock.advance(1.0)) == 1
    assert src.exhausted and src.next_due(clock()) is None
    assert len(q) == 3


# -- batcher -------------------------------------------------------------------

def test_default_schemes_shapes():
    schemes = default_schemes(64)
    assert schemes["single"] == (64,)
    assert schemes["pow2"] == (1, 2, 4, 8, 16, 32, 64)
    assert schemes["coarse"] == (16, 64)


def test_bucket_rounds_up_within_scheme():
    b = ContinuousBatcher(8)              # single/pow2/coarse over cap 8
    assert b.bucket(3, scheme="pow2") == 4
    assert b.bucket(8, scheme="pow2") == 8
    assert b.bucket(1, scheme="single") == 8


def test_scheme_validation():
    with pytest.raises(ValueError):
        ContinuousBatcher(8, schemes={"bad": (4,)})       # doesn't top out
    with pytest.raises(ValueError):
        ContinuousBatcher(8, schemes={"bad": (0, 8)})     # non-positive
    with pytest.raises(ValueError):
        ContinuousBatcher(8, scheme="nope")
    with pytest.raises(ValueError):
        ContinuousBatcher(0)


def test_pack_joins_in_scheduler_order_and_pads():
    clock = FakeClock()
    q = AdmissionQueue(clock=clock)
    short = Request(max_new_tokens=1)
    long_ = Request(max_new_tokens=99)
    q.submit(long_), q.submit(short)
    b = ContinuousBatcher(8, scheme="pow2")
    active = [Request(max_new_tokens=5)]
    batch = b.pack(active, q, ShortestJobFirst(), now=clock.advance(1.0))
    assert batch.requests == [active[0], short, long_]    # SJF joiners
    assert batch.joined == [short, long_]
    assert batch.size == 4 and batch.pad == 1             # 3 rows -> bucket 4
    assert short.service_t == 1.0 and long_.service_t == 1.0
    assert active[0].service_t is None                    # already in flight


def test_pack_respects_batch_cap():
    q = AdmissionQueue()
    for _ in range(10):
        q.submit(Request())
    b = ContinuousBatcher(4, scheme="single")
    batch = b.pack([], q, FCFS(), now=0.0)
    assert len(batch.requests) == 4 and batch.size == 4
    assert len(q) == 6                                    # rest keep waiting


def test_set_scheme_affects_future_packs_only():
    q = AdmissionQueue()
    b = ContinuousBatcher(8)
    b.set_scheme("pow2")
    q.submit(Request())
    first = b.pack([], q, FCFS(), now=0.0)
    assert first.size == 1
    b.set_scheme("single")                                # mid-stream re-tune
    second = b.pack(first.requests, q, FCFS(), now=0.0)
    assert second.requests == first.requests              # nothing dropped
    assert second.size == 8                               # only padding moved
    with pytest.raises(ValueError):
        b.set_scheme("nope")


# -- serve metrics -------------------------------------------------------------

def _completion(arrival, finish, tokens=5, deadline=None, default_slo=1.0):
    req = Request(max_new_tokens=tokens, deadline_s=deadline)
    req.arrival_t, req.service_t = arrival, arrival
    req.first_token_t, req.finish_t = finish, finish
    req.generated = tokens
    return Completion.from_request(req, default_slo_s=default_slo)


def test_metrics_slo_and_goodput_accounting():
    m = ServeMetrics(slo_s=1.0)
    m.observe(_completion(0.0, 0.5, tokens=4))            # within
    m.observe(_completion(0.0, 2.0, tokens=8))            # missed
    m.observe(_completion(0.0, 3.0, tokens=2, deadline=5.0))  # own SLO: ok
    s = m.summary()
    assert s["completed"] == 3 and s["completed_tokens"] == 14
    assert s["slo_met"] == 2 and s["slo_missed"] == 1
    assert s["goodput_tokens"] == 6                       # 4 + 2, not the miss


def test_metrics_percentiles_match_steptimer_convention():
    m = ServeMetrics()
    for latency in (0.1, 0.2, 0.3, 0.4, 1.0):
        m.observe(_completion(0.0, latency, default_slo=None))
    assert m.percentile(50) == pytest.approx(0.3)
    assert m.percentile(99) == pytest.approx(1.0)
    assert math.isnan(ServeMetrics().percentile(95))


def test_interval_goodput_reads_and_resets():
    clock = FakeClock(100.0)
    m = ServeMetrics(slo_s=10.0, clock=clock)
    m.observe(_completion(clock.t, clock.t + 1.0, tokens=30))
    clock.advance(2.0)
    assert m.interval_goodput() == pytest.approx(15.0)
    clock.advance(2.0)
    assert m.interval_goodput() == pytest.approx(0.0)     # window reset


def test_keyed_take_preserves_arrival_order_of_remainder():
    """After a scheduler-keyed take, shed-oldest must still drop the
    longest-waiting request, not whatever the sort left in front."""
    clock = FakeClock()
    q = AdmissionQueue(depth=3, policy="shed-oldest", clock=clock)
    oldest = Request(max_new_tokens=1)        # smallest SJF key, arrives 1st
    mid = Request(max_new_tokens=50)
    newest = Request(max_new_tokens=5)
    for r in (oldest, mid, newest):
        q.submit(r)
        clock.advance(1.0)
    taken = q.take(1, key=ShortestJobFirst().key(clock()))
    assert taken == [oldest]
    q.submit(taken[0])                        # refill to capacity
    overflow = Request(max_new_tokens=9)
    q.submit(overflow)                        # full: head-drop fires
    assert mid.shed                           # longest-waiting went, not SJF order
    assert q.take(10) == [newest, oldest, overflow]

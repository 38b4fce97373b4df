"""The reference's scenarios of ``tests/test_compile_service.py``, held against the
port: each test keeps its name there.

CompileService: priority ordering, dedup, stale cancellation, speculative
prefetch, and the activation-epoch guarantee (a superseded compile can never
overwrite a newer swap)."""
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (CompileService, ExhaustiveSweep, Explorer,  # noqa: E402
                              IridescentRuntime, PRIORITY_ACTIVATE,
                              PRIORITY_SPECULATIVE)


class _Blocker:
    """Build callable that blocks until released, recording execution order."""

    def __init__(self):
        self.gate = threading.Event()
        self.order: list[str] = []

    def build(self, tag, block=False):
        def fn():
            if block:
                assert self.gate.wait(timeout=30)
            self.order.append(tag)
            return tag
        return fn


def test_priority_activation_before_speculative():
    svc = CompileService(workers=1)
    b = _Blocker()
    try:
        svc.submit("h", "k0", {}, b.build("k0", block=True))
        # wait until the worker is busy so the next two really queue
        deadline = time.time() + 10
        while svc.stats()["running"] != 1 and time.time() < deadline:
            time.sleep(0.01)
        svc.submit("h", "spec", {}, b.build("spec"),
                   priority=PRIORITY_SPECULATIVE, speculative=True)
        svc.submit("h", "act", {}, b.build("act"),
                   priority=PRIORITY_ACTIVATE)
        b.gate.set()
        assert svc.drain(timeout=30)
        # activation enqueued later but outranks the speculative build
        assert b.order == ["k0", "act", "spec"]
    finally:
        svc.shutdown()


def test_dedup_coalesces_inflight_requests():
    svc = CompileService(workers=1)
    b = _Blocker()
    try:
        r1 = svc.submit("h", "busy", {}, b.build("busy", block=True))
        r2 = svc.submit("h", "k", {}, b.build("k"))
        r3 = svc.submit("h", "k", {}, b.build("k-dup"))
        assert r2 is r3                    # coalesced onto one request
        b.gate.set()
        assert svc.drain(timeout=30)
        assert b.order.count("k") == 1 and "k-dup" not in b.order
        assert r1.status == "done"
    finally:
        svc.shutdown()


def test_activation_promotes_pending_speculative():
    svc = CompileService(workers=1)
    b = _Blocker()
    try:
        svc.submit("h", "busy", {}, b.build("busy", block=True))
        deadline = time.time() + 10
        while svc.stats()["running"] != 1 and time.time() < deadline:
            time.sleep(0.01)
        s1 = svc.submit("h", "s1", {}, b.build("s1"),
                        priority=PRIORITY_SPECULATIVE, speculative=True)
        s2 = svc.submit("h", "s2", {}, b.build("s2"),
                        priority=PRIORITY_SPECULATIVE, speculative=True)
        # the policy selects s2: its pending speculative build is promoted
        p = svc.submit("h", "s2", {}, b.build("s2-dup"),
                       priority=PRIORITY_ACTIVATE)
        assert p is s2 and s2.priority == PRIORITY_ACTIVATE
        assert not s2.speculative
        b.gate.set()
        assert svc.drain(timeout=30)
        assert b.order.index("s2") < b.order.index("s1")
        assert s1.status == "done"
    finally:
        svc.shutdown()


def test_cancel_stale_pending():
    svc = CompileService(workers=1)
    b = _Blocker()
    try:
        svc.submit("h", "busy", {}, b.build("busy", block=True))
        deadline = time.time() + 10
        while svc.stats()["running"] != 1 and time.time() < deadline:
            time.sleep(0.01)
        stale = svc.submit("h", "stale", {}, b.build("stale"),
                           priority=PRIORITY_ACTIVATE)
        n = svc.cancel_pending("h", keep_keys={"other"},
                               max_priority=PRIORITY_ACTIVATE)
        assert n == 1
        assert stale.status == "cancelled" and stale.future.cancelled()
        b.gate.set()
        assert svc.drain(timeout=30)
        assert "stale" not in b.order
        assert svc.stats()["cancelled"] == 1
    finally:
        svc.shutdown()


def test_sync_mode_runs_inline_and_skips_speculation():
    svc = CompileService(workers=0)
    b = _Blocker()
    r = svc.submit("h", "k", {}, b.build("k"))
    assert r.status == "done" and b.order == ["k"]
    s = svc.submit("h", "s", {}, b.build("s"),
                   priority=PRIORITY_SPECULATIVE, speculative=True)
    assert s.status == "cancelled" and "s" not in b.order
    svc.shutdown()


def test_failed_build_propagates_and_unblocks():
    svc = CompileService(workers=1)
    try:
        def boom():
            raise RuntimeError("no")
        r = svc.submit("h", "k", {}, boom)
        with pytest.raises(RuntimeError):
            r.future.result(timeout=30)
        assert r.status == "failed"
        assert svc.drain(timeout=10)
    finally:
        svc.shutdown()


# --- runtime-level integration -------------------------------------------------

def _wait_running_config(svc, label, value, timeout=10.0) -> bool:
    """Poll until a build whose config[label] == value is running."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        with svc._lock:
            reqs = list(svc._inflight.values())
        if any(r.status == "running" and r.config.get(label) == value
               for r in reqs):
            return True
        time.sleep(0.01)
    return False


def _slow_builder_factory(slow_value, delay, built):
    def builder(spec):
        k = spec.enum("k", 1, (1, 2, 3))
        if k == slow_value:
            time.sleep(delay)
        built.append(k)
        return lambda x: x * k
    return builder


def test_explorer_speculative_prefetch_ordering():
    """The explorer's prefetch enqueues exactly the policy's upcoming
    candidates as speculative builds, and they execute in peek order."""
    rt = IridescentRuntime(async_compile=True, max_compile_workers=1)
    try:
        built: list = []
        gate = threading.Event()

        def builder(spec):
            # default 0 = the generic build; only candidate k=1 blocks
            k = spec.enum("k", 0, (1, 2, 3))
            if k == 1:
                assert gate.wait(timeout=30)
            built.append(k)
            return lambda x: x * k

        h = rt.register("m", builder)
        h(torch.tensor(2.0))
        policy = ExhaustiveSweep([{"k": 1}, {"k": 2}, {"k": 3}])
        upcoming = policy.peek(3)
        assert upcoming == [{"k": 1}, {"k": 2}, {"k": 3}]   # peek != consume
        Explorer(h, policy, dwell=50, wait_compiles=False, prefetch=2)
        # worker is stuck building k=1; k=2/k=3 must be queued speculatively
        assert _wait_running_config(rt.compile_service, "k", 1)
        with rt.compile_service._lock:
            pending = [r for r in rt.compile_service._inflight.values()
                       if r.status == "pending" and "k" in r.config]
        assert sorted(r.config["k"] for r in pending) == [2, 3]
        assert all(r.speculative for r in pending)
        gate.set()
        assert rt.compile_service.drain(timeout=60)
        assert [k for k in built if k not in (0, 1)] == [2, 3]   # peek order
    finally:
        gate.set()
        rt.shutdown()


def test_stale_activation_never_overwrites_newer_swap():
    """specialize(A) then specialize(B): if A's (slow) compile finishes
    after B's, A must not overwrite the active variant."""
    rt = IridescentRuntime(async_compile=True, max_compile_workers=2)
    try:
        built: list = []
        h = rt.register("m", _slow_builder_factory(2, 0.5, built))
        h(torch.tensor(2.0))
        h.specialize({"k": 2}, wait=False)      # slow build
        assert _wait_running_config(rt.compile_service, "k", 2)
        h.specialize({"k": 3}, wait=False)      # fast build, newer epoch
        assert rt.compile_service.drain(timeout=60)
        deadline = time.time() + 5
        while h.active_config().get("k") != 3 and time.time() < deadline:
            time.sleep(0.01)
        assert h.active_config().get("k") == 3
        assert 2 in built                        # A did finish compiling...
        assert float(h(torch.tensor(2.0))) == 6.0  # ...but B stays active
    finally:
        rt.shutdown()


def test_despecialize_honors_wait_and_cancels_pending():
    rt = IridescentRuntime(async_compile=True, max_compile_workers=1)
    try:
        built: list = []
        h = rt.register("m", _slow_builder_factory(2, 0.5, built))
        h(torch.tensor(2.0))
        h.specialize({"k": 2}, wait=False)      # starts the slow build
        h.specialize({"k": 3}, wait=False)      # queues behind it
        h.despecialize(wait=True)
        # wait=True: on return no build work remains for this handler,
        # pending requests were cancelled, and the in-flight compile that
        # completed during the drain did not overwrite the generic swap.
        stats = rt.compile_service.stats()
        assert stats["pending"] == 0 and stats["running"] == 0
        assert h.active_config() == {}
        assert 3 not in built                    # cancelled before building
        assert float(h(torch.tensor(2.0))) == 2.0
    finally:
        rt.shutdown()

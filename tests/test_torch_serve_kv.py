"""The reference's scenarios of ``tests/test_serve_kv.py``, held against the
port: each test keeps its name there.  The page tables' cache lives on the
CPU (``PagedKV(..., device="cpu")``).  The served tokens of the phased
executor are held to the reference's (its ``_serve`` on the same
requests), and the handler functions are the reference's written in
torch; the warm restart builds no variant (``xla_compiles`` counts the
port's variant builds).

Paged KV runtime + phase-disaggregated execution.

Covers the PR's serve-path invariants:

* page-allocator properties (hypothesis): no double free, no page ever
  shared between live requests, LIFO free-list reuse after retire,
* materialize/harvest round trips keep per-request state isolated,
* **determinism**: requests decoding interleaved through the phased
  executor produce exactly the tokens they produce when served alone
  (and the same under paged vs contiguous KV geometry),
* tuple context keys (``(phase, bucket)``) survive spec_state.json
  save -> restore losslessly, and a warm restart resumes distinct
  per-phase configs with zero XLA recompiles,
* schedulers account for remaining *prefill* in job size.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from hypothesis import given, settings, strategies as st  # noqa: E402
from test_serve_kv import _serve as _ref_serve  # noqa: E402

from repro_torch.checkpoint import restore_spec_state, save_spec_state  # noqa: E402
from repro_torch.core import IridescentRuntime  # noqa: E402
from repro_torch.core.runtime import decode_context_key, encode_context_key  # noqa: E402
from repro_torch.serve import (AdmissionQueue, ContinuousBatcher, DeadlineAware,  # noqa: E402
                               FCFS, PagedKV, PageError, PagePool, PhasedExecutor,
                               Request, ServeEngine, ServeMetrics,
                               ShortestJobFirst)
from repro_torch.training import phase_context_fn  # noqa: E402

MAX_LEN = 16
VOCAB = 7


def _template(width: int = 3):
    return {"k": torch.zeros((1, MAX_LEN, width), dtype=torch.float32),
            "state": torch.zeros((1, width), dtype=torch.float32),
            "tick": torch.zeros((), dtype=torch.float32)}


AXES = {"k": ("batch", "seq_kv", "model"),
        "state": ("batch", "model"),
        "tick": ()}


def make_kv(page_size=4, layout="paged", capacity=8 * MAX_LEN, width=3):
    return PagedKV(_template(width), AXES, max_len=MAX_LEN,
                   capacity_tokens=capacity, page_size=page_size,
                   layout=layout, device="cpu")


# -- page allocator properties --------------------------------------------------

@settings(max_examples=20)
@given(st.integers(1, 12), st.integers(1, 8))
def test_pool_allocs_are_unique_until_freed(num_pages, page_size):
    pool = PagePool(num_pages, page_size)
    got = [pool.alloc() for _ in range(num_pages)]
    assert sorted(got) == list(range(num_pages))   # each page handed out once
    with pytest.raises(PageError):
        pool.alloc()                               # exhausted
    for pid in got:
        pool.free(pid)
    assert pool.free_pages == num_pages


def test_pool_double_free_and_foreign_page_raise():
    pool = PagePool(4, 2)
    pid = pool.alloc()
    pool.free(pid)
    with pytest.raises(PageError):
        pool.free(pid)                             # double free
    with pytest.raises(PageError):
        pool.free(99)                              # never belonged here


def test_pool_free_list_reuse_is_lifo():
    pool = PagePool(8, 2)
    a, b = pool.alloc(), pool.alloc()
    pool.free(a)
    pool.free(b)
    assert pool.alloc() == b                       # most recently freed
    assert pool.alloc() == a


@settings(max_examples=15)
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(0, 2)),
                min_size=1, max_size=40))
def test_no_page_shared_between_live_requests(ops):
    """Random join/harvest/retire interleavings: live requests' page sets
    stay disjoint, and retiring everything returns every page."""
    kv = make_kv(page_size=4)
    live: dict[str, int] = {}                      # rid -> tokens written
    for slot, action in ops:
        rid = f"r{slot}"
        if rid not in live:
            kv.join(rid)
            live[rid] = 0
        elif action == 0 and live[rid] + 2 <= MAX_LEN:
            cache, lengths = kv.materialize([rid], 1)
            assert int(lengths[0]) == live[rid]
            kv.harvest([rid], cache, [2])
            live[rid] += 2
        elif action == 1:
            kv.retire(rid)
            del live[rid]
        tables = {r: kv.table(r) for r in live}
        owned = [p for t in tables.values() for p in t.pages]
        assert len(owned) == len(set(owned)), "page shared across requests"
    for rid in list(live):
        kv.retire(rid)
    for pool in kv.stats()["pools"].values():
        assert pool["live_pages"] == 0
        assert pool["allocs"] == pool["frees"]


def test_retired_pages_are_reused_by_next_join():
    kv = make_kv(page_size=4)
    kv.join("a")
    cache, _ = kv.materialize(["a"], 1)
    kv.harvest(["a"], cache, [8])                  # 2 pages
    pages_a = list(kv.table("a").pages)
    kv.retire("a")
    kv.join("b")
    cache, _ = kv.materialize(["b"], 1)
    kv.harvest(["b"], cache, [8])
    assert set(kv.table("b").pages) == set(pages_a)   # free list reused


def test_harvest_roundtrip_isolates_rows():
    """Distinct values written for interleaved requests come back on the
    right rows at the right slots — under both geometries."""
    for layout, page in (("paged", 4), ("contig", MAX_LEN)):
        kv = make_kv(page_size=page, layout=layout)
        kv.join("a")
        kv.join("b")
        for step in range(3):
            cache, lengths = kv.materialize(["a", "b"], 4)   # padded batch
            k = np.array(cache["k"])
            st_ = np.array(cache["state"])
            for row, base in ((0, 100.0), (1, 200.0)):
                assert int(lengths[row]) == step
                # history written in earlier steps is visible
                np.testing.assert_array_equal(
                    k[row, :step, 0], [base + s for s in range(step)])
                k[row, step] = base + step
                st_[row] = base + step
            kv.harvest(["a", "b"], {"k": torch.as_tensor(k),
                                    "state": torch.as_tensor(st_),
                                    "tick": cache["tick"]}, [1, 1])
        # per-row recurrent state tracked independently of the pages
        cache, _ = kv.materialize(["b", "a"], 2)    # reversed order
        assert np.asarray(cache["state"])[0, 0] == 202.0
        assert np.asarray(cache["state"])[1, 0] == 102.0


def test_join_live_and_overflow_raise():
    kv = make_kv(page_size=4, capacity=MAX_LEN)    # one request's worth
    kv.join("a")
    with pytest.raises(PageError):
        kv.join("a")                               # already live
    cache, _ = kv.materialize(["a"], 1)
    with pytest.raises(PageError):
        kv.harvest(["a"], cache, [MAX_LEN + 1])    # past max_len
    kv.harvest(["a"], cache, [MAX_LEN])            # exactly full is fine
    kv.join("b")
    cache, _ = kv.materialize(["b"], 1)
    with pytest.raises(PageError):                 # pool exhausted
        kv.harvest(["b"], cache, [1])


# -- phased executor determinism ------------------------------------------------

def _history_builder(spec):
    """Serve-contract handler whose next token is a deterministic function
    of the request's whole history: tokens+1 are written at their slots,
    and the logits peak at ``sum(written) mod VOCAB``.  Any cross-request
    page sharing, lost row state, or misplaced write changes the output
    stream."""

    def f(params, cache, tokens, pos, n_new):
        toks = tokens if tokens.ndim == 2 else tokens[:, None]
        c = toks.shape[1]
        k = cache["k"].clone()
        slots = torch.arange(k.shape[1])
        for t in range(c):
            at = (slots[None, :] == (pos + t)[:, None]) \
                & (t < n_new)[:, None]
            k[:, :, 0] = torch.where(
                at, (toks[:, t, None] + 1).to(k.dtype), k[:, :, 0])
        total = k[:, :, 0].sum(dim=1)
        peak = torch.remainder(total, float(VOCAB))
        logits = -(torch.arange(VOCAB)[None, :].to(torch.float32)
                   - peak[:, None]) ** 2
        return logits, {"k": k, "state": cache["state"] + 1.0,
                        "tick": cache["tick"]}

    return f


def _prompt_fn(req):
    return (np.arange(req.prompt_tokens, dtype=np.int32) * 3 + 1) % VOCAB


def _serve(reqs, layout="paged", bucket=2):
    rt = IridescentRuntime(async_compile=False)
    handler = rt.register("hist", _history_builder,
                          context_fn=phase_context_fn)
    kv = make_kv(page_size=4 if layout == "paged" else MAX_LEN,
                 layout=layout)
    executor = PhasedExecutor(handler, None, kv, prefill_chunk=2,
                              prompt_fn=_prompt_fn)
    engine = ServeEngine(handler, None,
                         ContinuousBatcher(bucket, scheme="single"),
                         FCFS(), executor=executor, queue=AdmissionQueue(),
                         metrics=ServeMetrics())
    for r in reqs:
        assert engine.submit(r)
    engine.run()
    rt.shutdown()
    return [list(r.payload) for r in reqs]


def test_interleaved_decode_matches_sequential():
    specs = [(5, 4), (3, 6), (7, 3)]               # (prompt, budget)
    together = _serve([Request(prompt_tokens=p, max_new_tokens=g)
                       for p, g in specs], bucket=2)
    alone = [_serve([Request(prompt_tokens=p, max_new_tokens=g)],
                    bucket=2)[0]
             for p, g in specs]
    assert together == alone
    assert together == _ref_serve([Request(prompt_tokens=p, max_new_tokens=g)
                                   for p, g in specs], bucket=2)
    for (p, g), out in zip(specs, together):
        assert len(out) == g
        assert all(0 <= t < VOCAB for t in out)


def test_paged_and_contig_geometries_decode_identically():
    specs = [(5, 4), (3, 6)]
    paged = _serve([Request(prompt_tokens=p, max_new_tokens=g)
                    for p, g in specs], layout="paged")
    contig = _serve([Request(prompt_tokens=p, max_new_tokens=g)
                     for p, g in specs], layout="contig")
    assert paged == contig
    assert paged == _ref_serve([Request(prompt_tokens=p, max_new_tokens=g)
                                for p, g in specs], layout="contig")


def test_executor_rejects_requests_that_cannot_fit():
    rt = IridescentRuntime(async_compile=False)
    handler = rt.register("hist", _history_builder,
                          context_fn=phase_context_fn)
    executor = PhasedExecutor(handler, None, make_kv(), prefill_chunk=2,
                              prompt_fn=_prompt_fn)
    with pytest.raises(ValueError):
        executor.ensure_joined(Request(prompt_tokens=MAX_LEN,
                                       max_new_tokens=1))
    rt.shutdown()


# -- tuple context keys: lossless persistence ----------------------------------

@settings(max_examples=20)
@given(st.tuples(st.sampled_from(["prefill", "decode"]),
                 st.integers(1, 128)))
def test_phase_context_key_roundtrip(key):
    enc = encode_context_key(key)
    assert decode_context_key(enc) == key
    assert encode_context_key(decode_context_key(enc)) == enc


@pytest.mark.parametrize("key", [
    ("prefill", 8),
    ("decode", 1),
    (("nested", 2), "x"),
    ("mixed", 3, True, None),
    (),
])
def test_tuple_context_key_roundtrip_cases(key):
    enc = encode_context_key(key)
    assert decode_context_key(enc) == key
    assert encode_context_key(decode_context_key(enc)) == enc


def _phase_toy_builder(spec):
    scale = spec.enum("scale", 1, (1, 2), guarded=False)

    def f(params, cache, tokens, pos, n_new):
        toks = tokens if tokens.ndim == 2 else tokens[:, None]
        return toks.sum(dim=1).to(torch.float32) * float(scale), cache

    return f


def _phase_calls(handler):
    cache = torch.zeros((2, 4), dtype=torch.float32)
    pos = torch.zeros((2,), dtype=torch.int32)
    handler(None, cache, torch.zeros((2, 4), dtype=torch.int32), pos,
            torch.full((2,), 4, dtype=torch.int32))        # ('prefill', 2)
    handler(None, cache, torch.zeros((2,), dtype=torch.int32), pos,
            torch.ones((2,), dtype=torch.int32))           # ('decode', 2)


def test_per_phase_configs_warm_restart_zero_recompiles(tmp_path):
    """ISSUE acceptance: distinct per-(phase, bucket) configs persist
    through spec_state.json v2 tuple keys and come back on a warm restart
    without a single XLA recompile."""
    cache_dir = str(tmp_path / "state")
    state_path = os.path.join(cache_dir, "spec_state.json")
    variants = os.path.join(cache_dir, "variants")

    rt = IridescentRuntime(async_compile=False, variant_cache=variants)
    handler = rt.register("phase_toy", _phase_toy_builder,
                          context_fn=phase_context_fn)
    _phase_calls(handler)                              # materialize contexts
    handler.specialize({"scale": 2}, context=("prefill", 2), wait=True)
    handler.specialize({"scale": 1}, context=("decode", 2), wait=True)
    _phase_calls(handler)
    assert rt.compile_stats()["xla_compiles"] > 0
    save_spec_state(state_path, rt)
    rt.shutdown()

    rt2 = IridescentRuntime(async_compile=False, variant_cache=variants)
    handler2 = rt2.register("phase_toy", _phase_toy_builder,
                            context_fn=phase_context_fn)
    assert restore_spec_state(state_path, rt2, wait=True)
    _phase_calls(handler2)                             # traffic re-seeds
    assert handler2.active_config(
        context=("prefill", 2))["scale"] == 2
    assert handler2.active_config(
        context=("decode", 2))["scale"] == 1
    stats = rt2.compile_stats()
    assert stats["xla_compiles"] == 0, f"warm restart recompiled: {stats}"
    assert stats["cache_hits"] > 0
    rt2.shutdown()


# -- schedulers: job size includes remaining prefill ---------------------------

def _mk(prompt, budget, consumed=0, generated=0, arrival=0.0, deadline=None):
    r = Request(prompt_tokens=prompt, max_new_tokens=budget,
                deadline_s=deadline)
    r.arrival_t = arrival
    r.prompt_consumed = consumed
    r.generated = generated
    return r


def test_sjf_counts_remaining_prefill_as_work():
    long_prompt = _mk(2048, 4)                     # huge prefill ahead
    short_prompt = _mk(16, 32)
    key = ShortestJobFirst().key(now=0.0)
    assert key(short_prompt) < key(long_prompt)    # 48 < 2052
    assert long_prompt.remaining_work == 2052
    assert short_prompt.remaining_work == 48


def test_sjf_mid_stream_prefill_progress_reorders():
    half_done = _mk(100, 10, consumed=90, generated=0)    # 20 left
    fresh = _mk(40, 10)                                   # 50 left
    key = ShortestJobFirst().key(now=0.0)
    assert key(half_done) < key(fresh)


def test_legacy_executor_requests_fall_back_to_decode_budget():
    # A legacy (non-phased) executor never advances prompt_consumed; once
    # decoding, the prompt must not be double-counted as pending work.
    legacy = _mk(100, 10, consumed=0, generated=4)
    assert legacy.remaining_prefill == 0
    assert legacy.remaining_work == 6


def test_deadline_aware_breaks_ties_by_remaining_work():
    urgent_big = _mk(200, 8, arrival=0.0, deadline=1.0)
    urgent_small = _mk(10, 8, arrival=0.0, deadline=1.0)
    relaxed = _mk(1, 1, arrival=0.0, deadline=9.0)
    key = DeadlineAware().key(now=0.0)
    order = sorted([relaxed, urgent_big, urgent_small], key=key)
    assert order == [urgent_small, urgent_big, relaxed]

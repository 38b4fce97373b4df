"""The reference's scenarios of ``tests/test_system.py``, held against the
port: each test keeps its name there.  End-to-end behaviour of the
paper's system: the full Iridescent loop (declare space -> explore online
-> exploit -> adapt) driving real handlers, plus guard-corrected serving,
whose outputs are held to the reference's generic function on the same
numpy inputs.  The fast-path table is built on the CPU (``device="cpu"``).

``test_checkpoint_restart_training`` is ported in
``tests/test_torch_train_data.py`` (same name), with the restart across
the two packages.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core import (ChangeDetector, ExhaustiveSweep,  # noqa: E402
                              Explorer, IridescentRuntime, Phase)
from repro_torch.core.fastpath import build_table, make_fastpath  # noqa: E402


def test_full_loop_converges_and_adapts():
    """The paper's Fig 2/7 scenario in miniature: a handler whose optimal
    configuration depends on the workload; the explorer finds the optimum,
    then re-explores after a workload change."""
    rt = IridescentRuntime(async_compile=False)

    def build(spec):
        b = spec.enum("B", 1, (1, 4))

        def handler(x):
            return (x * b).sum()

        return handler

    h = rt.register("h", build)
    x = np.ones(8, np.float32)
    assert float(h(torch.from_numpy(x))) == float((jnp.asarray(x) * 1).sum())

    # synthetic metric: config B=4 is 3x "faster" in workload phase 0,
    # B=1 wins in phase 1 (emulates Table 1's hw/workload dependence).
    phase = {"v": 0}

    def metric():
        b = h.active_config().get("B", 1)
        speed = {0: {1: 1.0, 4: 3.0}, 1: {1: 5.0, 4: 0.5}}
        return speed[phase["v"]].get(b if b else 1, 1.0)

    ex = Explorer(h, ExhaustiveSweep.from_space(h.spec_space(), ["B"]),
                  dwell=3, metric_fn=metric,
                  change_detector=ChangeDetector(0.25, warmup=0))
    for _ in range(40):
        h(torch.from_numpy(x))
        ex.step()
    assert ex.phase is Phase.EXPLOIT
    assert h.active_config()["B"] == 4
    assert float(h(torch.from_numpy(x))) == float((jnp.asarray(x) * 4).sum())

    phase["v"] = 1   # workload change -> metric drops -> re-explore
    for _ in range(80):
        h(torch.from_numpy(x))
        ex.step()
    assert ex.explorations >= 1
    assert h.active_config()["B"] == 1
    rt.shutdown()


def test_guarded_specialization_serving():
    """Fast-path-specialized lookup handler stays correct on misses and the
    policy can read the instrumentation statistics (paper §5 two phases)."""
    rt = IridescentRuntime(async_compile=False)

    def generic(xb):
        xb = torch.atleast_2d(xb)
        return (xb.to(torch.float32) * 2 + 1).sum(-1, keepdim=True)

    def ref_generic(xb):
        xb = jnp.atleast_2d(xb)
        return (xb.astype(jnp.float32) * 2 + 1).sum(-1, keepdims=True)

    rt.add_custom_spec(
        "fastpath",
        lambda payload: make_fastpath(
            generic, payload, skip_generic_when_all_hit=True, device="cpu"))

    def build(spec):
        fp = spec.custom("hot", "fastpath")
        return fp if fp is not None else generic

    h = rt.register("lookup", build)
    keys = np.array([[3], [9], [40]], np.int64)
    x = torch.from_numpy(keys)
    expect = np.asarray(ref_generic(jnp.asarray(keys)))
    np.testing.assert_allclose(h(x).numpy(), expect)

    # instrumentation phase -> build table -> specialize (paper §5 phases)
    h.enable_instrumentation(rate=1.0, collectors={
        "hot": lambda a, k: int(np.asarray(a[0])[0, 0])})
    for _ in range(5):
        h(x)
    tbl = build_table(h.spec_space().observed, "hot", n=2,
                      generic_fn=generic, device="cpu")
    assert tbl is not None
    h.disable_instrumentation()
    h.specialize({"hot": tbl}, wait=True)
    np.testing.assert_allclose(h(x).numpy(), expect)  # hits + misses right
    rt.shutdown()

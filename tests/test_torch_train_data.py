"""The training side around the step, on the CPU: the port's ``SyntheticLM``
against the reference's (tests/test_checkpoint_data.py's three cases, the
batches bit for bit, placement and prefetch), the
tests/test_system.py::test_checkpoint_restart_training sequence on the
port, a train state crossing between the packages through each one's
``CheckpointManager`` both ways (params, m, v, count and the int8 error
feedback) and continuing to the same loss within 1e-5, the training CLI
(it raises without a card unless ``--device cpu`` is given; resumes the
stream, the optimizer and the tuned configuration from ``--ckpt``) and
``examples/moe_exploration_torch.py``.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro import checkpoint as ref_checkpoint  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.core.specializer import specialize_builder as ref_specialize  # noqa: E402
from repro.data import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.models import transformer as ref_model  # noqa: E402
from repro.training import steps as ref_steps  # noqa: E402
from repro_torch import compat, configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.specializer import specialize_builder  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import transformer as model  # noqa: E402
from repro_torch.models import train_state_from_numpy  # noqa: E402
from repro_torch.optim import OptConfig, init_opt_state  # noqa: E402
from repro_torch.training import make_train_builder  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = 1e-5


# -- SyntheticLM -------------------------------------------------------------------

def test_determinism_and_restart():
    ds1 = SyntheticLM(vocab_size=1000, batch=4, seq_len=16, seed=3,
                      prefetch=0, device="cpu")
    b5 = ds1.batch_at(5)
    # restart from checkpointed step: identical stream
    ds2 = SyntheticLM(vocab_size=1000, batch=4, seq_len=16, seed=3,
                      start_step=5, prefetch=0, device="cpu")
    b5b = next(iter(ds2))
    np.testing.assert_array_equal(b5["tokens"], b5b["tokens"].numpy())


def test_labels_are_shifted_tokens():
    ds = SyntheticLM(vocab_size=100, batch=2, seq_len=8, seed=0, prefetch=0,
                     device="cpu")
    b = ds.batch_at(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_zipf_skew():
    ds = SyntheticLM(vocab_size=1000, batch=64, seq_len=64, seed=0,
                     prefetch=0, device="cpu")
    toks = ds.batch_at(0)["tokens"].ravel()
    # Zipf: the most common token should be much more frequent than median
    counts = np.bincount(toks, minlength=1000)
    assert counts.max() > 20 * max(np.median(counts), 1)


@pytest.mark.parametrize("embeds_dim", [None, 8])
def test_batches_are_the_references_bit_for_bit(embeds_dim):
    kw = dict(vocab_size=5000, batch=3, seq_len=24, seed=11,
              embeds_dim=embeds_dim, prefetch=0)
    ref, port = RefSyntheticLM(**kw), SyntheticLM(**kw, device="cpu")
    for step in (0, 1, 77):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_prefetched_stream_is_placed_and_in_order():
    ds = SyntheticLM(vocab_size=300, batch=2, seq_len=8, seed=4,
                     start_step=2, prefetch=2, embeds_dim=4, device="cpu")
    it = iter(ds)
    for step in (2, 3, 4):
        b = next(it)
        want = ds.batch_at(step)
        for k, v in b.items():
            assert v.device.type == "cpu" and v.is_contiguous()
            np.testing.assert_array_equal(v.numpy(), want[k])
    assert ds.state()["seed"] == 4 and ds.state()["step"] >= 5


def test_stream_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(vocab_size=10, batch=1, seq_len=4)


# -- restart -----------------------------------------------------------------------

def test_checkpoint_restart_training(tmp_path):
    """Fault tolerance: kill/restart mid-training resumes identically."""
    cfg = configs.get_reduced("qwen3-0.6b").replace(compute_dtype="float32")
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    step = specialize_builder(make_train_builder(cfg, opt_cfg), {}).fn
    ds = SyntheticLM(cfg.vocab_size, batch=2, seq_len=16, seed=1, prefetch=0,
                     device="cpu")

    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    mgr = CheckpointManager(str(tmp_path), keep=2)

    for i in range(4):
        state, _ = step(state, ds.place(ds.batch_at(i)))
    mgr.save(4, state, extra_meta={"data_step": 4}, block=True)
    for i in range(4, 6):
        state, m = step(state, ds.place(ds.batch_at(i)))
    loss_direct = float(m["loss"])

    # "crash" -> restore -> replay
    restored, meta = mgr.restore(state)
    st2 = restored
    for i in range(meta["data_step"], 6):
        st2, m2 = step(st2, ds.place(ds.batch_at(i)))
    assert abs(float(m2["loss"]) - loss_direct) < 1e-5
    for a, b in zip(compat.tree_leaves(state["params"]),
                    compat.tree_leaves(st2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


@pytest.fixture(scope="module")
def cross():
    """Both packages' steps (int8 error feedback on) and the reference's
    state after two steps on SyntheticLM's stream."""
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50, compress="int8_ef")
    ref_cfg = ref_configs.get_reduced("qwen3-0.6b").replace(
        compute_dtype="float32")
    cfg = configs.get_reduced("qwen3-0.6b").replace(compute_dtype="float32")
    ref_opt = ref_optim.OptConfig(**kw)
    ref_step = jax.jit(ref_specialize(ref_steps.make_train_builder(
        ref_cfg, ref_opt, kernel_impl="xla"), {}).fn)
    step = specialize_builder(make_train_builder(cfg, OptConfig(**kw)),
                              {}).fn
    ds = RefSyntheticLM(cfg.vocab_size, batch=2, seq_len=16, seed=1,
                        prefetch=0)
    params = ref_model.init_params(jax.random.PRNGKey(0), ref_cfg)
    state = {"params": params, "opt": ref_optim.init_opt_state(params,
                                                               ref_opt)}
    for i in range(2):
        state, _ = ref_step(state, ds.batch_at(i))
    return dict(ref_step=ref_step, step=step, ds=ds, ref_state=state)


def _port_template(np_state):
    return train_state_from_numpy(
        jax.tree_util.tree_map(np.zeros_like, np_state), "cpu")


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_reference_train_state_continues_in_the_port(tmp_path, cross):
    ref_checkpoint.CheckpointManager(str(tmp_path), async_save=False).save(
        2, cross["ref_state"], extra_meta={"data_step": 2})
    np_state = jax.tree_util.tree_map(np.asarray, cross["ref_state"])
    state, meta = CheckpointManager(str(tmp_path)).restore(
        _port_template(np_state))
    assert state["opt"]["count"].dtype == torch.int32
    assert int(state["opt"]["count"]) == 2 and "ef" in state["opt"]
    for want, got in zip(jax.tree_util.tree_leaves(np_state),
                         compat.tree_leaves(state)):
        np.testing.assert_array_equal(got.numpy(), want)     # bit-equal
    ref_state = cross["ref_state"]
    for i in range(meta["data_step"], 4):
        batch = cross["ds"].batch_at(i)
        ref_state, rm = cross["ref_step"](ref_state, batch)
        state, m = cross["step"](state, _port_batch(batch))
    assert abs(float(m["loss"]) - float(rm["loss"])) < LOSS_TOL


def test_port_train_state_continues_in_the_reference(tmp_path, cross):
    np_state = jax.tree_util.tree_map(np.asarray, cross["ref_state"])
    state = train_state_from_numpy(np_state, "cpu")
    batch = cross["ds"].batch_at(2)
    state, _ = cross["step"](state, _port_batch(batch))  # the port's step 3
    CheckpointManager(str(tmp_path), async_save=False).save(
        3, state, extra_meta={"data_step": 3})
    ref_state, meta = ref_checkpoint.CheckpointManager(str(tmp_path)).restore(
        cross["ref_state"])
    assert int(ref_state["opt"]["count"]) == 3
    assert np.asarray(ref_state["opt"]["count"]).dtype == np.int32
    for want, got in zip(compat.tree_leaves(state),
                         jax.tree_util.tree_leaves(ref_state)):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    for i in range(meta["data_step"], 5):
        batch = cross["ds"].batch_at(i)
        ref_state, rm = cross["ref_step"](ref_state, batch)
        state, m = cross["step"](state, _port_batch(batch))
    assert abs(float(m["loss"]) - float(rm["loss"])) < LOSS_TOL


# -- the CLI and the examples --------------------------------------------------------

def test_cli_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--steps", "1"])


def test_cli_resumes_from_ckpt(tmp_path, capsys):
    argv = ["--device", "cpu", "--batch", "4", "--seq", "16", "--explore",
            "--dwell", "1", "--ckpt-every", "10", "--ckpt", str(tmp_path)]
    train_cli.main(argv + ["--steps", "20"])
    first = capsys.readouterr().out
    assert "resumed" not in first and "best config" in first
    assert (tmp_path / "spec_state.json").is_file()
    train_cli.main(argv + ["--steps", "22"])
    second = capsys.readouterr().out
    assert "resumed from step 20" in second
    assert "restored tuned config: {" in second
    assert "step   21 loss=" in second


def test_moe_exploration_example_selects_a_dispatch():
    spec = importlib.util.spec_from_file_location(
        "_moe_exploration_torch", ROOT / "examples" / "moe_exploration_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--device", "cpu", "--steps", "14", "--dwell", "2"])
    assert out["settled"]
    assert out["selected"]["moe_impl"] in ("einsum", "gather")
    assert out["selected"]["moe_ranking"] in ("cumsum", "sort")
    assert all(np.isfinite(out["losses"]))


@pytest.mark.parametrize("scale", ["2m", "25m", "100m"])
def test_small_lm_sizes(scale):
    """The reference's sizes; ``100m`` takes its own vocab (the reference
    passes ``vocab_size`` twice there and raises)."""
    cfg = train_cli.small_lm(scale)
    assert cfg.name == f"lm-{scale}" and cfg.compute_dtype == "float32"
    assert cfg.vocab_size == (16384 if scale == "100m" else 8192)
    if scale != "100m":
        from repro.launch import train as ref_train
        ref = ref_train.small_lm(scale)
        assert ref.__dict__ == cfg.__dict__

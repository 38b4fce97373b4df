"""The reference's scenarios of ``tests/test_core_points.py``, held against the
port: each test keeps its name there.

Specialization points / space unit + property tests."""
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, strategies as st  # noqa: E402

from repro_torch.core import (DISABLED, EnumPoint, RangePoint,  # noqa: E402
                              cartesian, config_key)
from repro_torch.core.specializer import (  # noqa: E402
    discover_space, specialize_builder)


def _builder(spec):
    b = spec.enum("B", 8, (2, 4, 8))
    n = spec.generic("N", None, guard=lambda a, k, v: a[0] == v)
    flag = spec.assume("flag", guard=lambda a, k, v: a[0] > 0)

    def fn(x):
        return (x, b, n, flag)

    return fn


def test_discover_space():
    space = discover_space(_builder)
    assert set(space.labels()) == {"B", "N", "flag"}
    assert space["B"].candidates() == (2, 4, 8)
    assert space.default_config() == {"B": DISABLED, "N": DISABLED,
                                      "flag": DISABLED}


def test_specialize_binds_constants_and_guards():
    s = specialize_builder(_builder, {"B": 4, "N": 7, "flag": True})
    x, b, n, flag = s.fn(7)
    assert (b, n, flag) == (4, 7, True)
    assert s.check_guards((7,), {})
    assert not s.check_guards((8,), {})   # N guard fails
    assert not s.check_guards((-7,), {})  # would need N=-7; flag guard fails


def test_disabled_points_keep_generic():
    s = specialize_builder(_builder, {})
    _, b, n, flag = s.fn(1)
    assert (b, n, flag) == (8, None, False)
    assert s.guards == []


def test_validation_rejects_bad_values():
    space = discover_space(_builder)
    with pytest.raises(ValueError):
        space.validate({"B": 3})
    with pytest.raises(KeyError):
        space.validate({"nope": 1})


def test_configs_enumeration_and_cartesian():
    space = discover_space(_builder)
    cfgs = space.configs(labels=["B"])
    assert len(cfgs) == 3
    prod = cartesian(cfgs, [{"N": 1}, {"N": 2}])
    assert len(prod) == 6
    assert all("N" in c and "B" in c for c in prod)


def test_redeclaration_same_shape_ok():
    def b2(spec):
        for _ in range(3):  # loop declaration with fresh lambdas
            v = spec.enum("x", 1, (1, 2), guard=lambda a, k, val: True)
        return lambda: v
    s = specialize_builder(b2, {"x": 2})
    assert s.fn() == 2
    assert len(s.guards) == 1  # deduped


def test_redeclaration_different_shape_fails():
    def b3(spec):
        spec.enum("x", 1, (1, 2))
        spec.enum("x", 1, (1, 2, 3))
        return lambda: None
    with pytest.raises(ValueError):
        specialize_builder(b3, {})


@given(st.dictionaries(st.sampled_from(["a", "b", "c"]),
                       st.integers(-5, 5), min_size=1))
def test_config_key_is_order_insensitive(d):
    items = list(d.items())
    assert config_key(dict(items)) == config_key(dict(reversed(items)))


@given(st.lists(st.integers(0, 100), min_size=1, max_size=8, unique=True))
def test_enum_candidates_roundtrip(choices):
    p = EnumPoint("x", choices[0], choices=tuple(choices))
    assert list(p.candidates()) == choices
    assert all(p.validate(c) for c in choices)
    assert not p.validate(max(choices) + 1)


@given(st.integers(0, 20), st.integers(0, 20))
def test_range_point(lo, extra):
    hi = lo + extra
    p = RangePoint("r", lo, lo=lo, hi=hi)
    cands = p.candidates()
    assert cands[0] == lo and cands[-1] == hi
    assert len(cands) == extra + 1


@pytest.mark.parametrize("step", [0, -1, -0.5, None])
def test_range_point_nonpositive_step_rejected(step):
    """Regression: step <= 0 used to make candidates() loop forever; it
    must be rejected at construction with a clear error."""
    with pytest.raises(ValueError, match="step > 0"):
        RangePoint("r", 0, lo=0, hi=8, step=step)


def test_range_point_fractional_step_ok():
    p = RangePoint("r", 0.0, lo=0.0, hi=1.0, step=0.5)
    assert list(p.candidates()) == [0.0, 0.5, 1.0]


def test_spec_ctx_range_nonpositive_step_rejected():
    def b(spec):
        spec.range("r", 1, 1, 8, step=0)
        return lambda: None
    with pytest.raises(ValueError, match="step > 0"):
        specialize_builder(b, {})

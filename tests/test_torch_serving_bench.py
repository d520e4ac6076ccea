"""``examples/serving_bench_torch.py`` (the port's serving and fleet
benchmark) against the JAX package's ``benchmarks/serving_bench.py`` at
``SCALE = 1.0``: its tables, and each of the four sections
(``db_serving``, ``db_multiclass``, ``dispatch_fleet``,
``straggler_training``) row for row; and ``chip_smoke.py``'s
``FLEET_DIGESTS``, to which the card's run holds the port's rows, are the
digests of the reference's rows.  Tolerance: exact equality (every
value's ``repr``: NaN as NaN, and the types)."""

import functools
import importlib.util
import sys
from pathlib import Path

import pytest

from benchmarks import serving_bench as jsb

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PORT = _load("serving_bench_torch")


@functools.lru_cache(maxsize=None)
def reference_rows(section: str) -> list:
    assert jsb.SCALE == 1.0
    return jsb.ALL[section]()


def test_tables_are_the_references():
    assert list(PORT.ALL) == list(jsb.ALL)
    assert PORT.ENGINE_POLICIES == jsb.ENGINE_POLICIES
    assert PORT.LOAD_FRACS == jsb.LOAD_FRACS
    assert PORT.DISPATCH_CAPACITY_RPS == jsb.DISPATCH_CAPACITY_RPS
    assert PORT.SCALE == jsb.SCALE == 1.0
    assert PORT.DB_SLO_TTFT == jsb.DB_SLO_TTFT
    assert PORT.DISPATCH_POLICIES == jsb.DISPATCH_POLICIES


@pytest.mark.parametrize("section", list(jsb.ALL))
def test_section_rows_are_the_references(section):
    got, want = PORT.ALL[section](), reference_rows(section)
    assert [r["name"] for r in got] == [r["name"] for r in want]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert repr(g[k]) == repr(w[k]), (w["name"], k)
    assert PORT.rows_digest(got) == cs.FLEET_DIGESTS[section]


@pytest.mark.parametrize("section", list(jsb.ALL))
def test_fleet_digests_are_the_references(section):
    assert PORT.rows_digest(reference_rows(section)) == \
        cs.FLEET_DIGESTS[section]
    assert set(cs.FLEET_DIGESTS) == set(jsb.ALL)

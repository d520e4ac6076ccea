"""The port's multi-class clients (``workloads/clients.py``) and trace
files against the JAX package's: class ids, core assignment (and every
error), ``amp_config``'s per-core columns, ``multiclass_workload`` +
``metrics_by_class`` through the port's serving engine, multi-class
``traces.generate`` and the npz ``save`` / ``load`` in both directions.
Tolerance: exact equality (the same counter-based draws and numpy
code)."""

import dataclasses
import math

import numpy as np
import pytest

from repro.core import simlock as rsl
from repro.serving import engine as je
from repro.workloads import clients as jc
from repro.workloads import generators as jg
from repro.workloads import traces as jt
from repro_torch import workloads as tw
from repro_torch.core import simlock as sl
from repro_torch.serving import engine as te
from repro_torch.workloads import clients as tc
from repro_torch.workloads import generators as tg
from repro_torch.workloads import traces as tt

BIG = (1, 1, 1, 1, 0, 0, 0, 0)
# Mixes as (name, weight, slo, service kwargs or None, affinity).
MIXES = {
    "amp": (("lc", 1.0, 50.0, None, "big"),
            ("be", 1.0, 500.0, dict(dist="bimodal", mix=0.3), "little")),
    "weighted": (("lc", 3.0, 0.5, dict(dist="lognormal", mean=0.1, cv=1.0),
                  "any"),
                 ("be", 1.0, 5.0, dict(dist="exp", mean=0.3), "any")),
    "three": (("a", 1.0, 20.0, None, "little"),
              ("b", 2.0, math.inf, dict(dist="exp"), "any"),
              ("c", 0.5, 80.0, dict(dist="det", mean=2.0), "big")),
    "affine only": (("x", 1.0, 10.0, None, "big"),
                    ("y", 5.0, 90.0, None, "big")),
}


def mix(pkg, name):
    c, g = pkg
    return c.WorkloadMix(tuple(
        c.ClientClass(n, w, s, g.ServiceSpec(**svc) if svc else
                      g.ServiceSpec(), a) for n, w, s, svc, a in MIXES[name]))


J, T = (jc, jg), (tc, tg)


def test_exported_as_the_reference_exports_them():
    assert tw.ClientClass is tc.ClientClass
    assert tw.WorkloadMix is tc.WorkloadMix and tw.Trace is tt.Trace


@pytest.mark.parametrize("name", list(MIXES))
def test_class_ids_probs_and_slos(name):
    a, b = mix(J, name), mix(T, name)
    for n, seed in ((1, 0), (257, 3), (5000, 11)):
        x, y = a.class_ids(n, seed), b.class_ids(n, seed)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    assert a.probs().tobytes() == b.probs().tobytes()
    assert a.slos().tobytes() == b.slos().tobytes()


@pytest.mark.parametrize("name", list(MIXES))
@pytest.mark.parametrize("big", [BIG, (1, 0) * 4, (0, 1, 1, 0, 0, 1),
                                 (1,) * 8])
def test_assign_cores(name, big):
    def run(pkg):
        try:
            return pkg[0].assign_cores(mix(pkg, name), big)
        except ValueError as e:
            return str(e)
    a, b = run(J), run(T)
    assert type(a) is type(b)
    if isinstance(a, str):
        assert a == b
    else:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_every_error():
    """Bad affinity, a weight that is not positive, an empty mix, and an
    affinity no core can meet: raised alike."""
    for pkg in (J, T):
        c = pkg[0]
        with pytest.raises(ValueError, match="bad affinity 'middle'"):
            c.ClientClass("x", affinity="middle")
        for w in (0.0, -1.0):
            with pytest.raises(ValueError, match="weight must be positive"):
                c.ClientClass("x", weight=w)
        with pytest.raises(ValueError, match="empty mix"):
            c.WorkloadMix(())
        m = c.WorkloadMix((c.ClientClass("lc", affinity="big"),))
        with pytest.raises(ValueError,
                           match="'lc' wants big cores but none are left"):
            c.assign_cores(m, (0, 0, 0, 0))


@pytest.mark.parametrize("name", ["amp", "three", "weighted"])
@pytest.mark.parametrize("base_slo", [50.0, 7.5])
def test_amp_config_columns(name, base_slo):
    kw = dict(policy="libasl", wl=True, sim_time_us=2000.0, big=BIG)
    cfg, assign = tc.amp_config(sl.SimConfig(**kw), mix(T, name), base_slo)
    rcfg, rassign = jc.amp_config(rsl.SimConfig(**kw), mix(J, name),
                                  base_slo)
    assert assign.tobytes() == rassign.tobytes()
    assert cfg.slo_scale == rcfg.slo_scale
    assert cfg.wl_service_per_core == rcfg.wl_service_per_core
    assert cfg.columns == rcfg.columns
    assert {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)} \
        == {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    tb, rtb = sl.build_tables(cfg, device="cpu"), rsl.build_tables(rcfg)
    for col in ("slo_scale", "wl_service"):
        assert tb.col[col].numpy().tobytes() == \
            np.asarray(rtb.col[col]).tobytes()


@pytest.mark.parametrize("sched", ["asl", "fifo"])
def test_multiclass_workload_and_metrics(sched):
    def run(pkg, eng_mod):
        c = pkg[0]
        kw = {"default_window": 0.02, "max_window": 10.0} \
            if sched == "asl" else {}
        eng = eng_mod.ServingEngine(sched, eng_mod.CostModel(),
                                    scheduler_kwargs=kw, seed=0)
        m = c.WorkloadMix((
            c.ClientClass("lc", 1.0, 0.3, pkg[1].ServiceSpec("exp", 1.0)),
            c.ClientClass("be", 1.0, 3.0, pkg[1].ServiceSpec("exp", 1.0))))
        c.multiclass_workload(eng, m, rate_rps=2.0, duration_s=40.0,
                              prompt_lens=[2048, 4096], new_tokens=[16, 32],
                              seed=1)
        return eng, c.metrics_by_class(eng, m)
    (ea, a), (eb, b) = run(J, je), run(T, te)
    assert a["lc"]["n"] > 0 and a["be"]["n"] > 0
    assert a == b and ea.metrics() == eb.metrics()
    if sched == "asl":
        assert set(eb.sched._windows) == {0, 1}


def _generate(pkg, traces, name, seed=4):
    return traces.generate(pkg[1].ArrivalSpec("poisson", 30.0), None, 20.0,
                           seed, classes=mix(pkg, name),
                           cols=traces.request_columns([128, 256], [8, 16]))


def _same(a, b):
    for f in ("arrival_t", "service_s", "klass", "slo"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert sorted(a.cols) == sorted(b.cols)
    for k in a.cols:
        assert a.cols[k].dtype == b.cols[k].dtype
        assert a.cols[k].tobytes() == b.cols[k].tobytes()
    assert a.meta == b.meta and a.classes == b.classes


@pytest.mark.parametrize("name", ["amp", "weighted", "three"])
def test_multiclass_trace_is_identical(name):
    a, b = _generate(J, jt, name), _generate(T, tt, name)
    assert len(a) > 400
    _same(a, b)


@pytest.mark.parametrize("writer,reader", [(jt, tt), (tt, jt), (tt, tt)])
def test_npz_round_trips_between_packages(writer, reader, tmp_path):
    pkg = J if writer is jt else T
    tr = _generate(pkg, writer, "weighted")
    back = reader.load(writer.save(tmp_path / "wl.npz", tr))
    _same(tr, back)
    assert back.classes == ("lc", "be") and back.meta["seed"] == 4
    single = writer.generate(pkg[1].ArrivalSpec("mmpp", 20.0, 5.0),
                             pkg[1].ServiceSpec("bimodal", 0.1, mix=0.2),
                             10.0, 2)
    back = reader.load(writer.save(tmp_path / "one.npz", single))
    assert back.slo is None and back.classes == ("default",)
    assert back.arrival_t.tobytes() == single.arrival_t.tobytes()
    assert back.meta == single.meta


def test_load_refuses_a_newer_format(tmp_path):
    tr = _generate(T, tt, "amp")
    tr.meta["version"] = 99
    p = tmp_path / "new.npz"
    tt.save(p, tr)
    # save stamps its own version: write a newer one by hand.
    with np.load(p) as z:
        arrays = dict(z)
    import json
    meta = json.loads(arrays["meta"].tobytes().decode())
    meta["version"] = tt.FORMAT_VERSION + 1
    arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(p, **arrays)
    for mod in (jt, tt):
        with pytest.raises(ValueError, match="format version"):
            mod.load(p)

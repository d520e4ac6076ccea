"""The port's serving stack against the JAX package's numpy one: the
counter-based host draws and traces, the admission schedulers, and the
serving engine under asl / fifo / greedy on the same trace and cost model;
then ``launch.serve.main`` on xlstm-tiny on the CPU.

Tolerances: exact equality everywhere (the draws are threefry bits and
f64 numpy math on them, the engine is the same numpy code), except
``exp`` service times, which pass through f32 ``log1p`` on each side and
may differ by at most 2 ulps (ROADMAP parity level 3)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import asl_schedule as j_sched
from repro.serving import engine as je
from repro.workloads import generators as jg
from repro.workloads import traces as jt
from repro_torch.core import asl_schedule as t_sched
from repro_torch.kernels import mlstm_scan as ms
from repro_torch.launch import serve
from repro_torch.serving import engine as te
from repro_torch.workloads import generators as tg
from repro_torch.workloads import traces as tt

ARRIVAL = dict(rate=40.0, burstiness=4.0, burst_len=6.0, amp=0.5)
COST = dict(decode_step_s=0.004, prefill_chunk_s=0.03, prefill_chunk=256,
            max_batch=8)
PROMPTS, NEW_TOKENS = [512, 1024, 2048], [32, 128]


@pytest.mark.parametrize("stream", [jg.STREAM_THINK, jg.STREAM_COLS])
def test_uniform_block_is_bit_identical(stream):
    for n in (1, 64, 65, 1000):
        a = jg.uniform_block(7, stream, n)
        b = tg.uniform_block(7, stream, n)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("process", ["poisson", "closed", "mmpp",
                                     "diurnal"])
def test_arrival_times_are_bit_identical(process):
    a = jg.arrival_times(jg.ArrivalSpec(process, **ARRIVAL), 25.0, 3)
    b = tg.arrival_times(tg.ArrivalSpec(process, **ARRIVAL), 25.0, 3)
    assert len(a) > 100
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dist", ["det", "exp", "bimodal"])
def test_service_times(dist):
    spec = dict(dist=dist, mean=2.5, mix=0.3, mix_scale=8.0)
    a = jg.service_times(jg.ServiceSpec(**spec), 3000, 5)
    b = tg.service_times(tg.ServiceSpec(**spec), 3000, 5)
    assert a.dtype == b.dtype == np.float32
    ulps = np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))
    assert ulps.max() <= (2 if dist == "exp" else 0)


def test_lognormal_service_times_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="normal"):
        tg.service_times(tg.ServiceSpec("lognormal"), 10, 0)


def test_choice_and_think_gaps_are_bit_identical():
    for kw in ({}, {"weights": [0.2, 0.5, 0.3]}):
        a = jg.choice(PROMPTS, 500, 4, **kw)
        b = tg.choice(PROMPTS, 500, 4, **kw)
        assert np.array_equal(a, b)
    a = jg.client_think_gaps(2, 3, 300)
    b = tg.client_think_gaps(2, 3, 300)
    assert a.tobytes() == b.tobytes()


def test_trace_generate_is_identical():
    a = jt.generate(jg.ArrivalSpec("poisson", 20.0), jg.ServiceSpec(), 30.0,
                    9, cols=jt.request_columns(PROMPTS, NEW_TOKENS))
    b = tt.generate(tg.ArrivalSpec("poisson", 20.0), tg.ServiceSpec(), 30.0,
                    9, cols=tt.request_columns(PROMPTS, NEW_TOKENS))
    assert len(a) == len(b) > 400
    for f in ("arrival_t", "service_s", "klass"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert sorted(a.cols) == sorted(b.cols)
    for k in a.cols:
        assert np.array_equal(a.cols[k], b.cols[k])
    assert a.meta == b.meta and a.classes == b.classes and b.slo is None
    with pytest.raises(NotImplementedError, match="clients"):
        tt.generate(tg.ArrivalSpec(), tg.ServiceSpec(), 1.0, 0,
                    classes=object())


def test_schedulers_derive_from_the_registry():
    assert sorted(t_sched.SCHEDULERS) == sorted(j_sched.SCHEDULERS) \
        == ["asl", "fifo", "greedy"]


def _metrics(mod, sched, **engine_kw):
    kw = {"default_window": 0.02, "max_window": 10.0} \
        if sched == "asl" else {}
    eng = mod.ServingEngine(sched, mod.CostModel(**COST),
                            scheduler_kwargs=kw, **engine_kw)
    mod.poisson_workload(eng, rate_rps=20.0, duration_s=30.0,
                         prompt_lens=PROMPTS, new_tokens=NEW_TOKENS,
                         slo_ttft=0.25, seed=1)
    return eng.metrics()


@pytest.mark.parametrize("sched", ["asl", "fifo", "greedy"])
@pytest.mark.parametrize("chaos", [False, True])
def test_engine_metrics_are_identical(sched, chaos):
    kw = dict(timeout_s=1.5, max_retries=2, admit_limit=40) if chaos else {}
    a, b = _metrics(je, sched, **kw), _metrics(te, sched, **kw)
    assert a["n"] > 20
    assert a == b


def test_closed_loop_engine_is_identical():
    def run(mod):
        eng = mod.ServingEngine("asl", mod.CostModel(**COST))
        mod.closed_loop_workload(eng, n_clients=6, think_s=0.2,
                                 duration_s=20.0, prompt_lens=PROMPTS,
                                 new_tokens=NEW_TOKENS, slo_ttft=0.5)
        return eng.metrics()
    a, b = run(je), run(te)
    assert a["n"] > 10 and a == b


def test_serve_main_on_the_cpu():
    n0 = ms.mlstm_scan.launches
    m = serve.main(["--arch", "xlstm-125m", "--tiny", "--rate", "2",
                    "--duration", "20"], device="cpu")
    assert ms.mlstm_scan.launches == n0      # the CPU runs no kernel
    assert m["decode_step_s"] > 0 and m["prefill_chunk_s"] > 0
    assert "n" in m and "timeouts_total" in m
    if m["n"]:
        assert np.isfinite(m["ttft_p99"]) and m["throughput_tok_s"] > 0


def test_calibrated_cost_on_the_cpu_is_a_cost_model():
    from repro_torch.configs import registry
    cfg = dataclasses.replace(registry.get_tiny("xlstm-125m"), n_layers=2)
    cost = serve.calibrated_cost(cfg, batch=2, prefill_chunk=8, t_cache=16,
                                 device="cpu")
    assert isinstance(cost, te.CostModel)
    assert cost.prefill_chunk == 8 and cost.max_batch == 2
    assert cost.decode_step_s > 0 and cost.prefill_chunk_s > 0


def test_serve_needs_a_card_unless_told_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "xlstm-125m", "--tiny"])

"""The port's training substrate against the JAX package's, on the CPU:

* the data stream: ``TokenDataset`` batches (synthetic and from a token
  file, whole and host-sharded) and the ``PrefetchLoader`` order identical
  to the reference's for the same seed; ``straggle_uniforms`` identical;
* the bounded-staleness controller: the same decisions on a commit
  sequence and the same ``simulate`` results;
* the host LibASL mutex: ``tests/test_core_locks.py``'s lock and epoch
  tests run again on the port's classes (its module globals swapped for
  the port's; ``test_asl_mutex_dispatch`` hammers the ASL mutex), and
  mutual exclusion for every other lock kind;
* checkpoints: leaf names equal to the reference's ``_leaf_names`` for
  the full training state, and a checkpoint saved by either package
  restores in the other leaf for leaf, bit for bit;
* the trainer: a run interrupted and resumed repeats an uninterrupted
  one bit for bit (mirroring ``tests/test_substrate.py:120-137``, which
  holds the reference to 1e-6); a preempted run checkpoints at the step
  boundary, by flag and by SIGUSR1; and the launcher on the CPU.

All of it is exact: no tolerance is needed."""

import functools
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_core_locks as ref_lock_tests
from repro.ckpt import checkpointer as jck
from repro.configs import registry as jreg
from repro.data import pipeline as jdata
from repro.dist import staleness as jst
from repro.models import lm as jlm
from repro.optim import adamw as jad
from repro.workloads.generators import straggle_uniforms as j_straggle
from repro_torch.ckpt import checkpointer as tck
from repro_torch.configs import registry as treg
from repro_torch.core import aimd, libasl, locks, reorderable
from repro_torch.data import pipeline as tdata
from repro_torch.dist import staleness as tst
from repro_torch.launch import train as tlaunch
from repro_torch.models import lm as tlm
from repro_torch.optim import adamw as tad
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import leaf_names, leaves
from repro_torch.workloads.generators import straggle_uniforms


# ---------------------------------------------------------------------------
# Data and draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,seed", [(101, 16, 4, 0),
                                                  (256000, 33, 2, 5),
                                                  (307, 8, 6, 3)])
def test_token_batches_identical_to_reference(vocab, seq, batch, seed):
    jd = jdata.TokenDataset(jdata.DataConfig(vocab, seq, batch, seed=seed))
    td = tdata.TokenDataset(tdata.DataConfig(vocab, seq, batch, seed=seed))
    for step in (0, 1, 7, 1000):
        a, b = jd.batch(step), td.batch(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    for h in range(2):
        kw = dict(host_index=h, host_count=2, seed=seed)
        a = jdata.TokenDataset(jdata.DataConfig(vocab, seq, 4, **kw)).batch(3)
        b = tdata.TokenDataset(tdata.DataConfig(vocab, seq, 4, **kw)).batch(3)
        assert np.array_equal(a["tokens"], b["tokens"])


def test_token_file_batches_identical(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 500, 10_000).astype(np.int32) \
        .tofile(path)
    jd = jdata.TokenDataset(jdata.DataConfig(500, 20, 3, token_file=str(path)))
    td = tdata.TokenDataset(tdata.DataConfig(500, 20, 3, token_file=str(path)))
    for step in (0, 4, 99):
        assert np.array_equal(jd.batch(step)["tokens"],
                              td.batch(step)["tokens"])


def test_prefetch_loader_order_and_batches():
    ds = tdata.TokenDataset(tdata.DataConfig(vocab=31, seq_len=8,
                                             global_batch=2))
    loader = tdata.PrefetchLoader(ds, start_step=3, prefetch=2)
    got = [next(loader) for _ in range(5)]
    loader.close()
    assert [s for s, _ in got] == [3, 4, 5, 6, 7]
    for s, b in got:
        assert np.array_equal(b["tokens"], ds.batch(s)["tokens"])


def test_straggle_uniforms_identical():
    for seed, pod, n in ((0, 0, 5), (7, 2, 401), (11, 7, 64)):
        a, b = j_straggle(seed, pod, n), straggle_uniforms(seed, pod, n)
        assert a.dtype == b.dtype == np.float64 and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Bounded staleness
# ---------------------------------------------------------------------------

def test_staleness_decisions_identical():
    rng = np.random.default_rng(4)
    for window, max_window in ((0.0, 0.0), (3.0, 6.0), (2.5, None)):
        j = jst.BoundedStalenessController(4, window_steps=window,
                                           max_window=max_window)
        t = tst.BoundedStalenessController(4, window_steps=window,
                                           max_window=max_window)
        for i in range(300):
            pod = int(rng.integers(4))
            assert j.can_commit(pod) == t.can_commit(pod)
            if j.can_commit(pod):
                j.commit(pod)
                t.commit(pod)
            if i % 7 == 0:
                pen = float(rng.uniform(0, 10))
                j.observe_quality(pen, 5.0)
                t.observe_quality(pen, 5.0)
            assert (j.staleness(), j.lead(pod), j.window) == \
                (t.staleness(), t.lead(pod), t.window)


@pytest.mark.parametrize("kw", [
    dict(straggle_prob=0.1, straggle_factor=5.0, seed=11, quality_slo=6.0,
         penalty_per_stale=1.0),
    dict(straggle_prob=0.2, straggle_factor=4.0, seed=7, horizon_steps=120),
    dict(),
])
def test_staleness_simulate_identical(kw):
    dur = [1.0, 1.0, 1.3, 2.0]
    mk = {"j": jst.BoundedStalenessController,
          "t": tst.BoundedStalenessController}
    out = {k: sim(4, dur, controller=mk[k](4, window_steps=4.0,
                                           max_window=8.0), **kw)
           for k, sim in (("j", jst.simulate), ("t", tst.simulate))}
    assert out["j"] == out["t"] or all(
        (a == b) or (np.isnan(a) and np.isnan(b))
        for a, b in zip(out["j"], out["t"]))


# ---------------------------------------------------------------------------
# The host LibASL mutex: tests/test_core_locks.py on the port's classes
# ---------------------------------------------------------------------------

PORT_LOCKS = {
    "FIFOLock": locks.FIFOLock, "TASLock": locks.TASLock,
    "TicketLock": locks.TicketLock,
    "ProportionalLock": locks.ProportionalLock,
    "ReorderableLock": reorderable.ReorderableLock,
    "LibASL": libasl.LibASL, "ASLMutex": libasl.ASLMutex,
    "AIMDWindow": aimd.AIMDWindow,
}
MIRRORED = [
    "test_fifo_handoff_order", "test_reorder_window_bounds_bypass",
    "test_reorder_fast_path_free_lock",
    "test_zero_window_standby_enqueues_immediately",
    "test_positive_window_still_polls_before_enqueue",
    "test_proportional_ratio", "test_aimd_violation_halves_and_unit_rescaled",
    "test_aimd_linear_growth", "test_aimd_cap",
    "test_epoch_nesting_and_window_selection",
    "test_epoch_end_without_start_raises_not_zero_latency",
    "test_epoch_end_mismatched_nesting_keeps_inner_governing",
    "test_epoch_reentrant_same_id_balanced", "test_big_core_skips_adjustment",
    "test_asl_mutex_dispatch",
]


@pytest.fixture
def port_lock_tests(monkeypatch):
    for name, cls in PORT_LOCKS.items():
        monkeypatch.setattr(ref_lock_tests, name, cls)
    return ref_lock_tests


@pytest.mark.parametrize("name", MIRRORED)
def test_core_lock_tests_on_port(port_lock_tests, name):
    getattr(port_lock_tests, name)()
    assert port_lock_tests.FIFOLock is locks.FIFOLock


@pytest.mark.parametrize("kind", ["fifo", "tas", "ticket", "prop",
                                  "reorderable"])
def test_mutual_exclusion_on_port(port_lock_tests, kind):
    mk = {"fifo": locks.FIFOLock, "tas": locks.TASLock,
          "ticket": locks.TicketLock,
          "prop": lambda: locks.ProportionalLock(lambda: True),
          "reorderable": port_lock_tests.ReorderableLockAdapter}
    got, want = port_lock_tests._hammer(mk[kind]())
    assert got == want


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _states(arch):
    """The reference's and the port's training state, the same values:
    parameters from the reference's init, one AdamW update of each."""
    cj, ct = jreg.get_tiny(arch), treg.get_tiny(arch)
    pj = jlm.init_params(cj, 0)
    rng = np.random.default_rng(1)
    g = jax.tree.map(lambda x: rng.standard_normal(x.shape)
                     .astype(np.float32), pj)
    jopt, topt = jad.AdamW(), tad.AdamW()
    pj, sj = jax.jit(jopt.update)(g, jopt.init(pj), pj, jnp.float32(1e-3))
    pt = tlm.params_from_reference(ct, jax.tree.map(np.asarray, pj), "cpu",
                                   requires_grad=True)
    st = topt.init(pt)
    with torch.no_grad():
        for dst, src in zip(leaves(st.m) + leaves(st.v),
                            jax.tree.leaves(sj.m) + jax.tree.leaves(sj.v)):
            dst.copy_(torch.from_numpy(np.array(src)))
    st.count.fill_(int(sj.count))
    return {"params": pj, "opt": sj}, {"params": pt.tree(), "opt": st}


def _equal(jtree, ttree):
    jl, tl = jax.tree.leaves(jtree), leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        b = b.detach().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "yi-6b"])
def test_leaf_names_equal_reference(arch):
    jtree, ttree = _states(arch)
    assert leaf_names(ttree) == jck._leaf_names(jtree)
    assert "opt_count" in leaf_names(ttree)
    _equal(jtree, ttree)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "yi-6b"])
def test_checkpoint_restores_across_packages(tmp_path, arch):
    jtree, ttree = _states(arch)
    # The port saves, the reference restores.
    tck.CheckpointManager(tmp_path / "p", save_async=False).save(5, ttree)
    jm = jck.CheckpointManager(tmp_path / "p", save_async=False)
    assert jm.latest() == 5
    _equal(jm.restore(5, jax.tree.map(jnp.zeros_like, jtree)), ttree)
    # The reference saves, the port restores (in place, into zeros).
    jck.CheckpointManager(tmp_path / "j", save_async=False).save(9, jtree)
    tm = tck.CheckpointManager(tmp_path / "j", save_async=False)
    assert tm.latest() == 9
    target = {"params": {k: v for k, v in _zeros(ttree["params"]).items()},
              "opt": tad.AdamWState(*_zeros(tuple(ttree["opt"])))}
    assert tm.restore(9, target) is target
    _equal(jtree, target)
    # Same files, same manifests.
    names = lambda d: sorted(p.name for p in d.iterdir())
    assert names(tmp_path / "p" / "step_5") == names(tmp_path / "j" / "step_9")


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros(x) for x in tree)
    return torch.zeros_like(tree.detach())


def test_checkpoint_atomic_and_keep_policy(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.int32), "b": [torch.ones(2)]}
    tck.save(tmp_path, 3, tree)
    (tmp_path / "step_9.tmp").mkdir()
    assert tck.latest_step(tmp_path) == 3
    m = tck.CheckpointManager(tmp_path / "k", keep=2)    # async saves
    for s in (1, 2, 3, 4):
        m.save(s, tree)
    m.wait()
    assert sorted(p.name for p in (tmp_path / "k").iterdir()) == \
        ["step_3", "step_4"]
    with pytest.raises(NotImplementedError):
        tck.restore(tmp_path, 3, tree, shardings={"a": None})


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

def _mk_trainer(path, total=12, every=4):
    return Trainer(treg.get_tiny("yi-6b"), TrainerConfig(
        total_steps=total, ckpt_every=every, ckpt_dir=str(path), keep=10,
        lr=1e-3, global_batch=4, seq_len=32), device="cpu")


def test_trainer_restart_bit_identical(tmp_path):
    out1 = _mk_trainer(tmp_path / "a").run()
    _mk_trainer(tmp_path / "b").run(max_steps=6)
    t3 = _mk_trainer(tmp_path / "b")
    out3 = t3.run()
    assert out3["step"] == out1["step"] == 12
    l1 = {h["step"]: h["loss"] for h in out1["history"]}
    l3 = {h["step"]: h["loss"] for h in out3["history"]}
    assert sorted(l3) == list(range(7, 13))
    for s in l3:
        assert l1[s] == l3[s], (s, l1[s], l3[s])
    for a, b in zip(leaves(out1["params"].tree()) + leaves(out1["opt"]),
                    leaves(out3["params"].tree()) + leaves(out3["opt"])):
        assert torch.equal(a, b)
    assert t3.ckpt.latest() == 12
    with pytest.raises(NotImplementedError, match="shardings"):
        Trainer(treg.get_tiny("yi-6b"), TrainerConfig(), shardings={},
                device="cpu")


def test_trainer_preemption_checkpoints(tmp_path):
    t = _mk_trainer(tmp_path / "flag", total=500, every=1000)

    def preempt_soon():
        time.sleep(0.3)
        t._preempted = True
    th = threading.Thread(target=preempt_soon)
    th.start()
    out = t.run()
    th.join()
    assert out["preempted"] and 0 < out["step"] < 500
    assert t.ckpt.latest() == out["step"]   # checkpointed at the boundary
    # SIGUSR1, through the installed handler.
    t2 = _mk_trainer(tmp_path / "sig", total=500, every=1000)
    old = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGUSR1)}
    try:
        t2.install_signal_handlers()
        os.kill(os.getpid(), signal.SIGUSR1)
        out2 = t2.run()
    finally:
        for s, h in old.items():
            signal.signal(s, h)
    assert out2["preempted"] and out2["step"] == 0
    assert t2.ckpt.latest() == 0


def test_launch_train_on_cpu(tmp_path, capsys):
    out = tlaunch.main(["--arch", "recurrentgemma-2b", "--tiny", "--steps",
                        "3", "--global-batch", "2", "--seq-len", "16",
                        "--microbatches", "2", "--ckpt-every", "1000",
                        "--ckpt-dir", str(tmp_path)], device="cpu")
    assert out["step"] == 3 and len(out["history"]) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in out["history"])
    assert tck.latest_step(tmp_path) == 3
    assert "arch=recurrentgemma-tiny" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="backward"):
        tlaunch.main(["--arch", "xlstm-125m", "--tiny", "--ckpt-dir",
                      str(tmp_path / "x")], device="cpu")

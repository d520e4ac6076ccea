"""Deterministic data pipeline: synthetic LM stream + memmap token files.

Production shape: each host reads only its shard of the global batch
(``host_slice``), shuffling is a stateless bijective permutation of the
sample index space (restart-safe: the step counter *is* the data state —
checkpoint restore resumes the stream exactly), and a background prefetch
thread keeps ``prefetch`` batches ready.  The prefetch queue is guarded by
the paper's own LibASL mutex (consumer = latency-critical big-core path,
refills reorder behind it).

The port's own copy of the JAX package's ``repro/data/pipeline.py`` (it imports
nothing of that package); its behaviour is the reference's.
"""

from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np

from repro_torch.core.libasl import LibASL


def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 — stateless bijection used as the shuffle."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) \
        & np.uint64(0xFFFFFFFFFFFFFFFF)
    return x ^ (x >> np.uint64(31))


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    host_index: int = 0
    host_count: int = 1
    seed: int = 0
    token_file: str | None = None   # memmap int32 token file; synthetic if None


class TokenDataset:
    """Batch source: ``batch(step) -> {"tokens", "labels"}`` (host shard)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.host_count == 0
        self.host_batch = cfg.global_batch // cfg.host_count
        self._tokens = None
        if cfg.token_file:
            self._tokens = np.memmap(cfg.token_file, dtype=np.int32,
                                     mode="r")
            self._n_seqs = len(self._tokens) // (cfg.seq_len + 1)

    def batch(self, step: int) -> dict:
        c = self.cfg
        idx = (np.arange(self.host_batch, dtype=np.uint64)
               + np.uint64(step) * np.uint64(c.global_batch)
               + np.uint64(self.host_batch * c.host_index))
        mixed = _mix64(idx + np.uint64(c.seed) * np.uint64(0x1000003))
        if self._tokens is not None:
            rows = (mixed % np.uint64(self._n_seqs)).astype(np.int64)
            chunk = np.stack([
                self._tokens[r * (c.seq_len + 1):(r + 1) * (c.seq_len + 1)]
                for r in rows])
        else:
            # Synthetic: a learnable Markov-ish stream (next = f(prev)),
            # so smoke training shows a real loss decrease.  Noise derives
            # per-(sample, position) from the bijective mix, so host shards
            # tile the global batch exactly (restart- and topology-safe).
            pos = _mix64(np.arange(c.seq_len, dtype=np.uint64)
                         + np.uint64(0xABCDEF))
            tmix = _mix64(mixed[:, None] ^ pos[None, :])
            noise = (tmix % np.uint64(7)).astype(np.int64)
            start = (mixed % np.uint64(c.vocab)).astype(np.int64)
            chunk = np.empty((self.host_batch, c.seq_len + 1), np.int64)
            chunk[:, 0] = start
            for t in range(c.seq_len):
                chunk[:, t + 1] = (chunk[:, t] * 31 + 17 + noise[:, t]) \
                    % c.vocab
        return {"tokens": chunk[:, :-1].astype(np.int32),
                "labels": chunk[:, 1:].astype(np.int32)}


class PrefetchLoader:
    """Background-thread prefetcher over a TokenDataset."""

    def __init__(self, ds: TokenDataset, start_step: int = 0,
                 prefetch: int = 2):
        self.ds = ds
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._asl = LibASL(is_big_core=lambda: not _is_producer())
        self._lock = self._asl.mutex()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        _PRODUCER.flag = True
        step = self._step
        while not self._stop.is_set():
            b = self.ds.batch(step)
            try:
                self._q.put((step, b), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __iter__(self):
        return self

    def __next__(self):
        with self._lock:
            return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)


_PRODUCER = threading.local()


def _is_producer() -> bool:
    return getattr(_PRODUCER, "flag", False)

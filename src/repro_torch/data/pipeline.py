"""Deterministic synthetic LM data pipeline.

Produces (tokens, labels) batches that are a pure function of
``(seed, step, shard)`` — restart/elastic-reshard safe: after a revocation
the pipeline resumes at any step on any data-shard split and yields the
exact same global batch. Labels are next-token targets of a synthetic
Markov-ish stream (token t+1 depends on token t), so small models show a
real decreasing loss curve in the examples.

``Prefetcher`` double-buffers batches on a background thread so host-side
data generation overlaps device compute.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np


class SyntheticLM:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
    ):
        assert global_batch % num_shards == 0
        self.vocab = int(vocab_size)
        self.seq_len = int(seq_len)
        self.global_batch = int(global_batch)
        self.local_batch = global_batch // num_shards
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        # fixed per-dataset transition structure (cheap bigram-ish generator)
        rng = np.random.default_rng(seed)
        self._mix = rng.integers(1, self.vocab, size=(257,), dtype=np.int64)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        """Global-batch rows [shard*local : (shard+1)*local] for this step."""
        rows = []
        base = self.shard * self.local_batch
        for r in range(self.local_batch):
            rows.append(self._row(step, base + r))
        tokens = np.stack(rows)
        labels = np.concatenate(
            [tokens[:, 1:], tokens[:, :1]], axis=1
        )  # next-token; last wraps (masked-equivalent noise)
        return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}

    def _row(self, step: int, row: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence(entropy=self.seed, spawn_key=(step, row))
        )
        noise = rng.integers(0, 256, size=self.seq_len + 1, dtype=np.int64)
        seq = np.empty(self.seq_len, dtype=np.int64)
        t = noise[0]
        for i in range(self.seq_len):
            t = (self._mix[t % 257] + noise[i + 1] * (i % 7 == 0)) % self.vocab
            seq[i] = t
        return seq

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Double-buffering wrapper: generates batch(step+1) while step runs."""

    def __init__(self, dataset: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.dataset = dataset
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self._q.put(self.dataset.batch(step), timeout=0.1)
                step += 1
            except queue.Full:
                continue

    def next(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)

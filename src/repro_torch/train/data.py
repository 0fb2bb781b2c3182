"""Deterministic synthetic data pipeline (port of ``repro.train.data``; the
container has no corpora).

Produces packed next-token batches from a seeded Zipf-ish token source with
document boundaries, sharded per host and prefetched on a background thread.
Host numpy, the reference's code: the same ``PCG64(hash((seed, host,
step)))`` stream gives the same batches, so a run resumed by either package
reads the same data.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        global_batch: int,
        host_index: int = 0,
        host_count: int = 1,
        seed: int = 0,
        prefetch: int = 2,
        doc_len_mean: int = 512,
    ):
        assert global_batch % host_count == 0
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host = host_index
        self.doc_len_mean = doc_len_mean
        self._step = 0
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            np.random.PCG64(hash((self.seed, self.host, step)) & 0x7FFFFFFF)
        )
        b, s = self.local_batch, self.seq
        toks = np.empty((b, s + 1), np.int32)
        for i in range(b):
            pos = 0
            while pos < s + 1:
                dl = int(rng.exponential(self.doc_len_mean)) + 8
                dl = min(dl, s + 1 - pos)
                doc = (rng.zipf(1.3, size=dl) % (self.vocab - 2)) + 2
                doc[0] = 1  # BOS
                toks[i, pos : pos + dl] = doc
                pos += dl
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def _worker(self):
        step = 0
        while not self._stop.is_set():
            batch = self._batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        step, batch = self._q.get()
        self._step = step
        return batch

    def __iter__(self):
        return self

    def skip_to(self, step: int) -> None:
        """Resume support: drain until the pipeline is at ``step``."""
        while self._step + 1 < step:
            self.__next__()

    def close(self):
        self._stop.set()

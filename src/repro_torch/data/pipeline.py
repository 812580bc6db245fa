"""Deterministic, restart-safe data pipeline.

Counterpart of ``repro/data/pipeline.py``; numpy only, so the batches are
bitwise the reference's for every ``(seed, step, host_index,
host_count)``. Two sources:

  * :class:`SyntheticLM`: tokens drawn from a step-keyed PRNG (a
    zipf-like marginal, so losses are not flat); fully determined by
    ``(seed, step)``, so a job restarted from a checkpoint at step k
    replays the same stream. vlm batches add ``patch_embeds`` [B, n, d]
    f32; audio tokens are [B, S, C].
  * :class:`MemmapLM`: a memory-mapped token file (uint16/uint32), random
    windows keyed by ``(seed, step)``; per-host sharding by host index.

Both give ``{"tokens": [B, S], "labels": [B, S]}`` numpy batches (labels
are the next tokens). The training driver moves them to the device.
:class:`Prefetcher` prepares the next batches on a background thread
while the device computes.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticLM:
    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 n_codebooks: int = 0, n_img_tokens: int = 0,
                 d_model: int = 0):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        self.seed = seed
        self.n_codebooks = n_codebooks
        self.n_img_tokens = n_img_tokens
        self.d_model = d_model

    def get(self, step: int, *, host_index: int = 0, host_count: int = 1):
        b = self.batch // host_count
        rng = np.random.default_rng((self.seed, step, host_index))
        shape = ((b, self.seq + 1, self.n_codebooks) if self.n_codebooks
                 else (b, self.seq + 1))
        # zipf-flavoured marginal clipped to the vocab
        toks = (rng.zipf(1.3, size=shape) % self.vocab).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.n_img_tokens:
            out["patch_embeds"] = rng.standard_normal(
                (b, self.n_img_tokens, self.d_model)).astype(np.float32)
        return out


class MemmapLM:
    def __init__(self, path: str, batch: int, seq: int, seed: int = 0,
                 dtype=np.uint16):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.batch, self.seq, self.seed = batch, seq, seed

    def get(self, step: int, *, host_index: int = 0, host_count: int = 1):
        b = self.batch // host_count
        rng = np.random.default_rng((self.seed, step, host_index))
        hi = len(self.data) - self.seq - 1
        starts = rng.integers(0, hi, size=b)
        win = np.stack([self.data[s:s + self.seq + 1] for s in starts])
        win = win.astype(np.int32)
        return {"tokens": win[:, :-1], "labels": win[:, 1:]}


class Prefetcher:
    """Background prefetch of ``source.get(step, **kw)`` for consecutive
    steps from ``start_step``, at most ``depth`` batches ahead."""

    def __init__(self, source, start_step: int = 0, depth: int = 2, **kw):
        self.source = source
        self.kw = kw
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        s = self.step
        while not self._stop.is_set():
            item = (s, self.source.get(s, **self.kw))
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            s += 1

    def next(self):
        """``(step, batch)`` of the next step."""
        return self.q.get()

    def close(self):
        self._stop.set()
        while not self.q.empty():
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.t.join(timeout=2)

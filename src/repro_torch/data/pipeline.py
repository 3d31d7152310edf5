"""Deterministic, restart-resumable data pipeline (numpy only).

Batches are a pure function of (seed, step): after a restart the trainer
asks for step N and gets bit-identical data, with no iterator state to
persist (the checkpoint stores only the step counter).  Sources:

  * ``synthetic``: a seeded token stream (zipf-ish marginals, so losses
    move),
  * ``memmap``: fixed-length samples from a token file (``np.memmap``),
    step-indexed with a seeded shuffle — the path for real corpora.

``host_prefetch`` overlaps host batch construction with device compute
(double buffering).  Batches are numpy arrays; the train step moves them to
its device.  The same seed and step give the reference's batches bit for
bit.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    microbatches: int = 1
    seed: int = 0
    source: str = "synthetic"  # synthetic | memmap
    path: str | None = None
    extras: dict | None = None  # e.g. vlm patches / whisper frames: name -> per-row shape


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synthetic_batch(cfg: DataConfig, step: int) -> dict:
    rng = _rng_for(cfg.seed, step)
    b, s = cfg.global_batch, cfg.seq_len
    # zipf-flavored marginals, clipped into vocab
    toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64) % cfg.vocab
    out = {"tokens": toks.astype(np.int32)}
    for name, shape in (cfg.extras or {}).items():
        out[name] = rng.standard_normal((b, *shape), dtype=np.float32)
    return out


def memmap_batch(cfg: DataConfig, step: int) -> dict:
    data = np.memmap(cfg.path, dtype=np.int32, mode="r")
    n_samples = data.shape[0] // (cfg.seq_len + 1)
    rng = _rng_for(cfg.seed, step)
    idx = rng.integers(0, n_samples, size=cfg.global_batch)
    rows = np.stack(
        [data[i * (cfg.seq_len + 1) : (i + 1) * (cfg.seq_len + 1)] for i in idx]
    )
    return {"tokens": rows % np.int32(cfg.vocab)}


def get_batch(cfg: DataConfig, step: int) -> dict:
    """Step ``step``'s batch; with ``microbatches`` > 1 every leaf gains a
    leading microbatch axis, (MB, B / MB, ...)."""
    batch = (memmap_batch if cfg.source == "memmap" else synthetic_batch)(cfg, step)
    if cfg.microbatches > 1:
        def split(a):
            mb = cfg.microbatches
            return a.reshape(mb, a.shape[0] // mb, *a.shape[1:])
        batch = {k: split(v) for k, v in batch.items()}
    return batch


class host_prefetch:
    """Double-buffered batch iterator: builds batch N+1 on a worker thread
    while the device runs step N.  Yields ``(step, batch)``."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2):
        self.cfg = cfg
        self.step = start_step
        self.q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        s = self.step
        while not self.stop.is_set():
            batch = get_batch(self.cfg, s)
            self.q.put((s, batch))
            s += 1

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self.stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue_mod.Empty:
            pass

"""Deterministic, seekable synthetic data pipeline.

Every batch is a pure function of (seed, step, host_shard) — resuming from a
checkpoint at step N replays the exact token stream with no iterator state to
persist beyond the step counter. A background prefetch thread keeps
`prefetch` batches ready (the host-side input pipeline of a real cluster).

Token stream: Zipf-distributed ids with document boundaries — enough
structure for loss curves to be meaningfully decreasing in the e2e example.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 256
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.2
    doc_len_mean: int = 96


def _batch_rng(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.host_id, step]))


def make_batch(cfg: DataConfig, model_cfg: ModelConfig, step: int) -> dict:
    """Deterministic batch for `step` (host-sharded slice of the global batch)."""
    rng = _batch_rng(cfg, step)
    B = cfg.batch // cfg.n_hosts
    S = cfg.seq_len
    V = model_cfg.vocab_size
    eos = 1

    def tokens(shape):
        t = rng.zipf(cfg.zipf_a, size=shape).astype(np.int64) % (V - 2) + 2
        return t.astype(np.int32)

    if model_cfg.n_codebooks:
        toks = tokens((B, model_cfg.n_codebooks, S + 1))
        batch = {"tokens": toks[:, :, :-1],
                 "labels": np.moveaxis(toks[:, :, 1:], 1, -1)}
    elif model_cfg.family == "vlm" and model_cfg.vision_stub:
        embeds = rng.standard_normal((B, S, model_cfg.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
        labels = tokens((B, S))
        batch = {"embeds": embeds, "positions": pos, "labels": labels}
    else:
        toks = tokens((B, S + 1))
        # document boundaries
        n_docs = max(1, S // cfg.doc_len_mean)
        for b in range(B):
            cuts = rng.integers(1, S, size=n_docs)
            toks[b, cuts] = eos
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return batch


class DataLoader:
    """Prefetching iterator over make_batch, resumable at any step."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig, *,
                 start_step: int = 0, prefetch: int = 2):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._next_produce = start_step
        self._thread.start()

    def _worker(self):
        while not self._stop.is_set():
            b = make_batch(self.cfg, self.model_cfg, self._next_produce)
            self._next_produce += 1
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._q.get()
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step}

    def close(self):
        self._stop.set()

"""Token data pipeline: deterministic, host-sharded, checkpointable.

The port's copy of the reference's ``data/pipeline.py``.  It is numpy
only, so a batch is bit for bit the reference's batch of the same
``(seed, step, host)``; ``as_task``'s producer writes to the port's own
channels.  The train driver moves each batch to the device.

Two sources behind one interface:

* ``synthetic`` — a seeded Zipf-ish token stream (the default for examples,
  benchmarks and the train driver; no external data gate).
* ``memmap`` — a flat binary token file (np.memmap), the production path:
  each host reads only its shard's strided window.

The pipeline is a *task* in the TAPA sense: ``as_task`` returns a producer
function that streams batches into a channel with a bounded capacity, which
is exactly the paper's prefetch-queue pattern; the train driver consumes it
through the same IStream interface the simulator verifies.

State is one integer (``step``); checkpointing the pipeline is saving that
integer — restart resumes the exact batch sequence (required for
fault-tolerant training).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    source: str = "synthetic"            # synthetic | memmap
    path: Optional[str] = None           # memmap token file (uint16/uint32)
    n_hosts: int = 1
    host_id: int = 0


class TokenPipeline:
    """Deterministic batch iterator with O(1) restart state."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.step = 0
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide across hosts")
        self._host_batch = cfg.global_batch // cfg.n_hosts
        if cfg.source == "memmap":
            if not cfg.path:
                raise ValueError("memmap source needs cfg.path")
            dtype = np.uint32 if cfg.vocab > 65535 else np.uint16
            self._tokens = np.memmap(cfg.path, dtype=dtype, mode="r")
            if len(self._tokens) < cfg.seq_len + 1:
                raise ValueError("token file shorter than one sequence")
        elif cfg.source != "synthetic":
            raise ValueError(f"unknown source {cfg.source!r}")

    # -- state --------------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.step}

    def load_state_dict(self, s: dict) -> None:
        self.step = int(s["step"])

    # -- batches ------------------------------------------------------------
    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: batch content is a pure function of (seed, step,
        # host) — restart-safe, order-independent across hosts
        return np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 65_537 + self.cfg.host_id)

    def _synthetic(self, step: int) -> np.ndarray:
        rng = self._rng(step)
        B, S, V = self._host_batch, self.cfg.seq_len, self.cfg.vocab
        # Zipf-ish marginal over the vocab so losses have realistic scale
        u = rng.random((B, S + 1))
        toks = np.minimum((u ** 2.2 * V).astype(np.int64), V - 1)
        return toks.astype(np.int32)

    def _memmap(self, step: int) -> np.ndarray:
        rng = self._rng(step)
        B, S = self._host_batch, self.cfg.seq_len
        hi = len(self._tokens) - (S + 1)
        starts = rng.integers(0, hi + 1, size=B)
        return np.stack([np.asarray(self._tokens[s:s + S + 1])
                         for s in starts]).astype(np.int32)

    def next_batch(self) -> dict:
        toks = (self._synthetic if self.cfg.source == "synthetic"
                else self._memmap)(self.step)
        self.step += 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()

    # -- TAPA producer ------------------------------------------------------
    def as_task(self, n_batches: int, burst: int = 0):
        """A producer task streaming ``n_batches`` into a channel then
        closing the transaction (prefetch-queue pattern).

        ``burst`` > 0 prefetches that many batches at a time and moves
        them with one ``write_burst`` per group (capped at the channel
        capacity by default so prefetch memory stays bounded)."""
        def DataProducer(out):
            group = burst or out.channel.capacity
            done = 0
            while done < n_batches:
                k = min(group, n_batches - done)
                out.write_burst([self.next_batch() for _ in range(k)])
                done += k
            out.close()
        return DataProducer


def make_pipeline(vocab: int, seq_len: int, global_batch: int,
                  **kw) -> TokenPipeline:
    return TokenPipeline(DataConfig(vocab=vocab, seq_len=seq_len,
                                    global_batch=global_batch, **kw))


def write_token_file(path: str | Path, tokens: np.ndarray,
                     vocab: int) -> None:
    """Helper used by tests/examples to create a memmap corpus."""
    dtype = np.uint32 if vocab > 65535 else np.uint16
    np.asarray(tokens, dtype=dtype).tofile(str(path))

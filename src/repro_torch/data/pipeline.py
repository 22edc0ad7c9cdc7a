"""Deterministic, shard-aware, resumable token pipeline (numpy only).

Two sources, as the reference's ``data/pipeline.py``:

* synthetic — counter-based Philox streams keyed by (seed, step, shard):
  O(1) random access, so a restore from a checkpoint is exact and free, and
  every data shard draws only its own slice;
* file — a flat uint16 token memmap, strided deterministically by (step,
  shard), so restarts and re-sharding replay identically.

A background prefetch thread keeps ``prefetch_depth`` batches ready.  The
batches are numpy int32 arrays, bit for bit the reference's.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["TokenPipeline"]


class TokenPipeline:
    def __init__(self, *, vocab_size: int, seq_len: int, global_batch: int, shard_index: int = 0,
                 num_shards: int = 1, seed: int = 0, token_file: str | None = None,
                 start_step: int = 0, prefetch_depth: int = 2):
        if global_batch % num_shards:
            raise ValueError(f"global_batch {global_batch} is not a multiple of {num_shards} shards")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // num_shards
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.seed = seed
        self.step = start_step
        self._tokens = None
        if token_file is not None:
            self._tokens = np.memmap(token_file, dtype=np.uint16, mode="r")
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch_depth)
        self._thread = None
        self._stop = threading.Event()

    # ---- deterministic batch synthesis -----------------------------------
    def _batch_at(self, step: int) -> np.ndarray:
        local_tokens = self.local_batch * self.seq_len
        if self._tokens is not None:
            n = len(self._tokens)
            per_step = self.global_batch * self.seq_len
            base = (step * per_step) % max(n - per_step, 1)
            local = base + self.shard_index * local_tokens
            flat = np.asarray(self._tokens[local: local + local_tokens])
            if flat.size < local_tokens:  # wrap
                flat = np.concatenate([flat, self._tokens[: local_tokens - flat.size]])
            return (flat.astype(np.int32) % self.vocab_size).reshape(self.local_batch, self.seq_len)
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=step * self.num_shards + self.shard_index))
        return rng.integers(0, self.vocab_size, size=(self.local_batch, self.seq_len), dtype=np.int32)

    # ---- iteration and prefetch --------------------------------------------
    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = {"tokens": self._batch_at(step), "step": step}
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None
        while not self._queue.empty():
            self._queue.get_nowait()

    def __next__(self):
        if self._thread is not None:
            batch = self._queue.get()
        else:
            batch = {"tokens": self._batch_at(self.step), "step": self.step}
        self.step = batch["step"] + 1
        return batch

    def __iter__(self):
        return self

    # ---- checkpointable state ---------------------------------------------
    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict):
        self.stop()
        self.step = int(state["step"])
        self.seed = int(state["seed"])
        return self

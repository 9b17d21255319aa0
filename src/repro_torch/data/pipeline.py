"""Deterministic synthetic LM data pipeline with sharding + prefetch.

Production shape without external deps: a seeded, *stateless-indexable*
token source (any (step, position) is recomputable — the property that
makes data-state checkpointing trivial and restarts exact), per-process
sharding for multi-host launches, and a background prefetch thread so host
data prep overlaps device compute (the pipeline-level cousin of the
paper's overlap argument).

A copy of ``repro/data/pipeline.py`` (numpy only): the same seed gives the
reference's batches bit for bit.  Batches are numpy arrays; a training
loop moves them to the device on its own thread, never the prefetch
worker's.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from typing import Iterator

import numpy as np

log = logging.getLogger("repro_torch.data.pipeline")


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so CE actually decreases during training
    structure: float = 0.8      # prob of deterministic next-token rule


class SyntheticLM:
    """Deterministic synthetic corpus: y[t+1] = (a*y[t]+c) % vocab with
    probability ``structure``, else uniform random (seeded per step).

    ``state()``/``restore()`` capture the iterator exactly (checkpointable
    alongside the model); ``shard(process_index, process_count)`` yields
    only this host's rows.
    """

    def __init__(self, cfg: DataConfig, process_index: int = 0,
                 process_count: int = 1):
        assert cfg.global_batch % process_count == 0
        self.cfg = cfg
        self.process_index = process_index
        self.process_count = process_count
        self.local_batch = cfg.global_batch // process_count
        self._step = 0

    # -- checkpointable state ------------------------------------------------
    def state(self) -> dict:
        return {"step": self._step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "data seed mismatch"
        self._step = int(state["step"])

    # -- batch generation -----------------------------------------------------
    def _batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rows = []
        base = self.process_index * self.local_batch
        for r in range(self.local_batch):
            rng = np.random.default_rng(
                (cfg.seed, step, base + r)
            )
            toks = np.empty(cfg.seq_len + 1, np.int32)
            toks[0] = rng.integers(cfg.vocab)
            a, c = 6364136223846793005 % cfg.vocab or 1, 1442695040888963407 % cfg.vocab
            rand_mask = rng.random(cfg.seq_len) >= cfg.structure
            rand_toks = rng.integers(cfg.vocab, size=cfg.seq_len)
            for t in range(cfg.seq_len):
                toks[t + 1] = (
                    rand_toks[t] if rand_mask[t]
                    else (a * int(toks[t]) + c) % cfg.vocab
                )
            rows.append(toks)
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        return self

    def __next__(self) -> dict[str, np.ndarray]:
        b = self._batch_at(self._step)
        self._step += 1
        return b


class Prefetcher:
    """Background-thread prefetch with bounded queue (overlap host prep).

    Shutdown contract: the worker never blocks indefinitely in ``q.put``
    (it re-checks the stop event on a timeout), ``close()`` drains the
    queue *while joining* the worker — a one-shot drain would let a
    producer blocked under backpressure repopulate the queue and leak the
    thread — and a producer exception is re-raised by ``close()`` (as
    well as by ``__next__``) instead of being swallowed with the drained
    sentinel.
    """

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Exception | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Bounded put that gives up when the stop event is set."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except Exception as e:
            self._err = e
        finally:
            # end-of-stream sentinel: wakes a consumer blocked in q.get
            # (carrying _err if set).  _put keeps retrying a full queue
            # until it lands or close() takes over the shutdown.
            self._put(None)

    def __iter__(self):
        return self

    def _end_of_stream(self):
        """Raise the producer's error (delivered once) or StopIteration."""
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        raise StopIteration

    def __next__(self):
        # Never block on a queue no one will refill: once the worker is
        # gone (close() drained its sentinel, or it died) an empty queue
        # is end-of-stream, not "wait for more".
        while True:
            try:
                item = self._q.get(timeout=0.05)
                break
            except queue.Empty:
                if self._stop.is_set() or not self._thread.is_alive():
                    # the worker may have published its final item(s) and
                    # exited between our Empty and the liveness check —
                    # drain before declaring end-of-stream
                    try:
                        item = self._q.get_nowait()
                        break
                    except queue.Empty:
                        self._end_of_stream()
        if item is None:
            self._end_of_stream()
        return item

    def close(self, timeout: float = 5.0):
        """Stop and join the worker; re-raise a pending producer error.

        Drains the queue in lockstep with the join so a worker blocked in
        ``q.put`` under backpressure gets unblocked, observes the stop
        event, and exits — then drains whatever it published last (incl.
        the ``None`` sentinel) so nothing keeps the thread referenced.
        """
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        if self._thread.is_alive():                  # pragma: no cover
            log.warning("Prefetcher worker did not exit within %.1fs "
                        "(producer stuck outside q.put?)", timeout)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._err is not None:
            # deliver once: a repeated close() (e.g. in a finally block)
            # must be a no-op, not re-raise and mask a primary exception
            err, self._err = self._err, None
            raise err

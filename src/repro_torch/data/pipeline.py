"""Data pipeline (the port of ``repro.data.pipeline``): the paper's steps
(2) data loading, (3) data preparation and (4) host->device transfer, with
a background producer thread and a bounded queue so that 2-3 hide behind
the previous step's compute, and per-batch timings that feed R_O
(Lemma 3.1).

The corpus and the token stream are the JAX package's, draw for draw: a
seeded zipfian numpy stream with a deterministic n-gram pattern, cut into
(batch, seq + 1) windows, with ``skip_batches`` fast-forwarding through the
same path.  Step 4 copies through pinned host memory onto the run's
device (or onto one device per data-parallel rank, a shard each).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.obs.trace import PROFILER_TRACER, Tracer, monotonic


@dataclass
class BatchTimes:
    data_load: float = 0.0
    data_prep: float = 0.0
    h2d: float = 0.0


class SyntheticCorpus:
    """Deterministic zipfian token shards, optionally persisted to disk
    (so step-2 'data loading' does real file I/O when a cache dir is set)."""

    def __init__(self, vocab: int, shard_tokens: int = 1 << 20,
                 cache_dir: Optional[str] = None, seed: int = 0):
        self.vocab = vocab
        self.shard_tokens = shard_tokens
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.seed = seed
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)

    def load_shard(self, idx: int) -> np.ndarray:
        if self.cache_dir:
            p = self.cache_dir / f"shard_{idx:05d}.npy"
            if p.exists():
                return np.load(p)
        rng = np.random.default_rng(self.seed + idx)
        # zipf-ish distribution clipped to vocab
        z = rng.zipf(1.3, size=self.shard_tokens)
        toks = (z % self.vocab).astype(np.int32)
        # deterministic n-gram structure so a model can learn something
        toks[1::7] = (toks[::7][: len(toks[1::7])] * 31 + 17) % self.vocab
        if self.cache_dir:
            np.save(self.cache_dir / f"shard_{idx:05d}.npy", toks)
        return toks


Placement = Union[str, torch.device, Sequence[Union[str, torch.device]]]


class PrefetchLoader:
    """Steps 2-4 with a background producer thread + bounded queue (double
    buffering).  ``__next__`` returns (device_batch, BatchTimes).

    ``device`` is one device (each value of the batch is a tensor there)
    or a list of devices, one per data-parallel rank: each value is then
    split into equal shards along the batch dim, shard r on device r (the
    JAX loader's ``sharding`` over the data axis).  ``shard=(r, world)``
    (one process per rank) splits the global batch into ``world`` shards
    and yields shard r alone, on the one device of ``device``: the same
    tokens that shard r of the all-ranks loader gets.

    ``tracer`` (None: ``obs.trace.PROFILER_TRACER``) gets a ``data/wait``
    span a batch around the wait for the producer (it was late) and a
    ``data/h2d`` span around the copy and the device synchronize after
    it, which drains the previous step's kernels."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 device: Placement = "cuda",
                 corpus: Optional[SyntheticCorpus] = None, depth: int = 2,
                 seed: int = 0, skip_batches: int = 0,
                 shard: Optional[Tuple[int, int]] = None,
                 tracer: Optional[Tracer] = None):
        self.cfg = cfg
        self.tracer = PROFILER_TRACER if tracer is None else tracer
        self.batch = batch
        self.seq = seq
        self.sharded = isinstance(device, (list, tuple))
        devices = list(device) if self.sharded else [device]
        self.devices: List[torch.device] = [resolve_device(d) for d in devices]
        if shard is not None and (len(self.devices) != 1
                                  or not 0 <= shard[0] < shard[1]):
            raise ValueError(f"shard {shard} needs one device and 0 <= rank "
                             "< world")
        self.shard = shard
        n = shard[1] if shard is not None else len(self.devices)
        if batch % n:
            raise ValueError(f"batch {batch} does not split into {n} equal "
                             "shards")
        self.corpus = corpus or SyntheticCorpus(cfg.vocab_size, seed=seed)
        self.skip_batches = int(skip_batches)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._shard_idx = 0
        self._buf = np.zeros((0,), np.int32)
        self._thread.start()

    # -- producer (steps 2 & 3) ------------------------------------------
    def _fill(self, n_tokens: int) -> np.ndarray:
        while self._buf.size < n_tokens:
            shard = self.corpus.load_shard(self._shard_idx)
            self._shard_idx += 1
            self._buf = np.concatenate([self._buf, shard])
        out, self._buf = self._buf[:n_tokens], self._buf[n_tokens:]
        return out

    def _producer(self):
        k = self.cfg.num_codebooks or 0
        need = self.batch * (self.seq + 1) * max(k, 1)
        # resume: the stream is a pure function of (seed, consumption
        # order), so skipping N batches through the SAME _fill path leaves
        # _buf/_shard_idx exactly as N real batches would
        for _ in range(self.skip_batches):
            if self._stop.is_set():
                return
            self._fill(need)
        while not self._stop.is_set():
            t0 = monotonic()
            raw = self._fill(need)
            t_load = monotonic() - t0

            t0 = monotonic()
            shape = (self.batch, self.seq + 1) + ((k,) if k else ())
            arr = raw.reshape(shape)
            batch: Dict[str, np.ndarray] = {
                "tokens": np.ascontiguousarray(arr[:, :-1]),
                "labels": np.ascontiguousarray(arr[:, 1:]),
            }
            if self.cfg.num_image_tokens:
                rng = np.random.default_rng(self._shard_idx)
                batch["image_embeds"] = rng.standard_normal(
                    (self.batch, self.cfg.num_image_tokens, self.cfg.d_model),
                    dtype=np.float32) * 0.02
            t_prep = monotonic() - t0
            # retry the SAME batch until there is room: dropping it on a
            # timeout would make the stream depend on the step wall clock
            while not self._stop.is_set():
                try:
                    self.q.put((batch, t_load, t_prep), timeout=0.2)
                    break
                except queue.Full:
                    continue

    # -- consumer (step 4) -------------------------------------------------
    def __iter__(self) -> Iterator:
        return self

    def _h2d(self, arr: np.ndarray, dev: torch.device) -> torch.Tensor:
        t = torch.from_numpy(arr)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t

    def __next__(self):
        with self.tracer.span("data/wait"):
            batch, t_load, t_prep = self.q.get()
        t0 = monotonic()
        n = len(self.devices)
        out = {}
        with self.tracer.span("data/h2d"):
            for k, v in batch.items():
                if self.shard is not None:
                    shards = [np.split(v, self.shard[1])[self.shard[0]]]
                else:
                    shards = np.split(v, n) if self.sharded else [v]
                moved = [self._h2d(s, d)
                         for s, d in zip(shards, self.devices)]
                out[k] = moved if self.sharded else moved[0]
            for d in {d for d in self.devices if d.type == "cuda"}:
                torch.cuda.synchronize(d)
        t_h2d = monotonic() - t0
        return out, BatchTimes(t_load, t_prep, t_h2d)

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

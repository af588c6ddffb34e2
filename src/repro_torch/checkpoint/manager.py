"""Serialized async checkpointing on top of :mod:`repro_torch.checkpoint.io`
(the port of ``repro.checkpoint.manager``).

``CheckpointManager`` owns one long-lived writer thread fed by a queue:
saves are serialized in submission order, ``wait()`` blocks until the
queue is drained, and an ``atexit`` hook drains it before the interpreter
goes away so a non-blocking save near the end of a run still lands on
disk.

Leaves are copied to host numpy arrays on the *caller's* thread at
enqueue time, so the writer never touches live tensors: the port's AdamW
updates the parameters and moments in place, and a CPU tensor's
``.numpy()`` shares its storage, so without the copy the next step would
write into an in-flight save.  On a card that copy is the device-to-host
transfer, the stall a training step pays for a save: it is the
``ckpt_enqueue`` span, and the writer's disk time the ``ckpt_write``
span, when the manager is given a tracer.
"""
from __future__ import annotations

import atexit
import queue
import threading
from pathlib import Path
from typing import Optional

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.obs.trace import NULL_TRACER, Tracer


class CheckpointManager:
    """Atomic, serialized, optionally-async checkpoint saves.

    Parameters
    ----------
    directory:
        Where step files and the manifest live (created on first save).
    tracer:
        Optional; records the ``ckpt_enqueue`` and ``ckpt_write`` spans.
    """

    def __init__(self, directory: str, tracer: Optional[Tracer] = None):
        self.directory = str(directory)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._queue: "queue.Queue" = queue.Queue()
        self._last_step: Optional[int] = None
        self._errors: list = []
        self._lock = threading.Lock()
        self._worker: Optional[threading.Thread] = None
        self._closed = False
        atexit.register(self.close)

    # -- internals -------------------------------------------------------
    def _ensure_worker(self):
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(
                target=self._drain, name="ckpt-writer", daemon=True)
            self._worker.start()

    def _write(self, step: int, flat) -> None:
        with self.tracer.span("ckpt_write", step=step):
            ckpt_io._write_step(Path(self.directory), step, flat)

    def _drain(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                self._write(*item)
            except Exception as exc:  # surfaced on wait()/next save
                with self._lock:
                    self._errors.append(exc)
            finally:
                self._queue.task_done()

    def _raise_pending(self):
        with self._lock:
            if self._errors:
                exc = self._errors[0]
                self._errors.clear()
                raise RuntimeError("async checkpoint save failed") from exc

    # -- public API ------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False) -> None:
        """Save ``tree`` as checkpoint ``step``.

        Steps must be strictly increasing per manager; the host copy
        happens here, synchronously, so the caller may update the tensors
        it passed in as soon as this returns.
        """
        if self._closed:
            raise RuntimeError("CheckpointManager is closed")
        step = int(step)
        if self._last_step is not None and step <= self._last_step:
            raise ValueError(
                f"checkpoint steps must be strictly increasing: got {step} "
                f"after {self._last_step}")
        self._raise_pending()
        self._last_step = step
        Path(self.directory).mkdir(parents=True, exist_ok=True)
        if blocking:
            self._write(step, ckpt_io._flatten(tree))
            return
        with self.tracer.span("ckpt_enqueue", step=step):
            flat = ckpt_io._flatten(tree, copy=True)
        self._ensure_worker()
        self._queue.put((step, flat))

    def wait(self) -> None:
        """Block until every queued save has hit the disk (then re-raise
        the first writer-thread failure, if any)."""
        self._queue.join()
        self._raise_pending()

    def close(self) -> None:
        """Drain outstanding saves and stop the writer thread.  Idempotent;
        also runs via ``atexit`` so shutdown never loses a queued save."""
        if self._closed:
            return
        self._queue.join()
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
            self._worker.join(timeout=30.0)
        self._closed = True
        atexit.unregister(self.close)
        self._raise_pending()

    def latest_step(self) -> Optional[int]:
        return ckpt_io.latest_step(self.directory)

    def restore(self, template, step: Optional[int] = None):
        """See :func:`repro_torch.checkpoint.io.restore`; waits for queued
        saves first so a restore never misses a save submitted before
        it."""
        self.wait()
        return ckpt_io.restore(template, self.directory, step)

"""Background-thread prefetcher: overlap host batch synthesis with device
compute (the CPU-side analogue of tf.data prefetch)."""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


class Prefetcher:
    """Pulls `make_batch(step)` on a worker thread, `depth` batches ahead,
    and yields (step, batch) in step order. A worker's exception is raised
    at the consumer; `close` stops the worker."""

    def __init__(self, make_batch: Callable[[int], object], depth: int = 2,
                 start_step: int = 0, num_steps: Optional[int] = None):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._start = start_step
        self._num = num_steps
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._start
        while not self._stop.is_set():
            if self._num is not None and step >= self._start + self._num:
                self._put(None)
                return
            try:
                item = (step, self._make(step))
            except Exception as e:  # surface worker errors at the consumer
                self._put(e)
                return
            self._put(item)
            step += 1

    def _put(self, item) -> None:
        """Queue `item`, giving up once `close` is called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

"""Host data loading: prefetch, and placement with target shardings.

Counterpart of `repro.data.pipeline`.  Every rank reads the global batch
from its host iterator (a step-keyed, seeded stream gives every rank the
same batch) and keeps its own slice of each leaf on its device
(`sharding.place`: no collective); a leaf replicated on every mesh dim
lands whole.  This is the reference's single-controller `device_put`
spread over the ranks of the process group."""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

from repro_torch.sharding import place
from repro_torch.tree import tree_map

_DONE = object()


class ShardedHostLoader:
    """Wraps a host batch iterator: a background prefetch thread that
    places each batch by `shardings` (a tree of `NamedSharding` matching
    the batch).

    prefetch=2 keeps one batch in flight while the step runs: the
    standard input-pipeline/compute overlap.  A failure of the iterator or
    of the placement is raised to the consumer at the batch where it
    happened; `close()` stops the thread."""

    def __init__(self, it: Iterator, shardings: Any, prefetch: int = 2):
        self._it = it
        self._shardings = shardings
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item` unless closed; False once close() was called."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                placed = tree_map(place, batch, self._shardings)
                if not self._put(placed):
                    return
        except Exception as e:     # surface loader failures to the consumer
            self._put(e)
            return
        self._put(_DONE)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _DONE:
            self._q.put(_DONE)          # later calls stop again
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        self._thread.join(timeout=10)

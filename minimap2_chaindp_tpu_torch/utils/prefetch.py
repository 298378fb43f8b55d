"""Pipeline-parallel prefetching — the TPU-framework analog of the
reference's kt_pipeline (kthread.c:225) and its double-buffered index reader
(read_task_thread/map_task_thread, main.c:133-275): a background thread
stays `depth` items ahead of the consumer, so sequence IO / index building
for batch k+1 overlaps mapping of batch k."""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate `it` on a background thread, buffering up to `depth` items."""
    q: queue.Queue = queue.Queue(maxsize=max(depth, 1))

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # deliver the producer's exception
            q.put((_SENTINEL, e))
            return
        q.put((_SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
            if item[1] is not None:
                raise item[1]
            return
        yield item

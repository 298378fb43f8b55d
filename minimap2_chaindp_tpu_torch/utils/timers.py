"""Per-stage wall-clock instrumentation and counters.

The TPU-native analog of the reference's hand-rolled telemetry
(realtime_msec copies, result_time/send_task/process_result/soft_chaindp
accumulators, main.c:110-116 & :629-663): named stage timers, counters
(device reads vs host fallbacks ~ soft_chaindp_num), and a summary printer."""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class Timers:
    def __init__(self):
        self.acc: dict[str, float] = defaultdict(float)
        self.n: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        # map_stream runs two batches on a thread pool; += on the dicts is
        # a read-modify-write that loses updates without a lock
        self._lock = threading.Lock()

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.acc[name] += dt
                self.n[name] += 1

    def count(self, name: str, inc: int = 1) -> None:
        with self._lock:
            self.counters[name] += inc

    def summary(self) -> str:
        parts = [f"{k}={v * 1000:.1f}ms/{self.n[k]}" for k, v in
                 sorted(self.acc.items())]
        parts += [f"{k}={v}" for k, v in sorted(self.counters.items())]
        return " ".join(parts)

    def report(self, file=None) -> None:
        import sys
        print(f"[timers] {self.summary()}", file=file or sys.stderr)

"""Host threads (models/runtime.TorchRuntime.map_batch on map_stream's
batch threads): the share of the batch threads' host work spent off a core
(the GIL, locks, page faults): 100 x (1 - thread CPU / wall) summed over
the window's `map_batch` spans, less their `device_wait` descendants (the
waits on the card, on the same thread) in both sums. Reads the program's
spans (`rec["spans"]`, utils/trace.Span), which benchmark/spans.py records;
a record without them gives nothing."""


def read(rec):
    spans = rec.get("spans")
    if not spans:
        return None
    wall = cpu = 0
    for s in spans:
        sign = 1 if s.name == "map_batch" else (
            -1 if s.name == "device_wait" and s.role == "batch" else 0)
        wall += sign * (s.end_ns - s.start_ns)
        cpu += sign * s.cpu_ns
    if wall <= 0:
        return None
    return 100.0 * (1.0 - cpu / wall)

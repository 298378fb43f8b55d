"""Native finish (native.map_unit_text_chains_native in
models/runtime.TorchRuntime._map_batch1): the runtime's `native_finish`
span, summed over its threads, per million query bases of the reads it
finished (`native_finish_bases`). A program without that counter gives
nothing."""


def read(rec):
    n = rec["counters"].get("native_finish_bases", 0)
    if not n or "native_finish" not in rec["timers"]:
        return None
    return rec["timers"]["native_finish"] * 1e3 / (n / 1e6)

"""Staged align (models/pipeline.finish_unit_gen through
models/batch_align.CudaAlignExecutor): the runtime's `align` span per
million query bases, where the staged path carries the window (more
`staged_frags` than `native_finish`)."""


def read(rec):
    c = rec["counters"]
    if not rec["bases"] or c.get("staged_frags", 0) <= c.get(
            "native_finish", 0) or "align" not in rec["timers"]:
        return None
    return rec["timers"]["align"] * 1e3 / (rec["bases"] / 1e6)

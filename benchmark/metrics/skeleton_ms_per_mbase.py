"""Staged align (models/batch_align.run_scheduler): the runtime's
`skeleton` spans, one a scheduler round around the align generators'
next/send (the Python align skeleton), summed over its threads, per
million query bases of the window."""


def read(rec):
    if not rec["bases"] or "skeleton" not in rec["timers"]:
        return None
    return rec["timers"]["skeleton"] * 1e3 / (rec["bases"] / 1e6)

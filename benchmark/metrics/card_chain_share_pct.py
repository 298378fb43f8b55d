"""Routing (models/runtime.py): the share of the window's fragments whose
chains the card's kernel made, fused flow (`device_reads`) and staged path
(`staged_device_reads`), from the runtime's counters."""


def read(rec):
    if not rec["frags"]:
        return None
    c = rec["counters"]
    n = c.get("device_reads", 0) + c.get("staged_device_reads", 0)
    return 100.0 * n / rec["frags"]

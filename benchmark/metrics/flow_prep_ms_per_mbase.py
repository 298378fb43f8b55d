"""Fused flow, its host half (models/device_flow.DeviceFlow.buckets): the
runtime's `flow_prep` span (the native key lookup of every read's
minimizers and the fill of each bucket's rows), summed over its threads,
per million query bases of the window."""


def read(rec):
    if not rec["bases"] or "flow_prep" not in rec["timers"]:
        return None
    return rec["timers"]["flow_prep"] * 1e3 / (rec["bases"] / 1e6)

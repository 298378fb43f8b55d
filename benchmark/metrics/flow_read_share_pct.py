"""Fused flow routing (models/device_flow.DeviceFlow.run): the share of the
single-segment units offered to the flow (`flow_units`) that it chained on
the card (`device_reads`), from the runtime's counters. A program without
the `flow_units` counter gives nothing."""


def read(rec):
    c = rec["counters"]
    if not c.get("flow_units"):
        return None
    return 100.0 * c.get("device_reads", 0) / c["flow_units"]

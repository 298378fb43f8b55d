"""Host front (models/pipeline.seed_unit, device_flow.host_seed_stats,
ops/seeds.py): the runtime's `seed` span, summed over its threads, per
million query bases of the window."""


def read(rec):
    if not rec["bases"] or "seed" not in rec["timers"]:
        return None
    return rec["timers"]["seed"] * 1e3 / (rec["bases"] / 1e6)

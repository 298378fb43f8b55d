"""Extension waves, their host half (ops/ksw2_ext._batch_async under
models/batch_align.CudaAlignExecutor's `ext_wave` span): the runtime's
spans `ext_pack`, `ext_upload`, `ext_launch` and `ext_decode` (the
read-back copy and the CIGAR decode), the children of `ext_wave` but its
`device_wait`, summed over its threads, per million query bases of the
window."""

HOST_HALF = ("ext_pack", "ext_upload", "ext_launch", "ext_decode")


def read(rec):
    t = rec["timers"]
    if not rec["bases"] or not all(k in t for k in HOST_HALF):
        return None
    return sum(t[k] for k in HOST_HALF) * 1e3 / (rec["bases"] / 1e6)

"""ksw2 kernels (csrc/ksw2.cu, forward and walk, via ops/ksw2_ext.py): the
least time of every extension batch of the window (benchmark/roofline.py,
from its jobs and results) over the device time of the forward kernels and
ksw_walk_kernel in the trace."""


def read(rec):
    dev = rec["device"]
    if not dev or dev["kernel_s"]["ksw"] <= 0 or dev["least_s"]["ksw"] <= 0:
        return None
    return 100.0 * dev["least_s"]["ksw"] / dev["kernel_s"]["ksw"]

"""Chain kernel (csrc/chain_dp.cu via ops/chain_dp.py): the least time of
every chain launch of the window (benchmark/roofline.py, from each launch's
inputs) over the device time of chain_staged_kernel and chain_warp_kernel in
the trace."""


def read(rec):
    dev = rec["device"]
    if not dev or dev["kernel_s"]["chain"] <= 0 or dev["least_s"]["chain"] <= 0:
        return None
    return 100.0 * dev["least_s"]["chain"] / dev["kernel_s"]["chain"]

"""Device: the share of the traced window in which no kernel, copy or set
ran on the card (torch.profiler, CUPTI)."""


def read(rec):
    dev = rec["device"]
    if not dev or dev["window_s"] <= 0 or dev["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / dev["window_s"])

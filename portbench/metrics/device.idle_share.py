"""Device: the share of the traced window in which no kernel, copy or
fill ran on the card (torch.profiler's CUDA activity), in %."""


def read(r):
    d = r["device"]
    if d is None or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])

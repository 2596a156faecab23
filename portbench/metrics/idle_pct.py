"""The device's idle share of the profiled window: 100 (1 - busy / wall)."""


def read(r):
    if r.window_s <= 0 or not r.device:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)

"""The device's idle share of the traced part of the window, in %."""


def read(rec):
    t = rec.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

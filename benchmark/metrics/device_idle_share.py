"""The device's idle share of the traced window, in %: 100 x (1 - the
union of the device operations' intervals / the window), averaged over
the devices."""

from benchmark.yardstick.timeline import busy_s_per_device


def read(run):
    tl = run.get("timeline")
    if tl is None or not tl.device:
        return None
    busy_s = busy_s_per_device(tl)
    return 100.0 * (1.0 - busy_s / run["traced_window_s"])

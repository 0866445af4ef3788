"""device_idle: the share of the profiled fits' host window in which no
kernel, copy or memset ran on the card (the union of the trace's device
intervals against the window's length), in percent."""


def read(record):
    dev = record.get("device")
    if not dev or not dev.get("busy_s") or not dev.get("window_s"):
        return None
    return 100.0 * max(0.0, 1.0 - dev["busy_s"] / dev["window_s"])

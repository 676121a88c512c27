"""Share of the traced window in which no kernel, copy or memset ran on
the card (profiler), in percent."""


def read(record):
    device = record.get("device")
    if device is None or device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - device["busy_s"] / device["window_s"])

"""Mean host time of a request: each ``stage.route_bytes`` span of the
window less the time the device was busy inside it (profiler), in ms."""
import numpy as np

from portbench.trace import covered


def read(record):
    device = record.get("device")
    if device is None:
        return None
    spans = np.asarray(record["spans"].named(
        "stage.route_bytes", record["t_open"], record["t_close"]), np.int64)
    if not spans.size:
        return None
    host = (spans[:, 1] - spans[:, 0]) - covered(device["busy"], spans[:, 0],
                                                 spans[:, 1])
    return float(host.mean()) / 1e6

"""The whole window's share of the chip's peak: the least time all the
window's documents need (``portbench/roofline.py``) over the traced
window's seconds, in percent."""
from portbench.roofline import share_pct


def read(record):
    device = record.get("device")
    if device is None:
        return None
    return share_pct(record["work_ops"], record["work_bytes"],
                     device["window_s"])

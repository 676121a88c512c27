"""K3 (``bytes_kernel<SparseOut>``): the least time the window's messages
need at the chip's peaks (``portbench/roofline.py``) over the kernel's
device time in the profiler, in percent."""
import re

from portbench.roofline import share_pct

# a name such as "void (anonymous namespace)::bytes_kernel<(anonymous
# namespace)::SparseOut, 1>(unsigned char const*, ...)"
KERNEL = re.compile(r"\bbytes_kernel<[^,>]*\bSparseOut\b")


def read(record):
    device = record.get("device")
    if device is None:
        return None
    seconds = sum(s for n, s in device["kernels"].items() if KERNEL.search(n))
    return share_pct(record["work_ops"], record["work_bytes"], seconds)

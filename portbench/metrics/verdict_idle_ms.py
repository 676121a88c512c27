"""Idle time of the card a request under the program's ``engine.launch``,
``engine.readback`` and ``engine.scatter`` spans (the kernel's host
dispatch, the lane → query gather and the blocking copies back, the
scatter to batch order), in ms (``portbench/program_spans.py``)."""
from portbench.program_spans import idle_ms


def read(record):
    return idle_ms(record, "verdict")

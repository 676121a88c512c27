"""Idle time of the card a request under the program's ``stage.pack`` and
``engine.prep`` spans (packing the payloads, segment starts and the
event bound), in ms (``portbench/program_spans.py``)."""
from portbench.program_spans import idle_ms


def read(record):
    return idle_ms(record, "pack")

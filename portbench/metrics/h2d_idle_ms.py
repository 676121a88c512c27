"""Idle time of the card a request under the program's ``engine.h2d``
spans (the pinned copy and the dispatch of the copy to the card), in ms
(``portbench/program_spans.py``)."""
from portbench.program_spans import idle_ms


def read(record):
    return idle_ms(record, "h2d")

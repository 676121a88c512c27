"""Share of the window's idle time of the card under none of the spans
the four ``*_idle_ms`` metrics read: a ``stage.request`` alone, another
program span, or no program span, in percent
(``portbench/program_spans.py``)."""
from portbench.program_spans import unattributed_pct


def read(record):
    return unattributed_pct(record)

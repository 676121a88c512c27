"""Idle time of the card a request under the program's ``stage.fan_out``
spans (verdicts → routed documents), in ms
(``portbench/program_spans.py``)."""
from portbench.program_spans import idle_ms


def read(record):
    return idle_ms(record, "fan_out")

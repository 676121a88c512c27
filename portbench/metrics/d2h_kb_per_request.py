"""Mean ``d2h_bytes`` counter of the window's ``stage.request`` spans:
the bytes a request reads back from the card in its counted blocking
reads (``readbacks``), in kB (``portbench/program_spans.py``)."""
from portbench.program_spans import per_request


def read(record):
    n = per_request(record, "d2h_bytes")
    return None if n is None else n / 1e3

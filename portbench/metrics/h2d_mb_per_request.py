"""Mean ``h2d_bytes`` counter of the window's ``stage.request`` spans:
the bytes a request stages to the card through ``to_device``, in MB
(``portbench/program_spans.py``)."""
from portbench.program_spans import per_request


def read(record):
    n = per_request(record, "h2d_bytes")
    return None if n is None else n / 1e6

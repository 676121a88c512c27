"""Mean ``readbacks`` counter of the window's ``stage.request`` spans: the
blocking device → host reads a request (``portbench/program_spans.py``)."""
from portbench.program_spans import per_request


def read(record):
    return per_request(record, "readbacks")

"""Mean ``launches`` counter of the window's ``stage.request`` spans: the
calls a request makes to the hand-written kernels' wrappers
(``count_launch``), not the kernels the card runs, since one call may
start several (K2's entry point starts ``build_entries``, then
``bytes_kernel``) (``portbench/program_spans.py``)."""
from portbench.program_spans import per_request


def read(record):
    return per_request(record, "launches")

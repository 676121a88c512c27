"""Mean ``k2_chains`` counter of the window's ``stage.request`` spans: the
(segment, state block, piece) chains a request's K2 launches run, G·S·P
(``portbench/program_spans.py``).  ``None`` where no request counted
chains: a program that does not count them."""
from portbench.program_spans import per_request, summary


def read(record):
    s = summary(record)
    if s is None or not any("k2_chains" in r.attrs for r in s["requests"]):
        return None
    return per_request(record, "k2_chains")

"""The ``k2_chains_per_request`` reader on synthetic spans: the mean of
the requests' ``k2_chains`` counters, and nothing where no request
counted chains (a program without the counter) or in a window without
requests."""
import pytest

from portbench import spec
from portbench.test_portbench_program_spans import _record, _span
from repro_torch import tracing


def _requests(*chains):
    """One request span a value of ``chains`` (``None``: no counter),
    each 100 ns, with a child span under it."""
    out = []
    for k, n in enumerate(chains):
        attrs = {} if n is None else {"k2_chains": n}
        out.append(_span("stage.request", 2 * k + 1, None, 110 * k,
                         110 * k + 100, launches=1, **attrs))
        out.append(_span("engine.launch", 2 * k + 2, 2 * k + 1,
                         110 * k + 35, 110 * k + 40))
    return out


@pytest.mark.parametrize("chains, want", [
    ((528, 528), 528.0),       # P = 3 over G·S = 176
    ((176, 528), 352.0),
    ((None, None), None),      # the counter is not in the program
    ((), None),                # no request in the window
])
def test_k2_chains_per_request(monkeypatch, chains, want):
    spans = _requests(*chains)
    monkeypatch.setattr(tracing, "spans", lambda *a: list(spans))
    monkeypatch.setattr(tracing, "dropped", lambda: 0)
    assert spec.reader("k2_chains_per_request")(_record()) == want


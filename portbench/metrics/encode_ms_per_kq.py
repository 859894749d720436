"""Host milliseconds a thousand queries of the program's query encoding
(self time of its ``serve.encode`` spans) in the traced sub-window."""

from portbench import spans


def read(run):
    found = spans.traced(run)
    answered = run.traced_window.answered if run.traced_window is not None else 0
    if found is None or not answered:
        return None
    us = sum(t for s, t in spans.self_us(found) if s.name == "serve.encode")
    return us / 1e3 / (answered / 1000)

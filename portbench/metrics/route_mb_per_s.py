"""Payload MB (10^6 bytes) of the documents routed in the window, over
the window's seconds (host clock)."""


def read(record):
    return record["bytes"] / 1e6 / record["window_s"]

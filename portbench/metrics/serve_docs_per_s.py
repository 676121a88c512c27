"""Messages whose verdicts came in the window, over the window's seconds
(host clock)."""


def read(record):
    return record["docs"] / record["window_s"]

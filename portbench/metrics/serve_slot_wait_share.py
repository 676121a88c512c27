"""Batches of the window whose dispatch waited for one of the loop's
in-flight slots: ``backpressure_waits`` over ``batches``, the serve
loop's own counters, taken as the window opened and closed."""


def read(record):
    if "loop_after" not in record:
        return None
    before, after = record["loop_before"], record["loop_after"]
    batches = after["batches"] - before["batches"]
    if batches <= 0:
        return None
    return (after["backpressure_waits"] - before["backpressure_waits"]) \
        / batches

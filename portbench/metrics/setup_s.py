"""Seconds from the harness's first statement to the window's first
request: input generation, the stage's build, the kernels' build or
load, and the warm-up."""


def read(record):
    return record["setup_s"]

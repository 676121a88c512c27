"""The benchmark's plain reference: a NumPy and Python filter and router
that decides, independently of the program under test, which shards and
subscribers each document reaches."""

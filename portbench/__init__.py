"""The port's benchmark: one command runs one cell (``run.py``)."""

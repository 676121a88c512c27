"""Frozen input generators of the benchmark (see ``grammar``)."""

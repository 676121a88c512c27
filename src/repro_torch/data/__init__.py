"""Data plane: synthetic XML workloads and the pub-sub filter stage."""
from .generator import DTD, gen_document, gen_profiles  # noqa: F401

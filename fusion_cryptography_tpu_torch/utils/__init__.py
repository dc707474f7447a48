"""Utilities: profiling and tracing hooks and structured logging (the port of
the JAX package's ``utils``)."""
from .log import get_logger
from .profiling import count, counters, reset_counters, span, trace

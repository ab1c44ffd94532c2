"""Fault tolerance: failure injection and straggler detection. The elastic
re-mesh (`ft/elastic.py` in the JAX package) needs a device mesh and is
not ported yet."""

from repro_torch.ft.failures import (  # noqa: F401
    FailureEvent,
    FailureInjector,
    StragglerMonitor,
)

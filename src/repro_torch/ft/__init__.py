"""Fault tolerance: failure injection, straggler detection, elastic
re-mesh."""

from repro_torch.ft.failures import (  # noqa: F401
    FailureEvent,
    FailureInjector,
    StragglerMonitor,
)
from repro_torch.ft.elastic import elastic_data_size, shrink_mesh  # noqa: F401

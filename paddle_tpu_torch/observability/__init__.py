"""Runtime telemetry of the port: stdlib-only copies of
``paddle_tpu/observability/{metrics,trace,flight,tenant_ledger,
timeseries}.py`` (the engine's counters, spans, decision ring, request
timelines and tenant ledger).  Relative imports only."""
from __future__ import annotations

from . import flight, metrics, tenant_ledger, timeseries, trace  # noqa: F401

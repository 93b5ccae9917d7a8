"""The observability layer (the JAX package's ``observe/``):

- ``trace``    — trace/span ids + the bounded span ring (``TRACER``)
- ``metrics``  — labelled counters/gauges/histograms with
  snapshot/delta semantics (``METRICS``), mirrored onto the flat
  ``core.profiling.TIMERS`` names via the ``flat=`` helpers
- ``export``   — Prometheus text dump, the JSONL event log and the
  TensorBoard bridge (``publish_to_summary``)
- ``recorder`` — the SLO-watching flight recorder
"""

from analytics_zoo_tpu_torch.observe.export import (  # noqa: F401
    JsonlEventLog, parse_prometheus, publish_to_summary, to_prometheus)
from analytics_zoo_tpu_torch.observe.metrics import (  # noqa: F401
    CATALOG, METRICS, MetricsRegistry, MetricsSnapshot, count, observe,
    render_series, set_gauge, time_stage)
from analytics_zoo_tpu_torch.observe.recorder import (  # noqa: F401
    SLO, FlightRecorder)
from analytics_zoo_tpu_torch.observe.trace import (  # noqa: F401
    TRACER, Span, Tracer, find_orphans, span)

"""Observability for the port (counterpart of ``repro.obs``):

  * ``obs.telemetry`` — per-step device columns recorded by the enactor
    loops, read once at the end;
  * ``obs.tracing`` — host phase spans, fenced on the card, as Chrome
    trace-event JSON and as ``torch.profiler`` ranges;
  * ``obs.metrics`` — log-bucket histograms, counters and gauges with a
    Prometheus text exposition;
  * ``obs.log`` — the one logger the CLIs' diagnostics go through.
"""
from . import log, metrics, telemetry, tracing
from .log import configure, get_logger
from .metrics import Histogram, Metrics, latency_summary, quantile
from .telemetry import (TelemetryBuffer, TelemetryTrace, distributed_trace,
                        trim)
from .tracing import (SpanRegistry, export_chrome_trace, registry, reset,
                      span, timed_span)

__all__ = [
    "log", "metrics", "telemetry", "tracing",
    "configure", "get_logger",
    "Histogram", "Metrics", "latency_summary", "quantile",
    "TelemetryBuffer", "TelemetryTrace", "distributed_trace", "trim",
    "SpanRegistry", "export_chrome_trace", "registry", "reset", "span",
    "timed_span",
]

"""Serving metrics (counterpart of ``repro.obs.metrics``): streaming
log-bucket histograms, gauges, counters, and a Prometheus text
exposition.

Plain Python and numpy, copied from the reference so that the same
observations give the same quantiles and the same text:

  * ``Histogram`` — fixed geometric buckets, O(1) memory, mergeable
    across streams of one layout; quantiles interpolate inside the
    winning bucket, clamped to the observed [min, max].
  * ``quantile`` / ``latency_summary`` — linear-interpolated quantiles
    of raw samples, always beside their sample count.
  * ``Metrics`` — a label-aware registry (counter / gauge / histogram)
    whose ``render()`` is Prometheus text: cumulative ``_bucket{le=…}``
    series, ``_sum`` / ``_count``, and p50/p95/p99 gauges per label set.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Tuple

import numpy as np

# default layout: 0.01 ms .. ~164 s in quarter-decade-ish steps
DEFAULT_LO = 0.01
DEFAULT_GROWTH = 2.0 ** 0.5
DEFAULT_BUCKETS = 48


def quantile(samples, q: float) -> float:
    """Linear-interpolated quantile of raw samples (the small-sample
    fix: never a bare extreme order statistic)."""
    arr = np.asarray(list(samples) if not isinstance(samples, np.ndarray)
                     else samples, dtype=np.float64)
    if arr.size == 0:
        return float("nan")
    try:
        return float(np.quantile(arr, q, method="linear"))
    except TypeError:          # numpy < 1.22 spelling
        return float(np.quantile(arr, q, interpolation="linear"))


def latency_summary(samples, prefix: str = "lat_ms") -> Dict[str, float]:
    """The serving loop's per-stream summary row: mean + interpolated
    p50/p95/p99 + the sample count they were computed from."""
    arr = np.asarray(list(samples) if not isinstance(samples, np.ndarray)
                     else samples, dtype=np.float64)
    n = int(arr.size)
    if n == 0:
        return {"samples": 0}
    return {
        "samples": n,
        f"{prefix}_mean": round(float(arr.mean()), 2),
        f"{prefix}_p50": round(quantile(arr, 0.50), 2),
        f"{prefix}_p95": round(quantile(arr, 0.95), 2),
        f"{prefix}_p99": round(quantile(arr, 0.99), 2),
    }


class Histogram:
    """Streaming histogram over fixed geometric buckets.

    Bucket i covers ``(lo·growth^(i-1), lo·growth^i]``; bucket 0 covers
    ``[0, lo]``; one overflow bucket catches everything past the top
    bound. Two histograms with the same layout merge by adding counts —
    the property that lets per-kind, per-shard, or per-process streams
    aggregate without raw samples.
    """

    def __init__(self, lo: float = DEFAULT_LO,
                 growth: float = DEFAULT_GROWTH,
                 buckets: int = DEFAULT_BUCKETS):
        assert lo > 0 and growth > 1 and buckets >= 1
        self.lo = float(lo)
        self.growth = float(growth)
        self.counts = np.zeros(buckets + 1, np.int64)  # [+overflow]
        self.total = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    @property
    def layout(self) -> Tuple[float, float, int]:
        return (self.lo, self.growth, len(self.counts) - 1)

    def bounds(self) -> np.ndarray:
        """Upper bound of each finite bucket."""
        k = len(self.counts) - 1
        return self.lo * self.growth ** np.arange(k)

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = int(math.ceil(math.log(v / self.lo) / math.log(self.growth)))
        return min(i, len(self.counts) - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[self._index(v)] += 1
        self.total += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def observe_many(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.observe(v)

    def merge(self, other: "Histogram") -> "Histogram":
        if self.layout != other.layout:
            raise ValueError(f"histogram layouts differ: {self.layout} "
                             f"vs {other.layout}")
        self.counts += other.counts
        self.total += other.total
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)
        return self

    def quantile(self, q: float) -> float:
        """Linear interpolation inside the winning bucket, clamped to
        the observed [min, max] so small-sample quantiles stay inside
        the data range instead of reporting a bucket bound."""
        if self.total == 0:
            return float("nan")
        q = min(max(q, 0.0), 1.0)
        target = q * self.total
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        i = min(i, len(self.counts) - 1)
        bounds = self.bounds()
        hi = bounds[i] if i < len(bounds) else self.max
        lo = 0.0 if i == 0 else bounds[i - 1]
        prev = 0 if i == 0 else int(cum[i - 1])
        in_bucket = int(self.counts[i])
        frac = ((target - prev) / in_bucket) if in_bucket else 1.0
        est = lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return float(min(max(est, self.min), self.max))

    def summary(self, prefix: str = "lat_ms") -> Dict[str, float]:
        if self.total == 0:
            return {"samples": 0}
        return {
            "samples": self.total,
            f"{prefix}_mean": round(self.sum / self.total, 2),
            f"{prefix}_p50": round(self.quantile(0.50), 2),
            f"{prefix}_p95": round(self.quantile(0.95), 2),
            f"{prefix}_p99": round(self.quantile(0.99), 2),
        }


def _labelkey(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _labelstr(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(round(v, 6))
    return str(v)


@dataclass
class _Family:
    name: str
    kind: str                      # counter | gauge | histogram
    help: str
    series: Dict = field(default_factory=dict)


class Metrics:
    """Label-aware metric registry with Prometheus text rendering."""

    def __init__(self, namespace: str = "graph_serve"):
        self.namespace = namespace
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str) -> _Family:
        full = f"{self.namespace}_{name}" if self.namespace else name
        fam = self._families.get(full)
        if fam is None:
            fam = _Family(name=full, kind=kind, help=help)
            self._families[full] = fam
        elif fam.kind != kind:
            raise ValueError(f"{full} already registered as {fam.kind}")
        return fam

    def counter(self, name: str, value: float = 0.0, help: str = "",
                **labels) -> float:
        """Add ``value`` (default 0 — declares the series so the
        exposition shows it even before the first event) and return the
        running total."""
        fam = self._family(name, "counter", help)
        key = _labelkey(labels)
        fam.series[key] = fam.series.get(key, 0.0) + float(value)
        return fam.series[key]

    def gauge(self, name: str, value: float, help: str = "",
              **labels) -> None:
        fam = self._family(name, "gauge", help)
        fam.series[_labelkey(labels)] = float(value)

    def gauge_max(self, name: str, value: float, help: str = "",
                  **labels) -> None:
        """Keep the running maximum (queue-depth high-water marks)."""
        fam = self._family(name, "gauge", help)
        key = _labelkey(labels)
        fam.series[key] = max(fam.series.get(key, -math.inf),
                              float(value))

    def histogram(self, name: str, help: str = "",
                  lo: float = DEFAULT_LO, growth: float = DEFAULT_GROWTH,
                  buckets: int = DEFAULT_BUCKETS, **labels) -> Histogram:
        """The histogram for one label set (created on first touch)."""
        fam = self._family(name, "histogram", help)
        key = _labelkey(labels)
        h = fam.series.get(key)
        if h is None:
            h = Histogram(lo=lo, growth=growth, buckets=buckets)
            fam.series[key] = h
        return h

    def observe(self, name: str, value: float, help: str = "",
                **labels) -> None:
        self.histogram(name, help=help, **labels).observe(value)

    def render(self) -> str:
        """Prometheus text exposition (one block per family; histogram
        families additionally emit p50/p95/p99 quantile gauges so a
        scrape shows tail latency without server-side bucket math)."""
        lines: List[str] = []
        for fam in self._families.values():
            quant_blocks: List[str] = []
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key in sorted(fam.series):
                val = fam.series[key]
                if fam.kind != "histogram":
                    lines.append(f"{fam.name}{_labelstr(key)} "
                                 f"{_fmt(float(val))}")
                    continue
                h: Histogram = val
                cum = np.cumsum(h.counts)
                for b, ub in zip(cum[:-1], h.bounds()):
                    le = 'le="%s"' % _fmt(float(ub))
                    lines.append(f"{fam.name}_bucket"
                                 f"{_labelstr(key, le)} {int(b)}")
                inf_le = 'le="+Inf"'
                lines.append(f"{fam.name}_bucket"
                             f"{_labelstr(key, inf_le)} {h.total}")
                lines.append(f"{fam.name}_sum{_labelstr(key)} "
                             f"{_fmt(h.sum)}")
                lines.append(f"{fam.name}_count{_labelstr(key)} "
                             f"{h.total}")
                for q in (0.5, 0.95, 0.99):
                    qv = h.quantile(q)
                    if math.isnan(qv):
                        continue
                    ql = 'quantile="%s"' % q
                    quant_blocks.append(
                        f"{fam.name}_quantile"
                        f"{_labelstr(key, ql)} {_fmt(qv)}")
            if quant_blocks:
                lines.append(f"# TYPE {fam.name}_quantile gauge")
                lines.extend(quant_blocks)
        return "\n".join(lines) + "\n"

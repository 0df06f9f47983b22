"""p95_ms: the 95th percentile of the latency of every query answered
in the window, pooled over kinds (host clock, enqueue to the batch's
host copy, as serve_mixed records it)."""
from pb.stats import quantile


def read(rec):
    lat = [r["lat_ms"] for r in rec["records"] if r["status"] == "ok"]
    return quantile(lat, 0.95) if lat else None

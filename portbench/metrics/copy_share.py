"""copy_share: the answer's host copy (serve_mixed's ``copy_ms``, which
also waits for the flush's last device work) over the flush's whole
time (``flush_ms``), summed over the window's flushes, in %."""


def read(rec):
    flush = sum(f["flush_ms"] for f in rec["flushes"])
    if flush <= 0:
        return None
    return 100.0 * sum(f.get("copy_ms", 0.0) for f in rec["flushes"]) / flush

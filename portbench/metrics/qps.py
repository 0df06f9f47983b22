"""qps: queries answered in the window over the window's seconds
(host clock)."""


def read(rec):
    ok = sum(r["status"] == "ok" for r in rec["records"])
    return ok / rec["window_s"]

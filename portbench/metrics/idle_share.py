"""idle_share: 1 - busy / window, in %: busy is the union of every
device interval (kernels, copies, memsets) in the profiler's timeline,
the window its length by the host clock."""


def read(rec):
    if rec.get("busy_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])

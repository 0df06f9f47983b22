"""build_s: ``from_edge_list`` on the benchmark's edge arrays, host clock
around the call, ending in a synchronize."""


def read(rec):
    return rec["build_s"]

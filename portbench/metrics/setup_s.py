"""setup_s: the process's start to the window's start (host clock):
imports, the device's start, the generator, the program's graph build,
the warm-up chunk and, in a checkout's first run, the kernels' build."""


def read(rec):
    return rec["setup_s"]

"""glue_share: device time of the kernels that are not the program's own
hand-written ones (PyTorch's, launched by the operators, the frontier
code and linalg) over the device's busy time, in % (torch.profiler).
Copies and memsets count as busy, not as glue."""


def read(rec):
    if rec.get("busy_s", 0) <= 0:
        return None
    return 100.0 * rec["glue_s"] / rec["busy_s"]

"""roofline.reach: Σ bound ÷ Σ device time over every call of K4m
(spmm) in the window, in %. Bounds by pb.roofline's counting rules;
device time of spmm_rows."""
from pb import roofline

WRAP = {"spmm": roofline.spmm}
KERNELS = ("spmm_rows",)


def read(rec):
    calls = rec.get("calls", {}).get("spmm", [])
    kernel_s = sum(rec.get("kernel_s", {}).get(k, 0.0) for k in KERNELS)
    return roofline.share(calls, kernel_s)

"""roofline.traverse: Σ bound ÷ Σ device time over every call of K1
(advance_filter_batch), K3 (advance_batch) and K2 (compact) in the
window, in %. Bounds by pb.roofline's counting rules; device time of
the kernels those calls launch (K1: lb_offsets, af_expand, af_emit; K3:
lb_offsets, lb_expand_tiles; K2: cp_kernel)."""
from pb import roofline

WRAP = {"advance_filter_batch": roofline.advance_filter_batch,
        "advance_batch": roofline.advance_batch,
        "compact": roofline.compact}
KERNELS = ("lb_offsets", "af_expand", "af_emit", "lb_expand_tiles",
           "cp_kernel")


def read(rec):
    calls = [c for op in WRAP for c in rec.get("calls", {}).get(op, [])]
    kernel_s = sum(rec.get("kernel_s", {}).get(k, 0.0) for k in KERNELS)
    return roofline.share(calls, kernel_s)

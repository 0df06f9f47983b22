"""The yardstick of a kernel's roofline share: the card's peaks, the
bytes and operations each call of a kernel needs, and the counting
wrappers that collect them in the traced run.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet), HBM3 at 3.35 TB/s and
67 TFLOP/s in float32 outside the tensor cores, the rate taken for the
integer work of the traversal kernels. A call's bound is the larger of
its bytes over the bandwidth and its operations over the rate.

Counting rules (each input byte read once, each output byte written
once, what these inputs need where the work depends on the data):
  K1 advance_filter_batch  4 B an input lane, 8 B a live lane (base, row
                           offset), 5 B a live slot (column, visited
                           byte), 8 B an output slot of the (B, cap_front)
                           ids / srcs rows, 8 B a lane (lengths, totals);
                           8 operations a live slot
  K3 advance_batch         4 B an input lane, 8 B a live lane, 4 B a live
                           slot, 21 B an output slot of (B, cap_out), 4 B a
                           lane; 4 operations an output slot
  K2 compact               the values and mask once, 4 B a kept entry,
                           4 B a lane; 4 operations a (lane, entry)
  K4m spmm                 the offsets, the mask, 4 B a live row's edge
                           (8 with values), X and Y once; 2 operations an
                           edge and column
where a live slot is an edge the call expands (a lane's degree sum,
capped at cap_out) and a live lane a frontier entry of degree > 0.
"""
from __future__ import annotations

import contextlib

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def _lanes(sizes: torch.Tensor, cap_out: int) -> tuple[int, int]:
    """(live lanes, live slots) of a (B, cap_in) sizes tensor."""
    live = int((sizes > 0).sum())
    per_lane = sizes.to(torch.int64).sum(dim=1).clamp(max=cap_out)
    return live, int(per_lane.sum())


def advance_filter_batch(args, kwargs, out) -> tuple[int, int]:
    sizes, cap_out, cap_front = args[3], int(args[5]), int(args[6])
    b, cap_in = sizes.shape
    live, slots = _lanes(sizes, cap_out)
    nbytes = (b * cap_in * 4 + live * 8 + slots * 5 + b * cap_front * 8
              + b * 8)
    return nbytes, slots * 8


def advance_batch(args, kwargs, out) -> tuple[int, int]:
    sizes, cap_out = args[3], int(args[4])
    b, cap_in = sizes.shape
    live, slots = _lanes(sizes, cap_out)
    nbytes = b * cap_in * 4 + live * 8 + slots * 4 + b * cap_out * 21 + b * 4
    return nbytes, b * cap_out * 4


def compact(args, kwargs, out) -> tuple[int, int]:
    values, mask = args[0], args[1]
    b, cap = mask.shape
    kept = int(mask.sum())
    nbytes = (values.numel() * values.element_size() + mask.numel()
              + kept * 4 + b * 4)
    return nbytes, b * cap * 4


def spmm(args, kwargs, out) -> tuple[int, int]:
    offsets, values, x, mask = args[0], args[2], args[3], args[6]
    n = int(offsets.shape[0]) - 1
    nx, k = (int(d) for d in x.shape)
    deg = (offsets[1:] - offsets[:-1]).to(torch.int64)
    m_live = int(deg.sum() if mask is None else deg[mask].sum())
    nbytes = ((n + 1) * 4 + (0 if mask is None else n)
              + m_live * (4 if values is None else 8) + nx * k * 4 + n * k * 4)
    return nbytes, 2 * m_live * k


@contextlib.contextmanager
def counting(ops: dict):
    """Wrap the cuda provider of each op in ``ops`` (op -> counting
    function) so that every call appends its (bytes, operations) to
    ``calls[op]``; the providers are put back on exit. The counts read
    the call's inputs on the host, so this belongs to the traced run
    only."""
    from repro_torch.core import backend as B
    calls = {op: [] for op in ops}
    saved = {}
    for op, count in ops.items():
        orig = B.dispatch(op, B.CUDA)
        enc = B.declared_encodings(op, B.CUDA)
        saved[op] = (orig, enc)

        def wrapper(*args, _orig=orig, _count=count, _op=op, **kwargs):
            out = _orig(*args, **kwargs)
            calls[_op].append(_count(args, kwargs, out))
            return out

        B.register(op, B.CUDA, encodings=enc)(wrapper)
    try:
        yield calls
    finally:
        for op, (orig, enc) in saved.items():
            B.register(op, B.CUDA, encodings=enc)(orig)


def share(calls: list, kernel_s: float):
    """Σ bound ÷ Σ device time, in %; None when no call or no time was
    seen."""
    if not calls or kernel_s <= 0:
        return None
    return 100.0 * sum(bound_s(b, o) for b, o in calls) / kernel_s

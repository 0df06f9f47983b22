"""Frontier data structures (counterpart of ``repro.core.frontier``).

A frontier is a fixed-capacity buffer, as in the reference:

  SparseFrontier:        ids (capacity,) int32, -1 past ``length``;
  DenseFrontier:         flags (n,) bool — the pull phase's bitmap;
  BatchedSparseFrontier: ids (B, capacity), lengths (B,) — one compacted
                         queue per traversal lane;
  BatchedDenseFrontier:  flags (B, n) bool.

Compaction dispatches the ``"compact"`` registry op, which here takes the
whole (B, cap) batch at once: the plain ``_compact_torch`` below, or the
``filter_compact`` CUDA kernel. ``compact_values_batch`` adds the
reference's clamp semantics on top: ``lengths`` clamped to the output
capacity, ``totals`` the true pre-clamp counts.

Capacity tiers: ``tier_caps`` builds the power-of-two capacity ladder
(floor ``MIN_TIER``) that traversal steps are sized by, ``tier_index``
picks the rung for a workload bound read on the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..kernels.runtime import resolve_device
from . import backend as B

INVALID = -1

# The smallest capacity tier: below it, per-tier overhead beats the work
# saved.
MIN_TIER = 512


def tier_caps(cap: int, min_tier: int = MIN_TIER) -> tuple[int, ...]:
    """Power-of-two capacity ladder ending exactly at ``cap``:
    (min_tier, 2·min_tier, …, cap); a cap at or below the floor is a
    single rung."""
    cap = max(int(cap), 1)
    if cap <= min_tier:
        return (cap,)
    caps, t = [], min_tier
    while t < cap:
        caps.append(t)
        t *= 2
    caps.append(cap)
    return tuple(caps)


def tier_index(need: int, caps: tuple[int, ...]) -> int:
    """Index of the smallest tier with cap ≥ ``need``; a need beyond
    every rung selects the top tier."""
    return sum(int(need > c) for c in caps[:-1])


def _scatter_flags(ids: torch.Tensor, valid: torch.Tensor,
                   n: int) -> torch.Tensor:
    """(B, n) bool with ``True`` at each valid id of each row. Invalid
    lanes write a junk column n that is sliced away (the reference's
    ``mode="drop"``)."""
    b = ids.shape[0]
    tgt = torch.where(valid, ids, n).long()
    flags = torch.zeros((b, n + 1), dtype=torch.bool, device=ids.device)
    flags.scatter_(1, tgt, True)
    return flags[:, :n]


@dataclass(frozen=True)
class SparseFrontier:
    """Compacted queue of vertex or edge ids with static capacity."""

    ids: torch.Tensor      # (capacity,) int32; entries >= length are -1
    length: torch.Tensor   # () int32

    @property
    def capacity(self) -> int:
        return int(self.ids.shape[0])

    @property
    def valid_mask(self) -> torch.Tensor:
        lane = torch.arange(self.capacity, dtype=torch.int32,
                            device=self.ids.device)
        return lane < self.length

    def to_dense(self, n: int) -> "DenseFrontier":
        return DenseFrontier(_scatter_flags(self.ids[None],
                                            self.valid_mask[None], n)[0])


@dataclass(frozen=True)
class DenseFrontier:
    """Bitmap frontier over all n vertices."""

    flags: torch.Tensor    # (n,) bool

    @property
    def n(self) -> int:
        return int(self.flags.shape[0])

    @property
    def length(self) -> torch.Tensor:
        return self.flags.sum(dtype=torch.int32)

    def to_sparse(self, capacity: Optional[int] = None,
                  backend: Optional[str] = None) -> SparseFrontier:
        capacity = self.n if capacity is None else capacity
        return compact_indices(self.flags, capacity, backend=backend)


@dataclass(frozen=True)
class BatchedSparseFrontier:
    """B compacted queues over one shared topology."""

    ids: torch.Tensor      # (B, capacity) int32
    lengths: torch.Tensor  # (B,) int32

    @property
    def batch(self) -> int:
        return int(self.ids.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.ids.shape[1])

    @property
    def valid_mask(self) -> torch.Tensor:
        lane = torch.arange(self.capacity, dtype=torch.int32,
                            device=self.ids.device)
        return lane[None, :] < self.lengths[:, None]

    def to_dense(self, n: int) -> "BatchedDenseFrontier":
        return BatchedDenseFrontier(_scatter_flags(self.ids,
                                                   self.valid_mask, n))

    def lane(self, b: int) -> SparseFrontier:
        return SparseFrontier(ids=self.ids[b], length=self.lengths[b])


@dataclass(frozen=True)
class BatchedDenseFrontier:
    """B bitmap frontiers over all n vertices."""

    flags: torch.Tensor    # (B, n) bool

    @property
    def batch(self) -> int:
        return int(self.flags.shape[0])

    @property
    def n(self) -> int:
        return int(self.flags.shape[1])

    @property
    def lengths(self) -> torch.Tensor:
        return self.flags.sum(dim=1, dtype=torch.int32)

    def to_sparse(self, capacity: Optional[int] = None,
                  backend: Optional[str] = None) -> BatchedSparseFrontier:
        capacity = self.n if capacity is None else capacity
        return compact_indices_batch(self.flags, capacity, backend=backend)

    def lane(self, b: int) -> DenseFrontier:
        return DenseFrontier(self.flags[b])


def from_ids(ids, capacity: int, device=None) -> SparseFrontier:
    """A SparseFrontier holding a short list of ids."""
    ids = torch.as_tensor(ids, dtype=torch.int32, device=device).reshape(-1)
    buf = torch.full((capacity,), INVALID, dtype=torch.int32,
                     device=ids.device)
    buf[:ids.shape[0]] = ids
    return SparseFrontier(ids=buf, length=torch.tensor(
        ids.shape[0], dtype=torch.int32, device=ids.device))


def from_ids_batch(srcs, capacity: int, device=None
                   ) -> BatchedSparseFrontier:
    """One single-vertex lane per entry of ``srcs``."""
    srcs = torch.as_tensor(srcs, dtype=torch.int32,
                           device=device).reshape(-1)
    b = srcs.shape[0]
    buf = torch.full((b, capacity), INVALID, dtype=torch.int32,
                     device=srcs.device)
    buf[:, 0] = srcs
    return BatchedSparseFrontier(
        ids=buf, lengths=torch.ones((b,), dtype=torch.int32,
                                    device=srcs.device))


def empty(capacity: int, device=None) -> SparseFrontier:
    """An empty queue of ``capacity`` slots (all -1) on ``device``
    (``None``: the card)."""
    dev = resolve_device(device)
    return SparseFrontier(ids=torch.full((capacity,), INVALID,
                                         dtype=torch.int32, device=dev),
                          length=torch.zeros((), dtype=torch.int32,
                                             device=dev))


@B.register("compact", B.TORCH)
def _compact_torch(values: torch.Tensor, mask: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-length stable per-row compaction of ``values[b][mask[b]]`` →
    (packed (B, cap), counts (B,)): exclusive scan + scatter, the twin of
    ``repro.core.frontier._compact_xla`` over a batch."""
    b, cap = mask.shape
    mask_i = mask.to(torch.int32)
    pos = torch.cumsum(mask_i, dim=1, dtype=torch.int32) - mask_i
    buf = torch.full((b, cap + 1), INVALID, dtype=values.dtype,
                     device=values.device)
    tgt = torch.where(mask, pos, cap).long()
    buf.scatter_(1, tgt, values.expand(b, cap))
    return buf[:, :cap].contiguous(), mask_i.sum(dim=1, dtype=torch.int32)


def compact_values_batch(values: torch.Tensor, mask: torch.Tensor,
                         capacity: int, fill: int = INVALID,
                         backend: Optional[str] = None
                         ) -> tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """Per-row compaction of ``values[b][mask[b]]`` into (B, capacity).

    Returns (buf, lengths, totals): ``lengths`` clamped to ``capacity``,
    ``totals`` the true pre-clamp counts. ``values`` may be one (1, cap)
    row broadcast over the batch."""
    bk = B.resolve(backend, mask.device)
    packed, totals = B.dispatch("compact", bk)(values, mask)
    b, n = packed.shape
    lengths = torch.clamp(totals, max=capacity).to(torch.int32)
    if capacity <= n:
        out = packed[:, :capacity]
    else:
        pad = torch.full((b, capacity - n), INVALID, dtype=packed.dtype,
                         device=packed.device)
        out = torch.cat([packed, pad], dim=1)
    lane = torch.arange(capacity, dtype=torch.int32, device=packed.device)
    out = torch.where(lane[None, :] < lengths[:, None], out,
                      torch.full((), fill, dtype=packed.dtype,
                                 device=packed.device))
    return out, lengths, totals.to(torch.int32)


def compact_values(values: torch.Tensor, mask: torch.Tensor,
                   capacity: int, fill: int = INVALID,
                   backend: Optional[str] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact ``values[mask]`` into a fixed-size buffer → (buf, length);
    a squeezed batch-of-1 call."""
    buf, lengths, _ = compact_values_batch(values[None], mask[None],
                                           capacity, fill=fill,
                                           backend=backend)
    return buf[0], lengths[0]


def compact_indices(mask: torch.Tensor, capacity: int,
                    backend: Optional[str] = None) -> SparseFrontier:
    """Stream-compact ``nonzero(mask)`` into a fixed-size buffer."""
    front = compact_indices_batch(mask[None], capacity, backend=backend)
    return front.lane(0)


def compact_indices_batch(mask: torch.Tensor, capacity: int,
                          backend: Optional[str] = None
                          ) -> BatchedSparseFrontier:
    """Per-row stream-compaction of ``nonzero(mask[b])``."""
    n = mask.shape[1]
    ids = torch.arange(n, dtype=torch.int32, device=mask.device)[None, :]
    buf, lengths, _ = compact_values_batch(ids, mask, capacity,
                                           backend=backend)
    return BatchedSparseFrontier(ids=buf, lengths=lengths)

"""Shape buckets for online serving: the pre-compiled program ladder.

Ragged requests (arbitrary prompt length, arbitrary count per batch)
cannot each get their own compiled program — shape-polymorphic serving
would recompile on every new ``(batch, length)`` pair, and a compile is
orders of magnitude slower than the forward it serves.  The ladder
quantizes both axes to a small geometric set of buckets: a request of
length ``L`` runs in the smallest length bucket ``>= L``, and a group of
``R`` requests runs at the smallest batch bucket ``>= R``, so the whole
open stream is served by ``len(lengths) * len(batches)`` programs, all
compiled once at startup (``Server.warmup``).  Power-of-two spacing
bounds the padding waste: above the ladder floor a bucket is always
``< 2x`` its occupant on each axis, so the padded area is ``< 4x`` the
true work.

:func:`pack` is the pure batcher core: every request lands in exactly one
packed batch, FIFO order is kept within a length bucket, and bucket
rounding is bounded by the ladder geometry.  A copy of the reference's
``repro.serving.buckets``.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence


def _pow2_rungs(lo: int, hi: int) -> tuple[int, ...]:
    """``lo``, then doublings until the rung covers ``hi``."""
    if lo <= 0 or hi <= 0:
        raise ValueError(f"ladder bounds must be positive, got {lo}..{hi}")
    rungs = [lo]
    while rungs[-1] < hi:
        rungs.append(rungs[-1] * 2)
    return tuple(rungs)


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The static (length, batch) bucket grid a server compiles against.

    ``lengths``/``batches`` are strictly ascending; the largest rung on
    each axis is the admission-control hard cap — a request longer than
    ``max_len`` is rejected at ``submit`` rather than silently truncated.
    """

    lengths: tuple[int, ...]
    batches: tuple[int, ...]

    def __post_init__(self):
        for name, axis in (("lengths", self.lengths),
                           ("batches", self.batches)):
            axis = tuple(int(x) for x in axis)
            object.__setattr__(self, name, axis)
            if not axis:
                raise ValueError(f"BucketLadder: {name} is empty")
            if any(x <= 0 for x in axis):
                raise ValueError(
                    f"BucketLadder: {name} must be positive, got {axis}")
            if list(axis) != sorted(set(axis)):
                raise ValueError(
                    f"BucketLadder: {name} must be strictly ascending, "
                    f"got {axis}")

    @classmethod
    def from_max(cls, max_len: int, max_batch: int, *, min_len: int = 8,
                 min_batch: int = 1) -> "BucketLadder":
        """Power-of-two ladder covering requests up to ``max_len`` tokens
        packed up to ``max_batch`` at a time."""
        return cls(lengths=_pow2_rungs(min(min_len, max_len), max_len),
                   batches=_pow2_rungs(min(min_batch, max_batch),
                                       max_batch))

    @property
    def max_len(self) -> int:
        return self.lengths[-1]

    @property
    def max_batch(self) -> int:
        return self.batches[-1]

    def _bucket(self, axis: tuple[int, ...], n: int, what: str) -> int:
        if n <= 0:
            raise ValueError(f"{what} must be positive, got {n}")
        for rung in axis:
            if rung >= n:
                return rung
        raise ValueError(
            f"{what} {n} exceeds the largest bucket {axis[-1]} — "
            "grow the ladder or shed the request")

    def length_bucket(self, length: int) -> int:
        """Smallest length rung >= ``length`` (raises above ``max_len``)."""
        return self._bucket(self.lengths, length, "request length")

    def batch_bucket(self, count: int) -> int:
        """Smallest batch rung >= ``count`` (raises above ``max_batch``)."""
        return self._bucket(self.batches, count, "batch count")

    def shapes(self) -> tuple[tuple[int, int], ...]:
        """Every ``(batch, length)`` program shape, warmup order."""
        return tuple((b, s) for s in self.lengths for b in self.batches)


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    """One executable group: ``indices`` into the gathered request list,
    padded to the ``(batch, length)`` bucket shape."""

    length: int
    batch: int
    indices: tuple[int, ...]


def pack(lengths: Sequence[int], ladder: BucketLadder) -> list[PackedBatch]:
    """Assign each request (by its token length) to a padded bucket batch.

    Requests group by length bucket in first-arrival order; each group
    splits into FIFO chunks of at most ``ladder.max_batch`` and each
    chunk's batch axis rounds up to its batch bucket.  Every index
    appears in exactly one :class:`PackedBatch`.
    """
    groups: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        groups.setdefault(ladder.length_bucket(n), []).append(i)
    out: list[PackedBatch] = []
    for lb, idxs in groups.items():
        for s in range(0, len(idxs), ladder.max_batch):
            chunk = idxs[s:s + ladder.max_batch]
            out.append(PackedBatch(length=lb,
                                   batch=ladder.batch_bucket(len(chunk)),
                                   indices=tuple(chunk)))
    return out

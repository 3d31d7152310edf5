"""Shared serving primitives: FIFO admission queue + bounded slot table.

Both engines — LM decode (``serve.engine.Engine``) and tiled segmentation
(``segserve.engine.SegEngine``) — run the same outer loop: requests
wait in a FIFO, a bounded slot table caps how many are in flight, slots
free as requests finish and are refilled from the queue.  What differs is
the unit of batched work (one token per active sequence vs one micro-batch
of image tiles); that stays in each engine.  This module is the common
front door so a deployment can stack both behind one admission policy.
"""
from __future__ import annotations

from typing import Any, Callable, Generic, Iterable, TypeVar

T = TypeVar("T")


class SlotTable(Generic[T]):
    """Fixed-capacity table of in-flight requests, addressed by slot index.

    Slot indices are stable for a request's lifetime — LM decode keys KV
    cache rows by them, segmentation keys stitching canvases by request —
    so the table never compacts; it only occupies and releases.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity {capacity} < 1")
        self._slots: list[T | None] = [None] * capacity

    @property
    def capacity(self) -> int:
        return len(self._slots)

    def __getitem__(self, idx: int) -> T | None:
        return self._slots[idx]

    def free_index(self) -> int | None:
        """Lowest free slot index, or None when the table is full."""
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def free_count(self) -> int:
        """How many slots are free (admission-policy headroom)."""
        return sum(1 for s in self._slots if s is None)

    def occupy(self, item: T) -> int | None:
        """Place ``item`` in the lowest free slot; None when full."""
        idx = self.free_index()
        if idx is not None:
            self._slots[idx] = item
        return idx

    def release(self, idx: int) -> T:
        """Free slot ``idx`` and return what occupied it."""
        item = self._slots[idx]
        if item is None:
            raise KeyError(f"slot {idx} is already free")
        self._slots[idx] = None
        return item

    def active(self) -> list[tuple[int, T]]:
        """(slot, item) pairs of occupied slots, in slot order."""
        return [(i, s) for i, s in enumerate(self._slots) if s is not None]

    def any_active(self) -> bool:
        return any(s is not None for s in self._slots)


class FifoQueue(Generic[T]):
    """Admission queue: requests wait here until a slot frees up.

    Arrival order is the queue's one invariant; policies that admit out of
    order (the gateway's fair-share and EDF) *inspect* in arrival order
    (``__iter__``, ``peek``) and remove by position (``pop_at``), so FIFO
    stays the default and reordering is an explicit policy decision at the
    call site, never queue state.

    Layout: a backing list with a head index.  ``list.pop(0)`` is O(n) in
    the backlog, which made the admission phase quadratic under fabric-
    scale replay (10–100x arrival rates); popping the head now just
    advances the index (amortized O(1) — the consumed prefix is compacted
    away once it dominates the backing list).  Interior ``pop_at`` stays
    O(n - i), which the scanning policies pay anyway.
    """

    # compact when the dead prefix is past this size *and* at least half
    # the backing list — amortized O(1) head pops, bounded slack memory
    _COMPACT_MIN = 64

    def __init__(self, items: Iterable[T] = ()):  # pragma: no branch
        self._items: list[T | None] = list(items)
        self._head = 0

    def push(self, item: T) -> None:
        self._items.append(item)

    def __len__(self) -> int:
        return len(self._items) - self._head

    def __bool__(self) -> bool:
        return self._head < len(self._items)

    def __iter__(self):
        """Arrival-order iteration (do not mutate while iterating)."""
        return iter(self._items[self._head:])

    def _index(self, i: int) -> int:
        """Backing-list index of logical position ``i`` (supports the
        usual negative indexing), bounds-checked against the live span."""
        idx = (len(self._items) if i < 0 else self._head) + i
        if not self._head <= idx < len(self._items):
            raise IndexError(f"queue index {i} out of range (len {len(self)})")
        return idx

    def peek(self, i: int = 0) -> T:
        """The ``i``-th waiting item (0 = oldest) without consuming it."""
        return self._items[self._index(i)]

    def pop_at(self, i: int) -> T:
        """Remove and return the ``i``-th waiting item (0 = oldest) — the
        out-of-order admission primitive for non-FIFO policies."""
        idx = self._index(i)
        item = self._items[idx]
        if idx == self._head:
            self._items[idx] = None  # drop the reference immediately
            self._head += 1
            if self._head >= self._COMPACT_MIN and \
                    self._head * 2 >= len(self._items):
                del self._items[:self._head]
                self._head = 0
        else:
            del self._items[idx]
        return item  # type: ignore[return-value]

    def pump(
        self,
        slots: SlotTable[Any],
        admit: Callable[[T], bool],
    ) -> int:
        """Admit queued requests in FIFO order while slots are free.

        ``admit`` does the engine-specific work (prefill, tile planning) and
        returns False to stop admission without consuming the request (e.g.
        the engine wants the batch to drain first).  Returns how many
        requests were admitted.
        """
        n = 0
        while self and slots.free_index() is not None:
            if not admit(self._items[self._head]):
                break
            self.pop_at(0)
            n += 1
        return n

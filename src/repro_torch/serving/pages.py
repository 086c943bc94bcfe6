"""Host-side page-pool allocator for the paged KV cache (a copy of
``repro.serving.pages``: pure Python).

The serving engine's dense cache reserves ``max_prompt + max_gen`` KV
positions per slot no matter how short the request is — worst-case HBM is
the concurrency cap. The paged cache replaces the per-slot reservation
with one global pool of ``page_size``-token pages (each page spans every
layer of the stacked KV pool) plus a per-slot page table mapping logical
block index -> physical page.

This module is the pool's *accounting*: pure host Python, mutated only on
the engine's control plane (admission / growth / eviction), never inside
the decode step. Its contract:

* a page is owned by at most one slot at a time — double allocation is
  structurally impossible (pages move between one free list and one owner);
* ``release`` returns every page, so no page leaks across any
  admit/grow/evict schedule;
* admission is **conservative**: ``admit`` atomically allocates the pages
  the prompt needs now and *reserves* (without allocating) the worst case
  the request can grow to (``ceil((plen + max_new) / page_size)``), so a
  mid-decode ``grow`` can never fail — pool exhaustion defers *admission*
  instead of corrupting a live slot. The reservation is per-REQUEST worst
  case, which is the whole point: a short request commits a few pages, not
  the engine-wide ``max_prompt + max_gen``.
"""

from __future__ import annotations

from typing import Optional


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages covering token positions [0, n_tokens)."""
    return -(-n_tokens // page_size)


class PagePool:
    """Free-list allocator over ``num_pages`` physical pages.

    ``admit(alloc_now, reserve_later)`` either atomically takes the whole
    commitment or returns None (defer admission). ``grow()`` converts one
    reservation into a physical page. ``release(pages, unused_reservation)``
    gives everything back at eviction.
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages > 0 and page_size > 0, (num_pages, page_size)
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(num_pages))[::-1]  # pop() -> lowest first
        self._reserved = 0  # promised to resident slots, not yet allocated

    # -- introspection -------------------------------------------------------

    @property
    def free_pages(self) -> int:
        """Physically free pages (some may be spoken for — see headroom)."""
        return len(self._free)

    @property
    def reserved_pages(self) -> int:
        return self._reserved

    @property
    def headroom(self) -> int:
        """Pages a new admission could still commit."""
        return len(self._free) - self._reserved

    def fits(self, n_pages: int) -> bool:
        return n_pages <= self.headroom

    def stats(self) -> dict:
        """Loop-health view: physical utilization plus the commitment
        fraction (allocated + reserved) the admission gate actually sees —
        a pool can look half-empty yet defer everything because resident
        slots hold the headroom as reservations."""
        alloc = self.num_pages - len(self._free)
        return {
            "pages_total": self.num_pages,
            "pages_free": len(self._free),
            "pages_reserved": self._reserved,
            "utilization": alloc / self.num_pages,
            "commitment": (alloc + self._reserved) / self.num_pages,
        }

    # -- lifecycle -----------------------------------------------------------

    def admit(
        self, alloc_now: int, reserve_later: int
    ) -> Optional[list[int]]:
        """Atomically allocate ``alloc_now`` pages and reserve
        ``reserve_later`` more; None (and no state change) if the pool
        cannot commit to the request's worst case."""
        assert alloc_now >= 0 and reserve_later >= 0
        if not self.fits(alloc_now + reserve_later):
            return None
        self._reserved += reserve_later
        return [self._free.pop() for _ in range(alloc_now)]

    def grow(self) -> int:
        """Convert one reserved page into a physical one. Admission's
        conservative commit guarantees this cannot fail for a resident
        slot; the asserts are the invariant, not error handling."""
        assert self._reserved > 0, "grow without a reservation"
        assert self._free, "reserved page missing from the free list"
        self._reserved -= 1
        return self._free.pop()

    def release(self, pages: list[int], unused_reservation: int = 0) -> None:
        """Return a slot's pages (and any reservation it never grew into)."""
        assert unused_reservation <= self._reserved, (
            unused_reservation, self._reserved,
        )
        self._reserved -= unused_reservation
        self._free.extend(pages)
        assert len(self._free) <= self.num_pages

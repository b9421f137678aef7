"""Block-pool bookkeeping for the paged KV cache (jax-free).

The real ``Engine`` keeps its KV tensors in a block pool
(``models.transformer.init_block_pool``); everything that *decides* which
block holds what lives here, on the host, in plain Python: a fixed pool
of block ids with refcounts. Eviction is a per-block decrement (no tensor
traffic), prefix reuse is a refcount bump on the shared blocks, and a
block returns to the free list only when the last reference — active
slot, in-flight handoff, or ``PrefixCache`` entry — drops it.

Block 0 is reserved as a scratch ("trash") block: padded block-table
columns and inactive decode slots point at it, so the jit'd decode step
can run a fixed-shape scatter/gather without branching on liveness.
Nothing ever reads block 0 through a live table entry.
"""
from __future__ import annotations

from typing import List


class BlockPoolExhausted(RuntimeError):
    """Raised when an allocation asks for more blocks than are free."""


class BlockAllocator:
    """Fixed pool of KV-cache blocks with per-block refcounts.

    ``alloc`` hands out blocks at refcount 1; ``ref`` bumps shared blocks
    (prefix reuse); ``free`` decrements and returns a block to the free
    list only at zero. The free list is LIFO over ascending ids, so
    allocation order is deterministic (the sim parity suite and the
    pool-invariant tests rely on that).
    """

    __slots__ = ("num_blocks", "reserved", "_free", "_ref")

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(f"pool of {num_blocks} blocks cannot reserve "
                             f"{reserved}")
        self.num_blocks = num_blocks
        self.reserved = reserved
        self._free: List[int] = list(range(num_blocks - 1, reserved - 1, -1))
        self._ref: List[int] = [0] * num_blocks

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        """Blocks currently referenced (excludes the reserved scratch)."""
        return self.num_blocks - self.reserved - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> List[int]:
        """n fresh blocks at refcount 1 (lowest free ids first)."""
        if n > len(self._free):
            raise BlockPoolExhausted(
                f"asked for {n} blocks, {len(self._free)} free "
                f"(pool {self.num_blocks})")
        free = self._free
        ref = self._ref
        ids = [free.pop() for _ in range(n)]
        for b in ids:
            ref[b] = 1
        return ids

    def ref(self, ids) -> None:
        """Bump shared blocks (copy-free prefix reuse)."""
        ref = self._ref
        for b in ids:
            if ref[b] <= 0:
                raise ValueError(f"ref of unallocated block {b}")
            ref[b] += 1

    def free(self, ids) -> None:
        """Drop one reference per block; blocks return to the free list
        only when the last holder lets go (O(1) per block, no tensors)."""
        free = self._free
        ref = self._ref
        for b in ids:
            r = ref[b]
            if r <= 0:
                raise ValueError(f"double free of block {b}")
            ref[b] = r - 1
            if r == 1:
                free.append(b)

    def refcount(self, block: int) -> int:
        return self._ref[block]

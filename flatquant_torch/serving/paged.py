"""Host-side block allocation for the paged int4 KV cache (port of
flatquant_tpu/serving/paged.py).

The pool is a fixed set of device blocks (kernels/paged_kv.py) and
allocation is host bookkeeping: a free list of pool block indices plus a
per-slot table. Per-slot block counts are independent: a 100-token
request next to a 2000-token one holds 1 block, not 8.

Admission policy: a request RESERVES ceil((len(prompt) + max_new_tokens)
/ block_size) blocks up front, so an admitted request can always finish.
Block 0 is the trash block: table entries outside a slot's reservation
point at it, so padding writes (and the garbage tokens of inactive
slots) land there and are never attended.
"""

from __future__ import annotations


class BlockAllocator:
    """Free list over pool blocks [1, n_blocks); block 0 is reserved as
    the trash block. Blocks are handed out from 1 upwards."""

    def __init__(self, n_blocks: int):
        assert n_blocks >= 2, "need at least one real block beyond trash"
        self.n_blocks = n_blocks
        self._free = list(range(n_blocks - 1, 0, -1))  # pop() yields 1 first

    @property
    def free_count(self) -> int:
        return len(self._free)

    def alloc(self, n: int):
        """Return n distinct block indices, or None if unavailable."""
        if n > len(self._free):
            return None
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks) -> None:
        for b in blocks:
            assert 0 < b < self.n_blocks
            self._free.append(int(b))


def blocks_needed(prompt_len: int, max_new_tokens: int,
                  block_size: int) -> int:
    """Blocks covering every position the request can ever write
    (prompt + generated tokens)."""
    return -(-(prompt_len + max_new_tokens) // block_size)

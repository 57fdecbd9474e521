"""Host-side paging layer for the paged KV cache: block accounting and the
refcounted block allocator (counterpart: ``deeplearning4j_tpu/serving/
paging.py``; ``models/bert.py`` owns the device side — the block pool and
the block-table prefill/decode). Plain host bookkeeping: integers under a
lock, a deterministic LIFO free list."""
from __future__ import annotations

import threading
from typing import List, Sequence

import numpy as np

from deeplearning4j_tpu_torch.serving.admission import KVBlocksExhaustedError


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` positions (ceil division)."""
    return -(-tokens // block_size)


def kv_bytes_per_token(layers: int, heads: int, head_dim: int,
                       kv_dtype: str = "float32",
                       itemsize: int = 4) -> int:
    """Device bytes one token position occupies in the KV cache: K and V
    at ``itemsize`` bytes per element, or for ``"int8"`` 1-byte values
    plus one fp32 scale per (token, head) per tensor."""
    if kv_dtype == "int8":
        per_head = head_dim * 1 + 4          # int8 values + f32 scale
    else:
        per_head = head_dim * itemsize
    return layers * 2 * heads * per_head     # K and V


class BlockAllocator:
    """Refcounted free-list allocator over a fixed block pool.

    Blocks ``[0, reserved)`` are never handed out — block 0 is the scratch
    block dead slots write into, so giving it to a stream would let dead
    slots corrupt live K/V. ``alloc`` is all-or-nothing, ``free`` drops
    one reference per block and returns it to the free list at zero, and
    freeing an unallocated block raises (the double-free guard)."""

    def __init__(self, num_blocks: int, reserved: int = 1):
        if num_blocks <= reserved:
            raise ValueError(
                f"num_blocks {num_blocks} must exceed the {reserved} "
                "reserved scratch block(s)")
        self.num_blocks = num_blocks
        self.reserved = reserved
        # LIFO: pop() hands back the most recently freed block first
        self._free: List[int] = list(range(num_blocks - 1, reserved - 1, -1))
        self._ref = np.zeros(num_blocks, np.int64)
        self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        """Allocatable blocks (reserved scratch excluded)."""
        return self.num_blocks - self.reserved

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def in_use(self) -> int:
        with self._lock:
            return self.capacity - len(self._free)

    def alloc(self, n: int) -> List[int]:
        """Take ``n`` fresh blocks (each at refcount 1), or raise
        :class:`KVBlocksExhaustedError` leaving the allocator unchanged."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        with self._lock:
            if n > len(self._free):
                raise KVBlocksExhaustedError(
                    f"KV block pool exhausted: {n} blocks requested, "
                    f"{len(self._free)} free of {self.capacity}",
                    needed=n, usable=len(self._free),
                    capacity=self.capacity)
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def free(self, blocks: Sequence[int]):
        """Drop one reference per block; blocks reaching zero return to
        the free list. Freeing a block that is already free raises."""
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise ValueError(
                        f"double free of block {b}: refcount already 0")
            for b in blocks:
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)

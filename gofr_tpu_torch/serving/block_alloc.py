"""Paged KV block allocator, pure Python.

The port's own copy of the block accounting the JAX package gets from
``gofr_tpu/native/runtime.py::BlockAllocator``: the same semantics for
``alloc``, ``extend``, ``free``, ``block_table``, ``seq_length`` and
``stats``, raising :class:`OutOfBlocks` when the pool cannot cover a
request (and then changing nothing). Blocks are handed out lowest id
first. Copy-on-write forks wait for the prefix-cache slice.
"""

from __future__ import annotations

import threading


class OutOfBlocks(RuntimeError):
    pass


class BlockAllocator:
    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError("num_blocks and block_size must be positive")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self._free = list(range(num_blocks - 1, -1, -1))  # pop() -> lowest id
        self._seqs: dict[int, tuple[list[int], int]] = {}  # id -> (blocks, length)
        self._alloc_failures = 0
        self._mu = threading.Lock()

    def _needed(self, tokens: int) -> int:
        return (tokens + self.block_size - 1) // self.block_size

    def alloc(self, seq_id: int, tokens: int) -> None:
        """Own enough blocks for ``tokens`` tokens of a new sequence."""
        with self._mu:
            if seq_id in self._seqs:
                raise KeyError(f"sequence {seq_id} exists")
            need = self._needed(tokens)
            if len(self._free) < need:
                self._alloc_failures += 1
                raise OutOfBlocks(f"need {need} blocks, {len(self._free)} free")
            self._seqs[seq_id] = ([self._free.pop() for _ in range(need)], tokens)

    def extend(self, seq_id: int, new_length: int) -> None:
        """Grow a sequence's coverage to ``new_length`` tokens."""
        with self._mu:
            blocks, length = self._seqs[seq_id]
            if new_length < length:
                raise ValueError("cannot shrink")
            more = self._needed(new_length) - len(blocks)
            if more > len(self._free):
                self._alloc_failures += 1
                raise OutOfBlocks("extend")
            blocks.extend(self._free.pop() for _ in range(max(more, 0)))
            self._seqs[seq_id] = (blocks, new_length)

    def free(self, seq_id: int) -> None:
        with self._mu:
            blocks, _ = self._seqs.pop(seq_id)
            self._free.extend(blocks)

    def block_table(self, seq_id: int) -> list[int]:
        with self._mu:
            return list(self._seqs[seq_id][0])

    def seq_length(self, seq_id: int) -> int:
        with self._mu:
            return self._seqs[seq_id][1]

    def stats(self) -> dict[str, int]:
        with self._mu:
            return {
                "free_blocks": len(self._free),
                "total_blocks": self.num_blocks,
                "sequences": len(self._seqs),
                "alloc_failures": self._alloc_failures,
            }

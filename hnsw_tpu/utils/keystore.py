"""Host-side key <-> dense-slot mapping and the padded vector store.

The reference is generic over ordered key types and drags that genericity
through every layer (parquet/key_utils.go:42-235's coercion matrix). This
rebuild absorbs ALL key handling at the host boundary: devices only
ever see dense int32 slot ids; keys stay in a Python dict. Any hashable
key type works (int, str, bytes, tuples, ...).
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np


def _grow_capacity(cap: int, needed: int, minimum: int = 64) -> int:
    new = max(cap, minimum)
    while new < needed:
        new *= 2
    return new


class SlotMap:
    """Bidirectional key<->slot map with slot reuse via a free list."""

    def __init__(self) -> None:
        self.key_to_slot: Dict[Hashable, int] = {}
        self.slot_to_key: List[Any] = []
        self.free: List[int] = []

    def __len__(self) -> int:
        return len(self.key_to_slot)

    def __contains__(self, key: Hashable) -> bool:
        return key in self.key_to_slot

    @property
    def capacity_used(self) -> int:
        """Highest slot index ever allocated + 1 (dense scan bound)."""
        return len(self.slot_to_key)

    def slot_of(self, key: Hashable) -> Optional[int]:
        return self.key_to_slot.get(key)

    def key_of(self, slot: int) -> Any:
        return self.slot_to_key[slot]

    def assign(self, key: Hashable) -> Tuple[int, bool]:
        """Get-or-create the slot for ``key``. Returns (slot, is_new)."""
        s = self.key_to_slot.get(key)
        if s is not None:
            return s, False
        if self.free:
            s = self.free.pop()
            self.slot_to_key[s] = key
        else:
            s = len(self.slot_to_key)
            self.slot_to_key.append(key)
        self.key_to_slot[key] = s
        return s, True

    def assign_fresh_batch(self, keys: Sequence[Hashable]) -> np.ndarray:
        """Bulk ``assign`` for distinct NEW keys on an empty/append-only
        tail — one dict.update instead of a Python call per key (the
        per-key loop was seconds per million keys on graph reopen).
        Falls back to the per-key path when the fast preconditions
        (no free slots, no collisions) don't hold."""
        ks = set(keys)
        if (not self.free and len(ks) == len(keys)
                and not (self.key_to_slot.keys() & ks)):
            base = len(self.slot_to_key)
            self.slot_to_key.extend(keys)
            self.key_to_slot.update(
                zip(keys, range(base, base + len(keys))))
            return np.arange(base, base + len(keys), dtype=np.int64)
        return np.asarray([self.assign(k)[0] for k in keys], np.int64)

    def release(self, key: Hashable) -> Optional[int]:
        """Remove ``key``; its slot goes on the free list. Returns the slot."""
        s = self.key_to_slot.pop(key, None)
        if s is None:
            return None
        self.slot_to_key[s] = None
        self.free.append(s)
        return s

    def keys_for(self, slots: Sequence[int]) -> List[Any]:
        out = []
        for s in slots:
            out.append(None if s < 0 else self.slot_to_key[int(s)])
        return out


class HostVectorStore:
    """NumPy-backed padded vector storage with cached squared norms.

    The authoritative copy lives on host (numpy); device mirrors are
    created lazily by index classes. Rows for free slots stay allocated
    (tombstoned via ``alive``), mirroring the array-graph design in
    SURVEY.md §7.1.
    """

    def __init__(self, dim: Optional[int] = None, capacity: int = 64,
                 dtype=np.float32) -> None:
        self.dim = dim
        self._dtype = dtype
        self.capacity = 0
        self.vectors: Optional[np.ndarray] = None
        self.sq_norms: Optional[np.ndarray] = None
        self.alive: Optional[np.ndarray] = None
        if dim is not None:
            self._alloc(capacity)

    def _alloc(self, capacity: int) -> None:
        self.capacity = capacity
        self.vectors = np.zeros((capacity, self.dim), self._dtype)
        self.sq_norms = np.zeros((capacity,), np.float32)
        self.alive = np.zeros((capacity,), bool)

    def ensure_dim(self, dim: int) -> None:
        if self.dim is None:
            self.dim = dim
            self._alloc(max(64, 1))
        elif self.dim != dim:
            # Mirrors the reference's dimension check error
            # (graph.go:450-455).
            raise ValueError(
                f"embedding dimension mismatch: {self.dim} != {dim}")

    def ensure_capacity(self, needed: int) -> bool:
        """Grow (doubling) so that ``needed`` slots fit. True if grown."""
        if self.vectors is None:
            raise RuntimeError("store dim not set")
        if needed <= self.capacity:
            return False
        new_cap = _grow_capacity(self.capacity, needed)
        v = np.zeros((new_cap, self.dim), self._dtype)
        v[: self.capacity] = self.vectors
        s = np.zeros((new_cap,), np.float32)
        s[: self.capacity] = self.sq_norms
        a = np.zeros((new_cap,), bool)
        a[: self.capacity] = self.alive
        self.vectors, self.sq_norms, self.alive = v, s, a
        self.capacity = new_cap
        return True

    def put(self, slot: int, vec: np.ndarray) -> None:
        vec = np.asarray(vec, self._dtype)
        self.ensure_dim(vec.shape[-1])
        self.ensure_capacity(slot + 1)
        self.vectors[slot] = vec
        self.sq_norms[slot] = float(np.dot(vec.astype(np.float64),
                                           vec.astype(np.float64)))
        self.alive[slot] = True

    def put_batch(self, slots: np.ndarray, vecs: np.ndarray) -> None:
        vecs = np.asarray(vecs, self._dtype)
        self.ensure_dim(vecs.shape[-1])
        self.ensure_capacity(int(np.max(slots)) + 1 if len(slots) else 0)
        self.vectors[slots] = vecs
        v64 = vecs.astype(np.float64)
        self.sq_norms[slots] = np.sum(v64 * v64, axis=-1).astype(np.float32)
        self.alive[slots] = True

    def kill(self, slot: int) -> None:
        self.alive[slot] = False

    def get(self, slot: int) -> np.ndarray:
        return self.vectors[slot]

    def get_batch(self, slots: np.ndarray) -> np.ndarray:
        """Batched fetch (mirrors MmapVectorStore.get_batch)."""
        return self.vectors[np.asarray(slots)]

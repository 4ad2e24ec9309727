"""Serving cache layer: query-HV memoization + multi-tenant bank registry.

Two observations drive this module (the serving-scale analogue of the
paper's own argument that the spectral library is the stable, reusable
artifact):

  * **Hot queries repeat.** Re-encoding/bit-packing the same query HV on
    every arrival wastes the cheapest win in the serving path.
    :class:`QueryHVCache` memoizes the *encoded* (packed-int32 or int8)
    form keyed by a content hash of the raw bipolar HV, under an LRU
    policy with a byte budget — hit/miss/eviction counters included, so
    the hit rate is a first-class serving metric.
  * **Banks are per-tenant and mostly cold.** A multi-tenant server holds
    one :class:`~repro_torch.serve.db_search.ShardedDatabase` per client
    library. :class:`BankRegistry` keeps the raw reference HVs as specs
    and builds (packs, shards) a bank only on first use; cold built
    banks are LRU-evicted beyond
    ``max_banks`` (their spec stays registered, so a later request simply
    rebuilds), and hot tenants can be pinned to exempt them.

Cached and cold paths are **bit-identical** by construction: the cache
stores the deterministic output of
:func:`repro_torch.serve.db_search.encode_queries`, never scores or results.

Counterpart of ``repro.serve.cache`` without the streaming-ingestion
(delta append / compaction) part of the registry. A tenant registered
with ``precursor=`` gets an OMS bank (precursor-sorted blocks; see
:mod:`repro_torch.serve.oms`).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any

import numpy as np


# --------------------------------------------------------------------------
# query-HV cache
# --------------------------------------------------------------------------

class QueryHVCache:
    """Content-hash-keyed LRU cache of encoded query hypervectors.

    Entries are host numpy rows (the packed-uint32 or int8 encoding of one
    query). Eviction is LRU under ``capacity_bytes``; a value that alone
    exceeds the budget is rejected (counted as an eviction) rather than
    flushing the whole cache for a single oversized row.
    """

    def __init__(self, capacity_bytes: int = 64 << 20):
        if capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be > 0, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self._entries: collections.OrderedDict[bytes, np.ndarray] = (
            collections.OrderedDict())
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @staticmethod
    def content_key(raw: Any, *, variant: str = "") -> bytes:
        """Digest of the raw query content (+ dtype/shape/encoding variant).

        ``variant`` must distinguish encodings that map the same raw bytes
        to different values (e.g. ``"packed:512"`` vs ``"int8:512"``), so
        tenants that share an encoding also share cache entries.
        """
        a = np.ascontiguousarray(raw)
        h = hashlib.blake2b(digest_size=16)
        h.update(variant.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
        return h.digest()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def lookup(self, key: bytes) -> np.ndarray | None:
        """Return the cached row for ``key`` (LRU-touching it), else None."""
        row = self._entries.get(key)
        if row is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return row

    def insert(self, key: bytes, value: np.ndarray) -> bool:
        """Store one encoded row; evicts LRU entries down to the budget.

        Returns False when the value alone exceeds ``capacity_bytes`` (the
        entry is not stored).
        """
        value = np.asarray(value)
        if value.nbytes > self.capacity_bytes:
            self.evictions += 1
            return False
        old = self._entries.pop(key, None)
        if old is not None:
            self._bytes -= old.nbytes
        self._entries[key] = value
        self._bytes += value.nbytes
        while self._bytes > self.capacity_bytes:
            _, evicted = self._entries.popitem(last=False)
            self._bytes -= evicted.nbytes
            self.evictions += 1
        return True

    def summary(self) -> dict:
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "capacity_bytes": self.capacity_bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": self.hit_rate,
        }




# --------------------------------------------------------------------------
# multi-tenant bank registry
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _BankSpec:
    """Recipe for one tenant's bank (cheap until first use)."""

    refs: Any
    decoys: Any | None
    dim: int
    pinned: bool = False
    precursor: Any | None = None
    decoy_precursor: Any | None = None


class BankRegistry:
    """Per-tenant :class:`~repro_torch.serve.db_search.ShardedDatabase`
    handles.

    ``register`` only records the raw reference/decoy HVs; the bank is
    built by the first ``get`` for that tenant, and rebuilt transparently
    if it was evicted in between. At most ``max_banks`` built banks are
    held; beyond that the least-recently-used *unpinned* bank is dropped.
    """

    def __init__(self, *, pack: bool | str = "auto",
                 max_banks: int | None = None, fused: bool = False):
        if max_banks is not None and max_banks < 1:
            raise ValueError(f"max_banks must be >= 1, got {max_banks}")
        self.pack = pack
        self.max_banks = max_banks
        self.fused = fused
        self._specs: dict[str, _BankSpec] = {}
        self._built: collections.OrderedDict[str, Any] = (
            collections.OrderedDict())
        self.builds = 0
        self.hits = 0
        self.evictions = 0

    def register(self, tenant: str, refs, decoys=None, *,
                 pin: bool = False, precursor=None,
                 decoy_precursor=None) -> None:
        """Record a tenant's bank recipe (no packing happens yet).
        Re-registering replaces the spec and drops any stale built bank.
        ``precursor`` (and ``decoy_precursor``) make it an OMS bank."""
        self._specs[tenant] = _BankSpec(
            refs=refs, decoys=decoys, dim=int(refs.shape[-1]), pinned=pin,
            precursor=precursor, decoy_precursor=decoy_precursor)
        self._built.pop(tenant, None)

    def adopt(self, tenant: str, db, *, pin: bool = True) -> None:
        """Install an already-built bank (no spec; cannot be rebuilt if
        evicted, hence pinned by default)."""
        self._specs[tenant] = _BankSpec(refs=None, decoys=None, dim=db.dim,
                                        pinned=pin)
        self._built[tenant] = db
        self._built.move_to_end(tenant)

    def dim(self, tenant: str) -> int:
        """The tenant's HV dimension, available without building the bank."""
        return self._specs[tenant].dim

    def is_built(self, tenant: str) -> bool:
        return tenant in self._built

    def pin(self, tenant: str) -> None:
        self._specs[tenant].pinned = True

    def get(self, tenant: str):
        """The tenant's ShardedDatabase, building it on first use and
        LRU-touching it."""
        spec = self._specs[tenant]  # KeyError for unknown tenants
        db = self._built.get(tenant)
        if db is None:
            if spec.refs is None:
                raise KeyError(
                    f"tenant {tenant!r} bank was adopted pre-built, then "
                    f"evicted; re-register or adopt it again")
            from repro_torch.serve.db_search import shard_database
            db = shard_database(spec.refs, decoys=spec.decoys,
                                pack=self.pack, fused=self.fused,
                                precursor=spec.precursor,
                                decoy_precursor=spec.decoy_precursor)
            self.builds += 1
            self._built[tenant] = db
        else:
            self.hits += 1
        self._built.move_to_end(tenant)
        self._evict_cold()
        return db

    def _evict_cold(self) -> None:
        if self.max_banks is None:
            return
        while len(self._built) > self.max_banks:
            victim = next((t for t in self._built
                           if not self._specs[t].pinned), None)
            if victim is None:  # everything pinned: nothing evictable
                return
            del self._built[victim]
            self.evictions += 1

    def summary(self) -> dict:
        return {
            "registered": len(self._specs),
            "built": len(self._built),
            "pinned": sum(s.pinned for s in self._specs.values()),
            "builds": self.builds,
            "hits": self.hits,
            "evictions": self.evictions,
        }

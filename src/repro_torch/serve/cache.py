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

Counterpart of ``repro.serve.cache``, streaming ingestion included: the
registry lands appended rows in a per-tenant delta bank
(:mod:`repro_torch.serve.delta`) and compacts it into the packed base.
A tenant registered with ``precursor=`` gets an OMS bank
(precursor-sorted blocks; see :mod:`repro_torch.serve.oms`).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
from typing import Any

import numpy as np
import torch


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

    def __contains__(self, key: bytes) -> bool:
        """Non-mutating membership test (no LRU touch, no counters)."""
        return key in self._entries

    @property
    def current_bytes(self) -> int:
        return self._bytes

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

    def get_or_encode(self, raw: Any, encode, *, variant: str = ""
                      ) -> tuple[np.ndarray, bool]:
        """Memoized ``encode(raw)``. Returns (encoded row, was_hit)."""
        key = self.content_key(raw, variant=variant)
        row = self.lookup(key)
        if row is not None:
            return row, True
        row = np.asarray(encode(raw))
        self.insert(key, row)
        return row, False

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

    **Streaming ingestion**: ``append`` lands new refs/decoys in a small
    unpacked per-tenant :class:`~repro_torch.serve.delta.DeltaBank` on the
    spec's device; callers that search via ``get_with_delta`` get an exact
    merged top-k over base + delta (bit-identical to re-registering the
    concatenated arrays). ``compact`` folds the delta back into the packed
    base: the merged bank is built *before* the spec/built swap, so a
    failed build leaves the registry untouched, and invalidation is scoped
    to the compacted tenant (every other tenant's built bank and the
    content-keyed query-HV cache are unaffected). A batch already in
    flight keeps the bank and delta it was dispatched with.

    With ``mesh=`` every bank is built row-sharded over its ``axis``
    (:func:`~repro_torch.serve.db_search.shard_database`): each rank holds
    its own block, on the mesh's device, and a tenant's delta lives there
    too. The specs' rows may stay on the host.
    """

    def __init__(self, *, mesh=None, axis: str = "model",
                 pack: bool | str = "auto",
                 max_banks: int | None = None, fused: bool = False,
                 emulate_shards: int | None = None):
        if max_banks is not None and max_banks < 1:
            raise ValueError(f"max_banks must be >= 1, got {max_banks}")
        self.mesh = mesh
        self.axis = axis
        self.pack = pack
        self.max_banks = max_banks
        self.fused = fused
        self.emulate_shards = emulate_shards
        self._specs: dict[str, _BankSpec] = {}
        self._built: collections.OrderedDict[str, Any] = (
            collections.OrderedDict())
        self._deltas: dict[str, Any] = {}  # tenant -> DeltaBank
        self.builds = 0
        self.hits = 0
        self.evictions = 0
        self.appends = 0
        self.compactions = 0

    def __len__(self) -> int:
        return len(self._specs)

    def tenants(self) -> list[str]:
        return list(self._specs)

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
        self._deltas.pop(tenant, None)

    def adopt(self, tenant: str, db, *, pin: bool = True) -> None:
        """Install an already-built bank (no spec; cannot be rebuilt if
        evicted, hence pinned by default)."""
        self._specs[tenant] = _BankSpec(refs=None, decoys=None, dim=db.dim,
                                        pinned=pin)
        self._built[tenant] = db
        self._built.move_to_end(tenant)
        self._deltas.pop(tenant, None)

    def dim(self, tenant: str) -> int:
        """The tenant's HV dimension, available without building the bank."""
        return self._specs[tenant].dim

    def is_built(self, tenant: str) -> bool:
        return tenant in self._built

    def pin(self, tenant: str) -> None:
        self._specs[tenant].pinned = True

    def unpin(self, tenant: str) -> None:
        self._specs[tenant].pinned = False

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
                                mesh=self.mesh, axis=self.axis,
                                pack=self.pack, fused=self.fused,
                                emulate_shards=self.emulate_shards,
                                precursor=spec.precursor,
                                decoy_precursor=spec.decoy_precursor)
            self.builds += 1
            self._built[tenant] = db
        else:
            self.hits += 1
        self._built.move_to_end(tenant)
        self._evict_cold()
        return db

    # -- streaming ingestion (delta banks + compaction) --------------------

    def append(self, tenant: str, refs, decoys=None, *, precursor=None,
               decoy_precursor=None) -> int:
        """Land new refs (+ optional decoys) in the tenant's delta bank.

        O(delta) per call: the packed base is untouched; search via
        :meth:`get_with_delta` merges exactly. Returns the delta's total
        row count. Adopted (spec-less) banks cannot accept appends: a
        later compaction could not rebuild them.
        """
        spec = self._specs[tenant]  # KeyError for unknown tenants
        if spec.refs is None:
            raise ValueError(
                f"tenant {tenant!r} bank was adopted pre-built; appends "
                f"need the raw spec so compaction can rebuild: use "
                f"register() instead of adopt()")
        delta = self._deltas.get(tenant)
        if delta is None:
            from repro_torch.serve.delta import DeltaBank
            delta = DeltaBank(spec.dim, oms=spec.precursor is not None,
                              device=self._bank_device(spec.refs))
            self._deltas[tenant] = delta
        rows = delta.append(refs, decoys, precursor=precursor,
                            decoy_precursor=decoy_precursor)
        self.appends += 1
        return rows

    def delta(self, tenant: str):
        """The tenant's DeltaBank, or None when it has no appended rows."""
        d = self._deltas.get(tenant)
        return d if d is not None and d.num_rows else None

    def get_with_delta(self, tenant: str):
        """(base bank, delta-or-None): the pair a merged search needs."""
        return self.get(tenant), self.delta(tenant)

    def tenants_with_delta(self) -> list[str]:
        return [t for t, d in self._deltas.items() if d.num_rows]

    def _base_rows(self, tenant: str) -> int:
        spec = self._specs[tenant]
        if spec.refs is None:
            db = self._built.get(tenant)
            return db.num_rows if db is not None else 0
        rows = int(spec.refs.shape[0])
        if spec.decoys is not None:
            rows += int(spec.decoys.shape[0])
        return rows

    def delta_fraction(self, tenant: str) -> float:
        """Appended rows / total rows: the compaction trigger metric."""
        d = self.delta(tenant)
        if d is None:
            return 0.0
        total = self._base_rows(tenant) + d.num_rows
        return d.num_rows / total if total else 0.0

    def compact(self, tenant: str) -> bool:
        """Fold the tenant's delta into its packed base.

        Builds the merged bank from the concatenated spec + delta arrays
        *first*, then swaps spec, built bank and delta together: a build
        failure leaves the registry exactly as it was, and other tenants'
        built banks are never touched. Returns False when there is nothing
        to compact.
        """
        d = self.delta(tenant)
        if d is None:
            return False
        spec = self._specs[tenant]
        dev = _device_of(spec.refs)
        refs = torch.cat([_rows_on(spec.refs, dev), d.refs.to(dev)])
        n_dec = 0 if spec.decoys is None else int(spec.decoys.shape[0])
        decoys = None
        if n_dec or d.num_decoys:
            old_dec = (_rows_on(spec.decoys, dev) if n_dec else
                       torch.zeros((0, spec.dim), dtype=torch.int8,
                                   device=dev))
            decoys = torch.cat([old_dec, d.decoys.to(dev)])
            del old_dec
        precursor = decoy_precursor = None
        if spec.precursor is not None:
            precursor = np.concatenate(
                [np.asarray(spec.precursor, np.float32), d.precursor])
            if decoys is not None:
                base_dprec = (spec.decoy_precursor
                              if spec.decoy_precursor is not None
                              else spec.precursor)
                base_dprec = np.asarray(base_dprec, np.float32)[:n_dec]
                decoy_precursor = np.concatenate(
                    [base_dprec, d.decoy_precursor])
        from repro_torch.serve.db_search import shard_database
        db = shard_database(refs, decoys=decoys, mesh=self.mesh,
                            axis=self.axis, pack=self.pack,
                            fused=self.fused,
                            emulate_shards=self.emulate_shards,
                            precursor=precursor,
                            decoy_precursor=decoy_precursor)
        self.builds += 1
        # atomic swap: spec + built bank + delta change together, and only
        # for this tenant
        self._specs[tenant] = _BankSpec(
            refs=refs, decoys=decoys, dim=spec.dim, pinned=spec.pinned,
            precursor=precursor, decoy_precursor=decoy_precursor)
        self._built[tenant] = db
        self._built.move_to_end(tenant)
        del self._deltas[tenant]
        self.compactions += 1
        self._evict_cold()
        return True

    def _bank_device(self, rows) -> torch.device:
        """Where a tenant's banks live: the mesh's device when its axis is
        sharded, else the device of the spec's rows."""
        from repro_torch.dist.sharding import mesh_shape
        if (self.mesh is not None
                and mesh_shape(self.mesh).get(self.axis, 1) > 1):
            from repro_torch.serve.db_search import _mesh_device
            return _mesh_device(self.mesh)
        return _device_of(rows)

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
            "appends": self.appends,
            "compactions": self.compactions,
            "delta_rows": sum(d.num_rows for d in self._deltas.values()),
            "tenants_with_delta": len(self.tenants_with_delta()),
        }


def _device_of(rows) -> torch.device:
    return rows.device if isinstance(rows, torch.Tensor) else (
        torch.device("cpu"))


def _rows_on(rows, device: torch.device) -> torch.Tensor:
    """A spec's HV rows as an int8 tensor on ``device``."""
    if isinstance(rows, torch.Tensor):
        return rows.to(device, torch.int8)
    return torch.from_numpy(np.asarray(rows, np.int8)).to(device)

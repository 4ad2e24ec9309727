"""HD database search and its serving loop, in PyTorch: per-shard top-k,
k-merge, target-decoy FDR, micro-batched multi-tenant serving.

Counterpart of the exact-search slice of ``repro.serve.db_search``. One
card holds the whole bank, so there is no mesh: a bank is searched whole,
or split into ``emulate_shards`` row blocks that run the identical
local-top-k / merge pipeline one after another (the reference's tier-1
stand-in for its shard_map path).

**Routes.** Per shard, the unfused route materialises the (Q, rows)
score matrix and takes :func:`topk_value_desc_index_asc`; the fused
route (``fused=True`` banks) streams the rows through the
``topk_hamming`` kernel; the fused end-to-end route
(``search_database_levels(..., fused_e2e=True)``) takes raw quantized
levels through the ``encode_search`` kernel, so the query hypervector
never reaches device memory. All are bit-identical: indices, scores and
tie order.

**Bit-identity of the merge.** Ties go to the lower row. Each shard's
top-k lists tied rows in ascending global order and the merge
concatenates shards in ascending order, so the stable merge picks the
rows the unsharded search would; a row its shard prunes is beaten by k
rows of that shard. Pad rows past ``num_rows`` score ``INT32_MIN``.

**FDR routing.** Decoys are stored before targets, so a target/decoy tie
at rank 0 resolves to the decoy (the conservative competition), and rank
0 alone decides the competition fed to :func:`fdr_filter`.

**Serving.** :class:`DBSearchServer` takes tenant-homogeneous batches
from :class:`~repro_torch.serve.queue.MicroBatchQueue`, banks from a
:class:`~repro_torch.serve.cache.BankRegistry`, memoizes query encodes
in a :class:`~repro_torch.serve.cache.QueryHVCache`, pads batches to a
bucket ladder, and runs device work behind :class:`SearchExecutor`'s
dispatch / poll / finalize seam (flush-sync: dispatch, then finalize).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as nnf

from repro_torch.core.hd.encoding import (
    HDEncoderConfig,
    encode_levels_batch,
    make_codebooks,
)
from repro_torch.core.hd.similarity import (
    INT32_MIN,
    bitpack_bipolar,
    dot_similarity,
    hamming_similarity_packed,
    topk_value_desc_index_asc,
)
from repro_torch.serve.cache import BankRegistry, QueryHVCache
from repro_torch.serve.queue import LatencyStats, MicroBatchQueue, Request
from repro_torch.spectra.fdr import fdr_filter


# --------------------------------------------------------------------------
# per-shard compute + merge
# --------------------------------------------------------------------------

def _local_scores(queries, refs_local, *, dim: int, packed: bool
                  ) -> torch.Tensor:
    """(Q, *) x (Rl, *) -> (Q, Rl) int32 dot-product-scale scores."""
    if packed:
        return 2 * hamming_similarity_packed(queries, refs_local, dim) - dim
    return dot_similarity(queries, refs_local)


def _local_topk(scores, base: int, k: int, num_rows: int):
    """Per-shard top-k with the padding mask (written into ``scores`` in
    place) and global index translation. Returns (vals (Q, k),
    global_idx (Q, k))."""
    pad_from = max(0, num_rows - base)
    if pad_from < scores.shape[-1]:
        scores[:, pad_from:] = INT32_MIN
    vals, local_idx = topk_value_desc_index_asc(scores, k)
    return vals, local_idx.to(torch.int32) + base


def _shard_num_valid(num_rows: int, base: int, shard_rows: int) -> int:
    return min(max(num_rows - base, 0), shard_rows)


def _local_topk_fused(queries, refs_local, base: int, k: int, num_rows: int,
                      dim: int):
    """Streaming-kernel twin of ``_local_scores`` + ``_local_topk``: the
    shard's score matrix never reaches device memory."""
    from repro_torch.kernels.topk_hamming import topk_hamming
    nv = _shard_num_valid(num_rows, base, refs_local.shape[0])
    idx, vals = topk_hamming(queries, refs_local, dim=dim, k=k, num_valid=nv)
    return vals, idx + base


def _merge_topk(cand_vals, cand_idx, k: int):
    """Global top-k over per-shard candidates (Q, n*k), concatenated in
    ascending shard order. Returns (idx (Q, k), vals (Q, k))."""
    vals, pos = topk_value_desc_index_asc(cand_vals, k)
    return torch.gather(cand_idx, 1, pos), vals


# --------------------------------------------------------------------------
# the bank
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardedDatabase:
    """A reference bank prepared for search.

    data holds ``num_shards * shard_rows`` rows (zero-padded past
    ``num_rows``), int32 bit-packed words when ``packed``, else int8;
    rows ``[0, num_decoys)`` are decoys, ``[num_decoys, num_rows)``
    targets.
    """

    data: torch.Tensor
    num_rows: int
    num_decoys: int
    dim: int
    shard_rows: int
    packed: bool
    emulated_shards: int = 1
    fused: bool = False

    @property
    def num_shards(self) -> int:
        return self.emulated_shards

    def shard(self, s: int) -> torch.Tensor:
        return self.data[s * self.shard_rows:(s + 1) * self.shard_rows]


def shard_database(refs: torch.Tensor, *, decoys: torch.Tensor | None = None,
                   pack: bool | str = "auto",
                   emulate_shards: int | None = None,
                   fused: bool = False) -> ShardedDatabase:
    """Build a :class:`ShardedDatabase` from bipolar (R, D) reference HVs,
    on their device.

    decoys: optional (Rd, D) decoy HVs, stored *before* the targets.
    pack: True / False / "auto" (bit-pack whenever D % 32 == 0).
    emulate_shards: split the bank into this many equal row blocks,
      searched one after another and merged.
    fused: search each shard with the ``topk_hamming`` kernel.
    """
    dim = int(refs.shape[-1])
    blocks = [refs]
    num_decoys = 0
    if decoys is not None:
        if decoys.shape[-1] != dim:
            raise ValueError(f"decoy dim {decoys.shape[-1]} != ref dim {dim}")
        num_decoys = int(decoys.shape[0])
        blocks = [decoys, refs]
    num_rows = sum(int(b.shape[0]) for b in blocks)
    if pack == "auto":
        packed = dim % 32 == 0
    else:
        packed = bool(pack)
        if packed and dim % 32 != 0:
            raise ValueError(f"pack=True requires D % 32 == 0, got D={dim}")
    # packed block by block: the unpacked bank is never concatenated
    store = torch.cat([bitpack_bipolar(b) if packed else b.to(torch.int8)
                       for b in blocks])
    n = int(emulate_shards or 1)
    shard_rows = -(-num_rows // n)
    pad_rows = n * shard_rows - num_rows
    if pad_rows:
        store = nnf.pad(store, (0, 0, 0, pad_rows))
    return ShardedDatabase(data=store.contiguous(), num_rows=num_rows,
                           num_decoys=num_decoys, dim=dim,
                           shard_rows=shard_rows, packed=packed,
                           emulated_shards=n, fused=bool(fused))


def encode_queries(db: ShardedDatabase, queries: torch.Tensor
                   ) -> torch.Tensor:
    """Encode (Q, D) bipolar queries into the bank's storage form
    (deterministic, hence safe to memoize)."""
    return bitpack_bipolar(queries) if db.packed else queries.to(torch.int8)


def _check_k(db: ShardedDatabase, k: int) -> None:
    if k > db.num_rows:
        raise ValueError(f"k={k} > bank rows {db.num_rows}")
    if k > db.shard_rows:
        raise ValueError(
            f"k={k} exceeds shard_rows={db.shard_rows}; use fewer shards or "
            f"a smaller k (local top-k needs k candidates per shard)")


def _over_shards(db: ShardedDatabase, k: int, local):
    """Runs ``local(refs_local, base) -> (vals, global_idx)`` per shard and
    merges; a single shard needs no merge."""
    if db.num_shards == 1:
        vals, gidx = local(db.data, 0)
        return gidx, vals
    vals_blocks, idx_blocks = [], []
    for s in range(db.num_shards):
        vals, gidx = local(db.shard(s), s * db.shard_rows)
        vals_blocks.append(vals)
        idx_blocks.append(gidx)
    return _merge_topk(torch.cat(vals_blocks, dim=1),
                       torch.cat(idx_blocks, dim=1), k)


def search_database_encoded(db: ShardedDatabase, q_enc: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over *already encoded* queries (see :func:`encode_queries`):
    (indices (Q, k), scores (Q, k)) over global bank rows."""
    _check_k(db, k)

    def local(refs_local, base):
        if db.fused:
            return _local_topk_fused(q_enc, refs_local, base, k, db.num_rows,
                                     db.dim)
        scores = _local_scores(q_enc, refs_local, dim=db.dim,
                               packed=db.packed)
        return _local_topk(scores, base, k, db.num_rows)

    return _over_shards(db, k, local)


def search_database(db: ShardedDatabase, queries: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (Q, D) bipolar queries, bit-identical to ``topk_search``
    over the unsharded bank."""
    return search_database_encoded(db, encode_queries(db, queries), k)


# --------------------------------------------------------------------------
# end-to-end routes: raw quantized spectra in, top-k out
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QueryEncoder:
    """The query-side HD codebooks (Eq. 1), from the same configuration the
    bank was encoded with, so the server can take raw (F,) level vectors
    and encode on the device, staged or fused."""

    id_hvs: torch.Tensor     # (F, D) int8 bipolar ID codebook
    level_hvs: torch.Tensor  # (m, D) int8 bipolar level codebook

    @property
    def num_features(self) -> int:
        return int(self.id_hvs.shape[0])

    @property
    def dim(self) -> int:
        return int(self.id_hvs.shape[1])

    @property
    def num_levels(self) -> int:
        return int(self.level_hvs.shape[0])

    @functools.cached_property
    def codebook_words(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The bit-packed codebooks the fused kernel reads, packed once."""
        from repro_torch.kernels.encode_search import pack_codebook
        return pack_codebook(self.id_hvs), pack_codebook(self.level_hvs)

    @classmethod
    def from_config(cls, *, dim: int, num_features: int, num_levels: int,
                    seed: int = 0, device: str | torch.device = "cuda"
                    ) -> "QueryEncoder":
        id_hvs, level_hvs = make_codebooks(HDEncoderConfig(
            dim=dim, num_features=num_features, num_levels=num_levels,
            seed=seed), device=device)
        return cls(id_hvs=id_hvs, level_hvs=level_hvs)


def _check_levels(db: ShardedDatabase, enc: QueryEncoder, levels) -> None:
    if enc.dim != db.dim:
        raise ValueError(f"encoder dim {enc.dim} != bank dim {db.dim}")
    if levels.ndim != 2 or levels.shape[1] != enc.num_features:
        raise ValueError(f"levels shape {tuple(levels.shape)} != "
                         f"(Q, {enc.num_features})")


def _local_topk_e2e(levels, enc: QueryEncoder, refs_local, base: int, k: int,
                    num_rows: int, dim: int):
    """Fused per-shard encode + top-k: one ``encode_search`` launch."""
    from repro_torch.kernels.encode_search import encode_search
    nv = _shard_num_valid(num_rows, base, refs_local.shape[0])
    idx, vals = encode_search(levels, enc.id_hvs, enc.level_hvs, refs_local,
                              dim=dim, k=k, num_valid=nv,
                              codebook_words=enc.codebook_words)
    return vals, idx + base


def search_database_levels(db: ShardedDatabase, enc: QueryEncoder,
                           levels: torch.Tensor, k: int, *,
                           fused_e2e: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k straight from raw (Q, F) quantized levels: staged (Eq. 1
    encode -> bank-form encode -> :func:`search_database_encoded`) or,
    with ``fused_e2e``, one ``encode_search`` launch per shard. Both are
    bit-identical."""
    levels = levels.to(torch.int32).contiguous()
    _check_levels(db, enc, levels)
    if not fused_e2e:
        hv = encode_levels_batch(levels, enc.id_hvs, enc.level_hvs)
        return search_database_encoded(db, encode_queries(db, hv), k)
    _check_k(db, k)
    return _over_shards(db, k, lambda refs_local, base: _local_topk_e2e(
        levels, enc, refs_local, base, k, db.num_rows, db.dim))


# --------------------------------------------------------------------------
# FDR routing over merged results
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FDRSearchResult:
    """Batch search output after target-decoy FDR filtering; ``match`` is
    the target-library row (bank row minus num_decoys) of accepted
    queries, -1 otherwise."""

    indices: np.ndarray    # (Q, k) global bank rows
    scores: np.ndarray     # (Q, k)
    is_target: np.ndarray  # (Q,) rank-0 candidate is a target (and valid)
    accept: np.ndarray     # (Q,) passed FDR
    match: np.ndarray      # (Q,) accepted target row or -1


def fdr_route(db: ShardedDatabase, indices: torch.Tensor,
              scores: torch.Tensor, fdr: float = 0.01) -> FDRSearchResult:
    """Target-decoy competition on rank 0 + the FDR filter over the batch."""
    nd = db.num_decoys
    top_idx = indices[:, 0]
    top_val = scores[:, 0]
    is_target = top_idx >= nd
    accept = fdr_filter(top_val.to(torch.float32), is_target, fdr=fdr)
    match = torch.where(accept & is_target, top_idx - nd,
                        torch.full_like(top_idx, -1))

    def host(t):
        return t.cpu().numpy()

    return FDRSearchResult(
        indices=host(indices), scores=host(scores),
        is_target=host(is_target), accept=host(accept), match=host(match))


def search_with_fdr(db: ShardedDatabase, queries: torch.Tensor, k: int,
                    fdr: float = 0.01) -> FDRSearchResult:
    """Top-k search + FDR post-filtering in one call."""
    idx, vals = search_database(db, queries, k)
    return fdr_route(db, idx, vals, fdr=fdr)


# --------------------------------------------------------------------------
# shape-bucketed dispatch
# --------------------------------------------------------------------------

def make_buckets(max_batch_size: int, num_buckets: int = 4
                 ) -> tuple[int, ...]:
    """Geometric batch-size ladder ending at ``max_batch_size``, e.g.
    ``make_buckets(32, 4) == (4, 8, 16, 32)``."""
    if max_batch_size < 1:
        raise ValueError(f"max_batch_size must be >= 1, got {max_batch_size}")
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    bs = [int(max_batch_size)]
    while len(bs) < num_buckets and bs[-1] > 1:
        bs.append(bs[-1] // 2)
    return tuple(sorted(set(bs)))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n (buckets sorted ascending)."""
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


# --------------------------------------------------------------------------
# serving loop
# --------------------------------------------------------------------------

@dataclasses.dataclass
class QueryResult:
    """Per-request result attached by the server."""

    indices: np.ndarray  # (k,) global bank rows
    scores: np.ndarray   # (k,)
    is_target: bool
    accept: bool
    match: int           # accepted target-library row or -1


@dataclasses.dataclass
class BatchHandle:
    """One dispatched batch's in-flight device work. ``batch`` is the
    bucket-padded device batch the route searched (encoded rows, or raw
    levels on the fused-e2e route). ``start`` and ``done`` are timing
    events recorded on the current stream around the search (None on the
    CPU)."""

    reqs: list[Request]
    tenant: str
    db: ShardedDatabase
    n: int                # real rows (the rest is bucket padding)
    batch: torch.Tensor
    idx: torch.Tensor
    vals: torch.Tensor
    start: torch.cuda.Event | None = None
    done: torch.cuda.Event | None = None


class SearchExecutor:
    """The device executor behind the dispatch / poll / finalize seam.

    * ``dispatch`` stamps ``t_dispatch``, assembles the bucket-padded
      batch (through the query-HV cache on the encoded routes), copies it
      to the bank's device and launches the search without waiting;
    * ``poll`` asks the batch's CUDA event whether the search finished;
    * ``finalize`` waits for the results, routes FDR, fills per-request
      results, stamps ``t_done``, records latency and adds the search's
      device time (start to done event) to ``server.device_busy_s``.

    Pass a subclass as ``DBSearchServer(executor_cls=...)`` to observe or
    replace batches.
    """

    def __init__(self, server: "DBSearchServer"):
        self.server = server

    def dispatch(self, reqs: list[Request]) -> BatchHandle:
        srv = self.server
        t = srv._clock()
        for r in reqs:
            r.t_dispatch = t
        tenant = reqs[0].tenant
        db = srv.banks.get(tenant)  # lazy build on first use
        n = len(reqs)
        bucket = bucket_for(n, srv.buckets)
        srv._bucket_counts[bucket] += 1
        dev = db.data.device
        e2e = srv.encoder is not None and srv.fused_e2e
        batch = torch.from_numpy(
            srv._levels_batch(reqs, bucket) if e2e
            else srv._encode_batch(reqs, db, bucket, tenant)).to(dev)
        start = done = None
        if dev.type == "cuda":
            start, done = (torch.cuda.Event(enable_timing=True)
                           for _ in range(2))
            start.record()
        if e2e:
            idx, vals = search_database_levels(db, srv.encoder, batch, srv.k,
                                               fused_e2e=True)
        else:
            idx, vals = search_database_encoded(db, batch, srv.k)
        if done is not None:
            done.record()
        return BatchHandle(reqs=reqs, tenant=tenant, db=db, n=n, batch=batch,
                           idx=idx, vals=vals, start=start, done=done)

    def poll(self, handle: BatchHandle) -> bool:
        return True if handle.done is None else handle.done.query()

    def finalize(self, handle: BatchHandle) -> list[Request]:
        srv = self.server
        n = handle.n
        idx = handle.idx[:n].cpu()   # waits for the device
        vals = handle.vals[:n].cpu()
        if handle.start is not None:
            srv.device_busy_s = ((srv.device_busy_s or 0.0)
                                 + handle.start.elapsed_time(handle.done)
                                 / 1e3)
        routed = fdr_route(handle.db, idx, vals, fdr=srv.fdr)
        t_done = srv._clock()
        live: list[Request] = []
        for i, r in enumerate(handle.reqs):
            if r.cancelled:
                continue
            r.result = QueryResult(
                indices=routed.indices[i], scores=routed.scores[i],
                is_target=bool(routed.is_target[i]),
                accept=bool(routed.accept[i]), match=int(routed.match[i]))
            r.t_done = t_done
            live.append(r)
        if live:
            srv.stats.record_batch(live)
            srv.tenant_stats.setdefault(
                handle.tenant, LatencyStats()).record_batch(live)
        return live


_NUMPY_DTYPE = {torch.int32: np.int32, torch.int8: np.int8}


class DBSearchServer:
    """Micro-batched, multi-tenant DB-search server (flush-sync host loop).

    Requests carry encoded bipolar query HVs (D,), or raw quantized level
    vectors (F,) when the server holds a :class:`QueryEncoder`, plus a
    tenant name; each tenant searches its own bank. ``step`` runs one
    micro-batch when the queue's flush policy fires: query rows are
    encoded through the content-hash :class:`QueryHVCache` (misses
    encoded once, as a batch), the batch is padded to the nearest bucket
    (pad rows are sliced off before FDR), searched, routed through
    per-batch FDR, and timed into the aggregate and per-tenant
    :class:`LatencyStats`. With ``fused_e2e=True`` the levels go to the
    fused encode->search kernel and skip the cache (nothing intermediate
    exists to memoize).
    """

    def __init__(self, db: ShardedDatabase | BankRegistry, *, k: int = 4,
                 fdr: float = 0.01, max_batch_size: int = 32,
                 flush_timeout_s: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 cache_bytes: int | None = 64 << 20,
                 buckets: int | Sequence[int] | None = None,
                 fairness_cap: int | None = None,
                 encoder: QueryEncoder | None = None,
                 fused_e2e: bool = False,
                 executor_cls: type[SearchExecutor] = SearchExecutor):
        if isinstance(db, BankRegistry):
            self.db = None
            self.banks = db
        else:
            self.db = db
            self.banks = BankRegistry()
            self.banks.adopt("default", db, pin=True)
        self.k = int(k)
        self.fdr = float(fdr)
        self.max_batch_size = int(max_batch_size)
        if buckets is None:
            self.buckets: tuple[int, ...] = (self.max_batch_size,)
        elif isinstance(buckets, int):
            self.buckets = make_buckets(self.max_batch_size, buckets)
        else:
            sizes = {int(b) for b in buckets if 1 <= int(b) <= max_batch_size}
            self.buckets = tuple(sorted(sizes | {self.max_batch_size}))
        self.queue = MicroBatchQueue(max_batch_size=max_batch_size,
                                     flush_timeout_s=flush_timeout_s,
                                     clock=clock, fairness_cap=fairness_cap)
        self.query_cache = (QueryHVCache(cache_bytes) if cache_bytes
                            else None)
        self.stats = LatencyStats()
        self.tenant_stats: dict[str, LatencyStats] = {}
        self._tenant_cache: dict[str, list[int]] = {}  # tenant -> [hits, misses]
        self._bucket_counts: collections.Counter[int] = collections.Counter()
        self._clock = clock
        self.encoder = encoder
        self.fused_e2e = bool(fused_e2e)
        if self.fused_e2e and encoder is None:
            raise ValueError("fused_e2e=True requires encoder=")
        self.executor = executor_cls(self)
        # seconds the device spent searching served batches (None until a
        # batch ran on a CUDA device)
        self.device_busy_s: float | None = None

    def submit(self, query_hv, tenant: str = "default") -> int:
        """Enqueue one query for ``tenant`` (which must be registered);
        returns the request id."""
        dim = self.banks.dim(tenant)  # KeyError for unknown tenants
        if self.encoder is not None:
            if self.encoder.dim != dim:
                raise ValueError(f"encoder dim {self.encoder.dim} != "
                                 f"bank dim {dim} for tenant {tenant!r}")
            q = np.asarray(query_hv, dtype=np.int32)
            if q.shape != (self.encoder.num_features,):
                raise ValueError(f"query shape {q.shape} != "
                                 f"({self.encoder.num_features},) levels")
        else:
            q = np.asarray(query_hv, dtype=np.int8)
            if q.shape != (dim,):
                raise ValueError(f"query shape {q.shape} != ({dim},)")
        return self.queue.submit(q, tenant=tenant)

    def _encode_rows(self, db: ShardedDatabase, qs: torch.Tensor
                     ) -> torch.Tensor:
        """Stacked raw queries -> the bank's storage form (the staged Eq. 1
        encode first when the server holds an encoder)."""
        if self.encoder is not None:
            hv = encode_levels_batch(qs.to(torch.int32), self.encoder.id_hvs,
                                     self.encoder.level_hvs)
            return encode_queries(db, hv)
        return encode_queries(db, qs)

    def _levels_batch(self, reqs: list[Request], bucket: int) -> np.ndarray:
        """The raw (bucket, F) level batch; pad rows are all-zero (every
        peak absent), inert under Eq. 1."""
        out = np.zeros((bucket, self.encoder.num_features), np.int32)
        for i, r in enumerate(reqs):
            out[i] = r.query
        return out

    def _encode_batch(self, reqs: list[Request], db: ShardedDatabase,
                      bucket: int, tenant: str) -> np.ndarray:
        """The (bucket, width) encoded batch, through the cache."""
        width = db.data.shape[-1]
        out = np.zeros((bucket, width), dtype=_NUMPY_DTYPE[db.data.dtype])
        dev = db.data.device
        cache = self.query_cache
        if cache is None:
            qs = torch.from_numpy(np.stack([r.query for r in reqs])).to(dev)
            out[: len(reqs)] = self._encode_rows(db, qs).cpu().numpy()
            return out
        variant = (f"{'e2e:' if self.encoder is not None else ''}"
                   f"{'packed' if db.packed else 'int8'}:{db.dim}")
        miss_pos, miss_keys = [], []
        hits = 0
        for i, r in enumerate(reqs):
            key = cache.content_key(r.query, variant=variant)
            row = cache.lookup(key)
            if row is None:
                miss_pos.append(i)
                miss_keys.append(key)
            else:
                out[i] = row
                hits += 1
        if miss_pos:
            qs = torch.from_numpy(
                np.stack([reqs[i].query for i in miss_pos])).to(dev)
            enc = self._encode_rows(db, qs).cpu().numpy()
            for j, i in enumerate(miss_pos):
                out[i] = enc[j]
                cache.insert(miss_keys[j], enc[j].copy())
        tc = self._tenant_cache.setdefault(tenant, [0, 0])
        tc[0] += hits
        tc[1] += len(miss_pos)
        return out

    def step(self, force: bool = False) -> list[Request]:
        """Runs at most one micro-batch, when the queue policy says so (or
        whenever requests are pending, with ``force``); returns the
        requests it completed."""
        if not (self.queue.ready() or (force and len(self.queue))):
            return []
        reqs = self.queue.take_batch()
        if not reqs:
            return []
        return self.executor.finalize(self.executor.dispatch(reqs))

    def run_until_drained(self) -> list[Request]:
        """Serve until the queue is empty; returns all completed requests."""
        done: list[Request] = []
        while len(self.queue):
            done.extend(self.step(force=True))
        return done

    def summary(self) -> dict:
        """Aggregate latency stats plus per-tenant accounting, query-cache
        and bank-registry counters, and bucket usage."""
        s = self.stats.summary()
        tenants = {}
        for t, st in self.tenant_stats.items():
            d = st.summary()
            h, m = self._tenant_cache.get(t, (0, 0))
            d["cache_hits"] = h
            d["cache_misses"] = m
            d["cache_hit_rate"] = h / (h + m) if h + m else 0.0
            tenants[t] = d
        s["tenants"] = tenants
        s["banks"] = self.banks.summary()
        s["query_cache"] = (self.query_cache.summary()
                            if self.query_cache else None)
        s["buckets"] = {int(b): int(c)
                        for b, c in sorted(self._bucket_counts.items())}
        s["mode"] = "flush-sync"
        s["device_busy_s"] = self.device_busy_s
        s["e2e"] = (None if self.encoder is None else {
            "fused": self.fused_e2e,
            "num_features": self.encoder.num_features,
            "num_levels": self.encoder.num_levels,
        })
        return s

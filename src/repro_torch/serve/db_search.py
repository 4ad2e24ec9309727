"""HD database search and its serving loop, in PyTorch: per-shard top-k,
k-merge, open-modification search, target-decoy FDR, micro-batched
multi-tenant serving.

Counterpart of ``repro.serve.db_search``. A bank is searched whole, or
split into ``emulate_shards`` row blocks that run the identical
local-top-k / merge pipeline one after another on one device (the
reference's tier-1 stand-in for its shard_map path), or row-sharded over
the ``model`` axis of a device mesh (``shard_database(mesh=)``).

**The mesh routes.** ``mesh`` is a ``DeviceMesh`` over a
``torch.distributed`` process group (:mod:`repro_torch.launch.mesh`),
one process a rank, every rank running the same calls on the same
queries (the reference's one controller becomes SPMD). When the mesh's
``axis`` has size n > 1 each rank keeps only its own block of
``shard_rows`` rows of the padded bank, on the mesh's device. Each route
then (1) splits the queries, and the OMS plan's bands, over ``data``
when ``Q % data_n == 0`` (the reference's rule), (2) runs the same
per-shard top-k on this rank's block, (3) gathers the (Q_local, k)
values and global rows over the ``model`` process group in ascending
model coordinate, (4) merges, and (5) gathers over ``data``, so every
rank returns the full (Q, k). A size-1 axis takes the local route.

**Routes.** Per shard, the unfused route materialises the (Q, rows)
score matrix and takes :func:`topk_value_desc_index_asc`; the fused
route (``fused=True`` banks) streams the rows through the
``topk_hamming`` kernel; the fused end-to-end route
(``search_database_levels(..., fused_e2e=True)``) takes raw quantized
levels through the ``encode_search`` kernel, so the query hypervector
never reaches device memory. All are bit-identical: indices, scores and
tie order.

**Open-modification search (OMS).** A bank built with ``precursor=``
stores each block (decoys, then targets) sorted by precursor mass
(:mod:`repro_torch.serve.oms`). A batch's host-side plan gives every
query one ``[start, start + len)`` row range per block; the OMS routes
mask rows outside those bands (unfused) or scan only them (the banded
``topk_hamming_banded`` and ``encode_search_banded`` kernels, one launch
per shard for both bands), merge, rewrite the ``INT32_MIN`` overflow
slots of windows narrower than k to the masked matrix's rows, and
translate the rows back through the sort permutation. Results are
bit-identical to masking the full score matrix over the sorted bank.

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
dispatch / poll / finalize seam: flush-sync (dispatch, then finalize) or
continuous (:class:`~repro_torch.serve.scheduler.ContinuousScheduler`,
``num_slots`` batches in flight; dispatch never waits for the device).
Appended rows (``append``) are searched exactly, merged with the base
bank (:mod:`repro_torch.serve.delta`), until a compaction folds them in.
Clustering requests (``submit_cluster``) are a second kind on the same
queue: per-tenant :class:`~repro_torch.serve.clustering.StreamingClusterer`
state, a distance launch at dispatch and the assign-or-spawn loop at
finalize.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from collections.abc import Mapping
from typing import Any, Callable, Sequence

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
    topk_search,
    topk_value_desc_index_asc,
)
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import all_gather_axis, mesh_shape
from repro_torch.kernels.topk_hamming.ops import BANDED_BLOCK_Q
from repro_torch.serve.cache import BankRegistry, QueryHVCache
from repro_torch.serve.clustering import ClusteringConfig, StreamingClusterer
from repro_torch.serve.oms import (
    OMSConfig,
    OMSPlan,
    PrecursorIndex,
    build_precursor_index,
    plan_candidates,
)
from repro_torch.serve.queue import LatencyStats, MicroBatchQueue, Request
from repro_torch.serve.scheduler import (
    ContinuousScheduler,
    CoordinatedScheduler,
)
from repro_torch.serve.staging import PinnedArena, StagingPool
from repro_torch.spectra.fdr import fdr_filter

_OMS_ALIGN = 128  # shard_rows alignment of OMS banks (the 128-row tile the
                  # plan prices), so a band clipped to a shard spans no more
                  # tiles than the plan's budget


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


def _local_oms_topk(q_enc, refs_local, base: int, k: int, num_rows: int,
                    dim: int, packed: bool, starts, ends):
    """Unfused per-shard OMS top-k: the shard's full score matrix masked to
    ``INT32_MIN`` outside every query's bands (global sorted-layout rows
    ``[starts[b], ends[b])``, each (B, Q)) and past ``num_rows``. This is
    the masked-matrix oracle restricted to one shard."""
    scores = _local_scores(q_enc, refs_local, dim=dim, packed=packed)
    col = base + torch.arange(refs_local.shape[0], dtype=torch.int32,
                              device=scores.device)[None, :]
    band = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    for b in range(starts.shape[0]):
        band |= (col >= starts[b][:, None]) & (col < ends[b][:, None])
    scores.masked_fill_(~(band & (col < num_rows)), INT32_MIN)
    vals, local_idx = topk_value_desc_index_asc(scores, k)
    return vals, local_idx.to(torch.int32) + base


def _shard_bands(starts, ends, base: int, shard_rows: int):
    """Global (B, Q) bands -> the shard's local [start, len) bands."""
    s_l = (starts - base).clamp(0, shard_rows)
    e_l = torch.maximum(ends - base, s_l).clamp(max=shard_rows)
    return s_l, e_l - s_l


def _local_oms_topk_fused(q_enc, refs_local, base: int, k: int, num_rows: int,
                          dim: int, starts, ends, num_tiles: int):
    """Banded-kernel twin of ``_local_oms_topk``: one
    ``topk_hamming_banded`` launch over both bands. Overflow slots keep
    the kernel's fillers (``canonicalize=False``); the caller rewrites
    them once, after the merge."""
    from repro_torch.kernels.topk_hamming import topk_hamming_banded
    shard_rows = refs_local.shape[0]
    s_l, l_l = _shard_bands(starts, ends, base, shard_rows)
    idx, vals = topk_hamming_banded(
        q_enc, refs_local, s_l, l_l, dim=dim, k=k,
        num_valid=_shard_num_valid(num_rows, base, shard_rows),
        num_tiles=num_tiles, canonicalize=False)
    return vals, idx + base


def _local_oms(q_enc, refs_local, base: int, k: int, num_rows: int, dim: int,
               packed: bool, fused: bool, starts, ends, num_tiles: int):
    """Per-shard OMS top-k, fused or unfused: (vals, global_idx)."""
    if fused:
        return _local_oms_topk_fused(q_enc, refs_local, base, k, num_rows,
                                     dim, starts, ends, num_tiles)
    return _local_oms_topk(q_enc, refs_local, base, k, num_rows, dim, packed,
                           starts, ends)


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

    With ``oms`` set (built with ``precursor=``) each block is stored
    sorted by precursor mass; ``oms.perm`` maps sorted rows back to the
    original rows, and ``perm`` is its copy on the bank's device. The OMS
    routes translate their results, so callers see original rows.

    On a mesh (``mesh`` set, its ``axis`` of size ``num_shards`` > 1)
    ``data`` holds this rank's block alone: rows ``[c * shard_rows, (c +
    1) * shard_rows)`` of the padded bank, where ``c = coords[axis]``;
    ``coords`` are this rank's coordinates on every mesh axis.
    """

    data: torch.Tensor
    num_rows: int
    num_decoys: int
    dim: int
    shard_rows: int
    packed: bool
    emulated_shards: int = 1
    fused: bool = False
    oms: PrecursorIndex | None = None
    perm: torch.Tensor | None = None
    mesh: Any = None
    axis: str = "model"
    coords: dict[str, int] | None = None

    @property
    def num_shards(self) -> int:
        if self.mesh is None:
            return self.emulated_shards
        return mesh_shape(self.mesh)[self.axis]

    def shard(self, s: int) -> torch.Tensor:
        if self.mesh is not None:
            raise ValueError("a mesh bank holds this rank's block alone")
        return self.data[s * self.shard_rows:(s + 1) * self.shard_rows]


def _check_mesh(mesh) -> None:
    """A mesh is a ``DeviceMesh`` with named dims or a ``{name: size}``
    mapping; anything else raises ``TypeError``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, (DeviceMesh, Mapping)):
        raise TypeError(f"mesh must be a DeviceMesh or a {{axis: size}} "
                        f"mapping, got {type(mesh).__name__}")


def _mesh_rank(mesh, axis: str) -> tuple[dict[str, int], torch.device]:
    """This rank's coordinates on ``mesh`` and the mesh's device (the
    current CUDA device for a ``cuda`` mesh). A mapping carries no
    process group, so its axis of size > 1 raises."""
    if isinstance(mesh, Mapping):
        raise ValueError(
            f"a mesh given as a mapping carries no process group: the "
            f"{axis!r} axis of size {mesh_shape(mesh)[axis]} needs a "
            f"DeviceMesh")
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())), (
        _mesh_device(mesh))


def _mesh_device(mesh) -> torch.device:
    """A ``DeviceMesh``'s device on this rank (the current CUDA device for
    a ``cuda`` mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_database(refs: torch.Tensor, *, decoys: torch.Tensor | None = None,
                   mesh=None, axis: str = "model",
                   pack: bool | str = "auto",
                   emulate_shards: int | None = None,
                   fused: bool = False,
                   precursor: np.ndarray | None = None,
                   decoy_precursor: np.ndarray | None = None
                   ) -> ShardedDatabase:
    """Build a :class:`ShardedDatabase` from bipolar (R, D) reference HVs,
    on their device.

    decoys: optional (Rd, D) decoy HVs, stored *before* the targets.
    mesh: a ``DeviceMesh`` (or a ``{name: size}`` mapping). When its
      ``axis`` has size n > 1 the bank is row-sharded over it: this rank
      gathers, packs and keeps only its own block of the padded bank, on
      the mesh's device (the rows may stay on the host until then). A
      size-1 axis, or none, takes the local route.
    pack: True / False / "auto" (bit-pack whenever D % 32 == 0).
    emulate_shards: split the bank into this many equal row blocks,
      searched one after another and merged (no mesh axis of size > 1).
    fused: search each shard with the ``topk_hamming`` kernel (the
      ``topk_hamming_banded`` kernel on the OMS routes).
    precursor: optional (R,) target precursor masses; enables the OMS
      routes. Each block is stored sorted by precursor (decoys still
      before targets) and the permutation is kept.
    decoy_precursor: the decoys' masses; defaults to ``precursor``
      (m/z-reversed decoys keep their target's mass).
    """
    mesh_n = 1
    if mesh is not None:
        _check_mesh(mesh)
        mesh_n = mesh_shape(mesh).get(axis, 1)
    emu = int(emulate_shards or 1)
    if emu > 1 and mesh_n > 1:
        raise ValueError("emulate_shards requires no (or size-1) mesh axis")
    dim = int(refs.shape[-1])
    blocks = [refs]
    num_decoys = 0
    if decoys is not None:
        if decoys.shape[-1] != dim:
            raise ValueError(f"decoy dim {decoys.shape[-1]} != ref dim {dim}")
        num_decoys = int(decoys.shape[0])
        blocks = [decoys, refs]
    num_rows = sum(int(b.shape[0]) for b in blocks)

    oms_index = None
    if precursor is not None:
        prec = np.asarray(precursor, np.float32).reshape(-1)
        if prec.shape[0] != int(refs.shape[0]):
            raise ValueError(f"precursor has {prec.shape[0]} entries for "
                             f"{int(refs.shape[0])} refs")
        dprec = None
        if decoys is not None:
            dprec = prec if decoy_precursor is None else np.asarray(
                decoy_precursor, np.float32).reshape(-1)
            if dprec.shape[0] != num_decoys:
                raise ValueError(f"decoy_precursor has {dprec.shape[0]} "
                                 f"entries for {num_decoys} decoys")
        oms_index = build_precursor_index(prec, dprec)
    if pack == "auto":
        packed = dim % 32 == 0
    else:
        packed = bool(pack)
        if packed and dim % 32 != 0:
            raise ValueError(f"pack=True requires D % 32 == 0, got D={dim}")
    n = mesh_n if mesh_n > 1 else emu
    shard_rows = -(-num_rows // n)
    if oms_index is not None and n > 1:
        # tile-aligned shard bases: a band clipped to a shard spans no
        # more tiles than the plan's budget
        shard_rows = -(-shard_rows // _OMS_ALIGN) * _OMS_ALIGN
    coords, dev = None, refs.device
    lo, hi, held = 0, num_rows, n * shard_rows
    if mesh_n > 1:
        coords, dev = _mesh_rank(mesh, axis)
        lo = coords[axis] * shard_rows
        hi, held = min(lo + shard_rows, num_rows), shard_rows
    store = _stored_rows(blocks, oms_index, lo, hi, packed, dim, dev)
    if held > store.shape[0]:
        store = nnf.pad(store, (0, 0, 0, held - store.shape[0]))
    return ShardedDatabase(
        data=store.contiguous(), num_rows=num_rows, num_decoys=num_decoys,
        dim=dim, shard_rows=shard_rows, packed=packed,
        emulated_shards=1 if mesh_n > 1 else n, fused=bool(fused),
        oms=oms_index,
        perm=None if oms_index is None else torch.from_numpy(
            oms_index.perm).to(store.device),
        mesh=mesh if mesh_n > 1 else None, axis=axis, coords=coords)


def _stored_rows(blocks: list, oms_index: PrecursorIndex | None, lo: int,
                 hi: int, packed: bool, dim: int, device: torch.device
                 ) -> torch.Tensor:
    """Rows ``[lo, hi)`` of the stored bank (the blocks concatenated, each
    sorted within itself by ``oms_index.perm`` when given), moved to
    ``device`` and packed (or cast to int8) block by block: the unpacked
    rows are never concatenated, and rows outside the range never leave
    their device."""
    parts = []
    b0 = 0
    for b in blocks:
        b1 = b0 + int(b.shape[0])
        a, z = max(lo, b0), min(hi, b1)
        if a < z:
            if oms_index is None:
                rows = b[a - b0:z - b0]
            else:
                rows = b[torch.from_numpy(oms_index.perm[a:z] - b0).to(
                    b.device, torch.int64)]
            rows = rows.to(device)
            parts.append(bitpack_bipolar(rows) if packed
                         else rows.to(torch.int8))
        b0 = b1
    if not parts:
        return torch.zeros((0, dim // 32 if packed else dim),
                           dtype=torch.int32 if packed else torch.int8,
                           device=device)
    return torch.cat(parts)


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


_ALL = slice(None)


def _over_shards(db: ShardedDatabase, k: int, num_queries: int, local):
    """Runs ``local(refs_local, base, rows) -> (vals, global_idx)`` per
    shard, on the queries ``rows`` (a slice), and merges; a single shard
    needs no merge. On a mesh this rank runs its own shard and the
    results travel as the module docstring says."""
    if db.mesh is not None:
        return _over_mesh(db, k, num_queries, local)
    if db.num_shards == 1:
        vals, gidx = local(db.data, 0, _ALL)
        return gidx, vals
    vals_blocks, idx_blocks = [], []
    for s in range(db.num_shards):
        vals, gidx = local(db.shard(s), s * db.shard_rows, _ALL)
        vals_blocks.append(vals)
        idx_blocks.append(gidx)
    return _merge_topk(torch.cat(vals_blocks, dim=1),
                       torch.cat(idx_blocks, dim=1), k)


def _over_mesh(db: ShardedDatabase, k: int, num_queries: int, local):
    """The process-group branch of :func:`_over_shards`: this rank's
    queries (split over ``data`` when ``num_queries % data_n == 0``) on
    this rank's block, gathered over ``db.axis`` in ascending coordinate,
    merged, and gathered over ``data``."""
    data_n = mesh_shape(db.mesh).get("data", 1)
    split = db.axis != "data" and data_n > 1 and num_queries % data_n == 0
    rows = _ALL
    if split:
        ql = num_queries // data_n
        d = db.coords["data"]
        rows = slice(d * ql, (d + 1) * ql)
    vals, gidx = local(db.data, db.coords[db.axis] * db.shard_rows, rows)
    idx, vals = _gather_merge(db, vals, gidx, k)
    if split:
        idx, vals = all_gather_axis(torch.stack([idx, vals]), db.mesh,
                                    "data", 1).unbind(0)
    return idx, vals


def _gather_merge(db: ShardedDatabase, vals, gidx, k: int):
    """This rank's (Q, k) candidates, values and global rows stacked into
    one int32 tensor, gathered over ``db.axis`` in ascending coordinate
    (one collective), then merged: (idx, vals)."""
    both = all_gather_axis(torch.stack([vals, gidx]), db.mesh, db.axis, 2)
    return _merge_topk(both[0], both[1], k)


def search_database_encoded(db: ShardedDatabase, q_enc: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over *already encoded* queries (see :func:`encode_queries`):
    (indices (Q, k), scores (Q, k)) over global bank rows."""
    _check_k(db, k)

    def local(refs_local, base, rows):
        if db.fused:
            return _local_topk_fused(q_enc[rows], refs_local, base, k,
                                     db.num_rows, db.dim)
        scores = _local_scores(q_enc[rows], refs_local, dim=db.dim,
                               packed=db.packed)
        return _local_topk(scores, base, k, db.num_rows)

    return _over_shards(db, k, q_enc.shape[0], local)


def search_database(db: ShardedDatabase, queries: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (Q, D) bipolar queries, bit-identical to ``topk_search``
    over the unsharded bank."""
    return search_database_encoded(db, encode_queries(db, queries), k)


def sharded_topk_search(queries: torch.Tensor, refs: torch.Tensor, k: int,
                        *, mesh=None, axis: str = "model",
                        num_shards: int | None = None,
                        pack: bool | str = "auto", fused: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot top-k over a bank (the oracle-comparable entry point):
    with ``num_shards`` > 1, the local-top-k / merge pipeline over that
    many emulated shards; with neither, plain ``topk_search``, or the
    ``topk_hamming`` kernel over the whole bank when ``fused``. All routes
    give the same (indices, scores), tie order included.

    With ``mesh`` (a ``DeviceMesh``, or a ``{name: size}`` mapping), the
    bank is row-sharded over ``axis`` (:func:`shard_database`) and every
    rank returns the full result; anything else passed as ``mesh`` raises
    ``TypeError``."""
    if mesh is not None:
        db = shard_database(refs, mesh=mesh, axis=axis, pack=pack,
                            fused=fused)
        return search_database(db, queries, k)
    if num_shards is None or num_shards <= 1:
        if not fused:
            return topk_search(queries, refs, k)
        num_shards = None
    db = shard_database(refs, pack=pack, emulate_shards=num_shards,
                        fused=fused)
    return search_database(db, queries, k)


# --------------------------------------------------------------------------
# open-modification search (OMS) routes
# --------------------------------------------------------------------------

def oms_plan(db: ShardedDatabase, query_prec: np.ndarray,
             cfg: OMSConfig | None = None) -> OMSPlan:
    """Host-side candidate plan of one query batch against an OMS bank:
    per-query per-block ``[start, len)`` ranges in the sorted layout and
    the tile budget of an 8-query block."""
    if db.oms is None:
        raise ValueError("bank was built without precursor=; OMS search "
                         "needs shard_database(..., precursor=...)")
    return plan_candidates(db.oms, np.asarray(query_prec),
                           cfg or OMSConfig(),
                           num_rows_padded=db.num_shards * db.shard_rows,
                           block_q=BANDED_BLOCK_Q)


def _upload(a: np.ndarray, device: torch.device, arena=None,
            name: str = "") -> torch.Tensor:
    """A host array on ``device``: through the pinned buffer ``name`` of
    ``arena`` (a :class:`~repro_torch.serve.staging.PinnedArena`; no host
    synchronization), else a plain copy."""
    if arena is not None:
        return arena.upload(name, a)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _plan_bands(db: ShardedDatabase, plan: OMSPlan, arena=None,
                name: str = "") -> tuple[torch.Tensor, torch.Tensor]:
    """The plan's (B, Q) global bands ``[starts, ends)`` on the bank's
    device."""
    dev = db.data.device
    starts = _upload(plan.starts, dev, arena, f"{name}starts")
    return starts, starts + _upload(plan.lens, dev, arena, f"{name}lens")


def oms_search_encoded(db: ShardedDatabase, q_enc: torch.Tensor,
                       plan: OMSPlan, k: int, *, arena=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """OMS top-k over already-encoded queries, ordered as ``plan``'s: every
    query scores only the bank rows inside its precursor window.
    Bit-identical (tie order and overflow slots included) to masking the
    full score matrix over the sorted bank outside the plan's bands,
    taking the top-k and translating the rows through ``db.oms.perm``.
    Returns original bank rows (decoys still ``< db.num_decoys``).
    ``arena`` stages the plan's bands without a host synchronization."""
    bands = _plan_bands(db, plan, arena)
    idx, vals = _oms_search_inner(db, q_enc, plan, k, bands)
    return _oms_finish(db, idx, vals, *bands)


def _oms_search_inner(db: ShardedDatabase, q_enc: torch.Tensor,
                      plan: OMSPlan, k: int, bands
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed banded search *before* the shared tail: top-k
    (sorted-layout idx, vals) with the kernels' overflow fillers still in
    place (sentinel-valued, ``canonicalize=False``). Callers,
    :func:`oms_search_encoded` and the base + delta merge of
    :mod:`repro_torch.serve.delta`, run the overflow canonicalization and
    the permutation against *their* index. ``bands`` are the plan's
    device bands (:func:`_plan_bands`)."""
    if db.oms is None:
        raise ValueError("bank was built without precursor=")
    _check_k(db, k)
    starts, ends = bands
    return _over_shards(db, k, q_enc.shape[0], lambda refs_local, base, rows:
                        _local_oms(q_enc[rows], refs_local, base, k,
                                   db.num_rows, db.dim, db.packed, db.fused,
                                   starts[:, rows], ends[:, rows],
                                   int(plan.num_tiles)))


def _oms_finish(db: ShardedDatabase, idx, vals, starts, ends):
    """Shared OMS tail: the merged search's overflow slots -> the masked
    matrix's ascending masked rows, then every (now in-range) sorted row
    -> its original bank row."""
    from repro_torch.kernels.topk_hamming import canonicalize_overflow_slots
    s_c = starts.clamp(0, db.num_rows)
    e_c = torch.maximum(ends, s_c).clamp(max=db.num_rows)
    idx = canonicalize_overflow_slots(idx, vals, s_c, e_c, db.num_rows)
    return db.perm[idx.to(torch.int64)], vals


def oms_search(db: ShardedDatabase, queries: torch.Tensor,
               query_prec: np.ndarray, k: int, cfg: OMSConfig | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, OMSPlan]:
    """Open-modification top-k of (Q, D) bipolar queries: (indices over
    original bank rows, scores, plan)."""
    plan = oms_plan(db, query_prec, cfg)
    idx, vals = oms_search_encoded(db, encode_queries(db, queries), plan, k)
    return idx, vals, plan


def oms_search_with_fdr(db: ShardedDatabase, queries: torch.Tensor,
                        query_prec: np.ndarray, k: int, fdr: float = 0.01,
                        cfg: OMSConfig | None = None) -> "FDRSearchResult":
    """OMS search + target-decoy FDR. Queries whose window is empty are
    left out of the FDR estimate and rejected."""
    idx, vals, plan = oms_search(db, queries, query_prec, k, cfg)
    return fdr_route(db, idx, vals, fdr=fdr,
                     valid=torch.from_numpy(plan.has_candidate).to(
                         idx.device))


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
    return _over_shards(db, k, levels.shape[0], lambda refs_local, base, rows:
                        _local_topk_e2e(levels[rows], enc, refs_local, base,
                                        k, db.num_rows, db.dim))


def _local_oms_e2e(levels, enc: QueryEncoder, refs_local, base: int, k: int,
                   num_rows: int, dim: int, starts, ends, num_tiles: int):
    """Fused per-shard OMS encode + top-k: one ``encode_search_banded``
    launch over both bands; overflow fillers stay for the caller."""
    from repro_torch.kernels.encode_search import encode_search_banded
    shard_rows = refs_local.shape[0]
    s_l, l_l = _shard_bands(starts, ends, base, shard_rows)
    idx, vals = encode_search_banded(
        levels, enc.id_hvs, enc.level_hvs, refs_local, s_l, l_l, dim=dim,
        k=k, num_valid=_shard_num_valid(num_rows, base, shard_rows),
        num_tiles=num_tiles, canonicalize=False,
        codebook_words=enc.codebook_words)
    return vals, idx + base


def oms_search_levels(db: ShardedDatabase, enc: QueryEncoder,
                      levels: torch.Tensor, plan: OMSPlan, k: int, *,
                      fused_e2e: bool = False, arena=None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """OMS top-k straight from raw (Q, F) levels, ordered as ``plan``'s
    queries (precursor-sorted): staged (Eq. 1 encode ->
    :func:`oms_search_encoded`) or, with ``fused_e2e``, one
    ``encode_search_banded`` launch per shard. Both end in the shared
    overflow and permutation tail and are bit-identical. ``arena``
    stages the plan's bands without a host synchronization."""
    levels = levels.to(torch.int32).contiguous()
    _check_levels(db, enc, levels)
    if db.oms is None:
        raise ValueError("bank was built without precursor=")
    if not fused_e2e:
        hv = encode_levels_batch(levels, enc.id_hvs, enc.level_hvs)
        return oms_search_encoded(db, encode_queries(db, hv), plan, k,
                                  arena=arena)
    _check_k(db, k)
    starts, ends = _plan_bands(db, plan, arena)
    idx, vals = _over_shards(
        db, k, levels.shape[0], lambda refs_local, base, rows: _local_oms_e2e(
            levels[rows], enc, refs_local, base, k, db.num_rows, db.dim,
            starts[:, rows], ends[:, rows], int(plan.num_tiles)))
    return _oms_finish(db, idx, vals, starts, ends)


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
    valid: np.ndarray | None = None  # (Q,) had >= 1 candidate (OMS)


def fdr_route(db: ShardedDatabase, indices: torch.Tensor,
              scores: torch.Tensor, fdr: float = 0.01,
              valid: torch.Tensor | None = None,
              num_decoys: int | None = None) -> FDRSearchResult:
    """Target-decoy competition on rank 0 + the FDR filter over the batch.

    valid: (Q,) bool for OMS batches; False marks an empty candidate
    window. Such queries are left out of the target/decoy counts, never
    accepted, and reported with ``is_target=False``.
    num_decoys: overrides ``db.num_decoys`` for results in a wider row
    space than ``db``'s."""
    nd = db.num_decoys if num_decoys is None else int(num_decoys)
    top_idx = indices[:, 0]
    top_val = scores[:, 0]
    is_target = top_idx >= nd
    accept = fdr_filter(top_val.to(torch.float32), is_target, fdr=fdr,
                        valid=valid)
    if valid is not None:
        is_target = is_target & valid
    match = torch.where(accept & is_target, top_idx - nd,
                        torch.full_like(top_idx, -1))

    def host(t):
        return t.cpu().numpy()

    return FDRSearchResult(
        indices=host(indices), scores=host(scores),
        is_target=host(is_target), accept=host(accept), match=host(match),
        valid=None if valid is None else host(valid))


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
    has_candidate: bool = True  # precursor window non-empty (OMS mode)


@dataclasses.dataclass
class BatchHandle:
    """One dispatched batch's in-flight device work. ``batch`` is the
    bucket-padded device batch the route searched (encoded rows, or raw
    levels on the fused-e2e route; precursor-sorted in OMS mode, in the
    order of ``plan``); ``raw`` the same batch as raw bipolar int8 rows on
    the merged routes (the delta side's queries). ``start`` and ``done``
    are timing events recorded on the current stream around the batch's
    device work, ``ready`` after the results' copies to the host (None on
    the CPU). OMS batches carry their plan, ``valid`` (has_candidate,
    submit order) and ``inv`` (the permutation that unsorts the results).
    ``db``, ``delta`` and ``num_decoys`` are the bank, delta and decoy
    count the batch was dispatched with: a compaction while it is in
    flight changes none of them."""

    reqs: list[Request]
    tenant: str
    db: ShardedDatabase
    n: int                # real rows (the rest is bucket padding)
    batch: torch.Tensor
    idx: torch.Tensor
    vals: torch.Tensor
    start: torch.cuda.Event | None = None
    done: torch.cuda.Event | None = None
    plan: OMSPlan | None = None
    valid: np.ndarray | None = None
    inv: np.ndarray | None = None
    num_decoys: int | None = None  # merged row space (delta routes)
    delta: object | None = None    # the DeltaBank searched with ``db``
    raw: torch.Tensor | None = None
    ready: torch.cuda.Event | None = None
    host_idx: torch.Tensor | None = None   # (n, k) results on the host
    host_vals: torch.Tensor | None = None
    misses: "_Misses | None" = None
    arena: PinnedArena | None = None


@dataclasses.dataclass
class ClusterBatchHandle:
    """One dispatched clustering batch. ``dists`` is the (bucket, c0)
    device distance matrix against the tenant's snapshot (None when the
    tenant had no cluster yet); ``start`` and ``done`` are timing events
    around its launch, ``ready`` after its copy to the host (None on the
    CPU). The sequential assign-or-spawn decision runs on the host at
    finalize."""

    reqs: list[Request]
    tenant: str
    n: int                       # real rows (the rest is bucket padding)
    hvs: np.ndarray              # (bucket, D) int8 batch
    dists: torch.Tensor | None
    c0: int                      # clusters covered by the snapshot
    struct_version: int          # clusterer structure at dispatch
    start: torch.cuda.Event | None = None
    done: torch.cuda.Event | None = None
    ready: torch.cuda.Event | None = None
    host_dists: torch.Tensor | None = None
    arena: PinnedArena | None = None


@dataclasses.dataclass
class _Misses:
    """A batch's query-HV cache misses, encoded on the device. Their cache
    entries are inserted at dispatch, as the reference inserts them, but
    as ``rows`` not yet filled: the encoded rows ``enc`` are copied to the
    host (``host``) behind the batch's ``ready`` event and written into
    ``rows`` at finalize. Until then a later batch that hits one of these
    keys copies the row from ``enc`` on the device."""

    keys: list[bytes]
    rows: list[np.ndarray]
    enc: torch.Tensor
    host: torch.Tensor | None = None


def _add_device_time(srv: "DBSearchServer", start, done) -> None:
    """Adds the device time between two recorded events (waited for) to
    ``srv.device_busy_s``."""
    if start is not None:
        srv.device_busy_s = ((srv.device_busy_s or 0.0)
                             + start.elapsed_time(done) / 1e3)


def _timing_events(device: torch.device):
    """(start, done) timing events, not yet recorded; (None, None) off the
    card. A dispatch records ``start`` just before its first device
    operation, after the batch's host-side assembly."""
    if device.type != "cuda":
        return None, None
    return tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))


def _record(event: torch.cuda.Event | None) -> None:
    if event is not None:
        event.record()


def _recorded(device: torch.device) -> torch.cuda.Event | None:
    """An event recorded on the current stream (None off the card)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


class SearchExecutor:
    """The device executor behind the dispatch / poll / finalize seam of
    :class:`~repro_torch.serve.scheduler.ContinuousScheduler` (flush-sync
    mode calls dispatch, then finalize). Dispatch never waits for the
    device, so with two scheduler slots one batch's host preparation
    overlaps the other's device search:

    * ``dispatch`` stamps ``t_dispatch``, takes a pinned staging arena
      (:mod:`repro_torch.serve.staging`), assembles the bucket-padded
      batch (through the query-HV cache on the encoded routes: hits copied
      from the host, misses encoded on the device and scattered into the
      device batch), in OMS mode sorts it by precursor and plans it,
      copies it to the bank's device with ``non_blocking=True``, launches
      the search (merged with the tenant's delta bank when it has one),
      and starts copying the results back into the arena;
    * ``poll`` asks the batch's ``ready`` event whether it all finished;
    * ``finalize`` waits for that event, inserts the encoded misses into
      the cache, unsorts OMS batches, routes FDR, fills per-request
      results, stamps ``t_done``, records latency, adds the batch's device
      time (start to done event) to ``server.device_busy_s`` and hands the
      arena back.

    Everything runs on the current stream, so stream order alone keeps a
    batch's copies, encodes and search in sequence and the caching
    allocator's reuse safe.

    Clustering batches (``kind == "cluster"``) launch the tenant's
    snapshot distances at dispatch, timed and copied back the same way,
    and run the assign-or-spawn loop at finalize.

    Pass a subclass as ``DBSearchServer(executor_cls=...)`` to observe or
    replace batches.
    """

    def __init__(self, server: "DBSearchServer"):
        self.server = server
        self.staging = StagingPool()

    def dispatch(self, reqs: list[Request]) -> BatchHandle | ClusterBatchHandle:
        srv = self.server
        t = srv._clock()
        for r in reqs:
            r.t_dispatch = t
        tenant = reqs[0].tenant
        if reqs[0].kind == "cluster":
            return self._dispatch_cluster(reqs, tenant)
        db, delta = srv.banks.get_with_delta(tenant)  # lazy build on first use
        n = len(reqs)
        bucket = bucket_for(n, srv.buckets)
        srv._bucket_counts[bucket] += 1
        dev = db.data.device
        arena = self.staging.acquire(dev)
        start, done = _timing_events(dev)
        if srv.oms is not None:
            h = self._dispatch_oms(reqs, db, delta, n, bucket, tenant, arena,
                                   start)
        elif delta is not None:
            # merged base + delta search (bit-identical to a rebuilt
            # bank). The fused-e2e route has no encoded intermediate to
            # hand the delta, so delta batches take the staged encode,
            # bit-identical to the fused one.
            from repro_torch.serve.delta import merged_search_encoded
            batch, misses = srv._encode_batch(reqs, db, bucket, tenant, arena,
                                              start=start)
            raw = srv._raw_batch(reqs, bucket, arena)
            idx, vals = merged_search_encoded(db, delta, batch, raw, srv.k)
            h = BatchHandle(reqs=reqs, tenant=tenant, db=db, n=n,
                            batch=batch, idx=idx, vals=vals, misses=misses,
                            num_decoys=db.num_decoys + delta.num_decoys,
                            delta=delta, raw=raw)
        elif srv.encoder is not None and srv.fused_e2e:
            levels = srv._levels_batch(reqs, bucket)
            _record(start)
            batch = arena.upload("levels", levels)
            idx, vals = search_database_levels(db, srv.encoder, batch, srv.k,
                                               fused_e2e=True)
            h = BatchHandle(reqs=reqs, tenant=tenant, db=db, n=n,
                            batch=batch, idx=idx, vals=vals)
        else:
            batch, misses = srv._encode_batch(reqs, db, bucket, tenant, arena,
                                              start=start)
            idx, vals = search_database_encoded(db, batch, srv.k)
            h = BatchHandle(reqs=reqs, tenant=tenant, db=db, n=n,
                            batch=batch, idx=idx, vals=vals, misses=misses)
        h.start, h.done, h.arena = start, done, arena
        if done is not None:
            done.record()
        h.host_idx = arena.download("idx", h.idx[:n])
        h.host_vals = arena.download("vals", h.vals[:n])
        if h.misses is not None:
            h.misses.host = arena.download("misses", h.misses.enc)
        h.ready = _recorded(dev)
        return h

    def _dispatch_oms(self, reqs: list[Request], db: ShardedDatabase, delta,
                      n: int, bucket: int, tenant: str, arena: PinnedArena,
                      start: torch.cuda.Event | None = None) -> BatchHandle:
        """OMS dispatch: precursor-sort the batch (neighbouring masses
        share the banded kernels' tiles; pad rows take the highest real
        precursor), plan it on the host, launch the banded search. Results
        unsort at finalize; FDR routing is order-independent. With a
        non-empty delta the plan and search run merged over base + delta
        (:mod:`repro_torch.serve.delta`); fused-e2e servers take the
        staged encode for those batches, which is bit-identical."""
        srv = self.server
        prec = np.asarray([r.precursor for r in reqs], np.float32)
        order = np.argsort(prec, kind="stable")
        inv = np.argsort(order, kind="stable")
        prec_padded = np.concatenate(
            [prec[order], np.full(bucket - n, prec[order][-1], np.float32)])
        raw = misses = num_decoys = None
        if delta is not None:
            from repro_torch.serve.delta import (
                merged_oms_plan,
                merged_oms_search_encoded,
            )
            plan = merged_oms_plan(db, delta, prec_padded, srv.oms)
            batch, misses = srv._encode_batch(reqs, db, bucket, tenant, arena,
                                              rows=inv, start=start)
            raw = srv._raw_batch(reqs, bucket, arena, rows=inv)
            idx, vals = merged_oms_search_encoded(db, delta, batch, raw, plan,
                                                  srv.k, arena=arena)
            num_decoys = db.num_decoys + delta.num_decoys
        elif srv.encoder is not None and srv.fused_e2e:
            plan = oms_plan(db, prec_padded, srv.oms)
            levels = srv._levels_batch(reqs, bucket, rows=inv)
            _record(start)
            batch = arena.upload("levels", levels)
            idx, vals = oms_search_levels(db, srv.encoder, batch, plan, srv.k,
                                          fused_e2e=True, arena=arena)
        else:
            plan = oms_plan(db, prec_padded, srv.oms)
            batch, misses = srv._encode_batch(reqs, db, bucket, tenant, arena,
                                              rows=inv, start=start)
            idx, vals = oms_search_encoded(db, batch, plan, srv.k,
                                           arena=arena)
        valid = plan.has_candidate[:n][inv]
        srv._oms_batches += 1
        srv._oms_cand_frac += plan.candidate_fraction
        srv._oms_scan_frac += plan.scanned_fraction
        srv._oms_no_candidate += int((~valid).sum())
        return BatchHandle(reqs=reqs, tenant=tenant, db=db, n=n, batch=batch,
                           idx=idx, vals=vals, plan=plan, valid=valid,
                           inv=inv, num_decoys=num_decoys, delta=delta,
                           raw=raw, misses=misses)

    def _dispatch_cluster(self, reqs: list[Request], tenant: str
                          ) -> ClusterBatchHandle:
        """Clustering dispatch: launch the batch-vs-centroids distances
        against the tenant's current snapshot; the assign-or-spawn loop
        runs at finalize."""
        srv = self.server
        cl = srv.clusterers.get(tenant)
        if cl is None:
            cl = srv.clusterers[tenant] = StreamingClusterer(
                srv.clustering, srv.cluster_device)
        n = len(reqs)
        bucket = bucket_for(n, srv.buckets)
        srv._bucket_counts[bucket] += 1
        hvs = np.zeros((bucket, srv.clustering.dim), np.int8)
        for i, r in enumerate(reqs):
            hvs[i] = r.query
        arena = self.staging.acquire(cl.device)
        start, done = (_timing_events(cl.device) if cl.num_clusters
                       else (None, None))
        _record(start)
        c0, version = cl.num_clusters, cl.struct_version
        dists = cl.snapshot_distances(hvs, arena=arena)
        if done is not None:
            done.record()
        host = None if dists is None else arena.download("dists", dists[:n])
        return ClusterBatchHandle(reqs=reqs, tenant=tenant, n=n, hvs=hvs,
                                  dists=dists, c0=c0, struct_version=version,
                                  start=start, done=done,
                                  ready=_recorded(cl.device), host_dists=host,
                                  arena=arena)

    def poll(self, handle: BatchHandle | ClusterBatchHandle) -> bool:
        return True if handle.ready is None else handle.ready.query()

    def _wait(self, handle: BatchHandle | ClusterBatchHandle) -> None:
        """Waits for the handle's copies to the host (its ``ready``
        event) and adds its device time."""
        if handle.ready is not None:
            handle.ready.synchronize()
        _add_device_time(self.server, handle.start, handle.done)

    def _finalize_cluster(self, handle: ClusterBatchHandle) -> list[Request]:
        srv = self.server
        cl = srv.clusterers[handle.tenant]
        self._wait(handle)
        dists = (None if handle.host_dists is None
                 else handle.host_dists.numpy().copy())
        if handle.arena is not None:
            self.staging.release(handle.arena)
        assigns = cl.assign_batch(handle.hvs[:handle.n], dists, handle.c0,
                                  handle.struct_version)
        t_done = srv._clock()
        live: list[Request] = []
        for r, a in zip(handle.reqs, assigns):
            if r.cancelled:
                # the spectrum still entered the cluster state; only the
                # response is dropped
                continue
            r.result = a
            r.t_done = t_done
            live.append(r)
        srv._cluster_requests += len(live)
        if live:
            srv.stats.record_batch(live)
            srv.tenant_stats.setdefault(
                handle.tenant, LatencyStats()).record_batch(live)
        return live

    def finalize(self, handle: BatchHandle | ClusterBatchHandle
                 ) -> list[Request]:
        if isinstance(handle, ClusterBatchHandle):
            return self._finalize_cluster(handle)
        srv = self.server
        self._wait(handle)
        idx = handle.host_idx.clone()
        vals = handle.host_vals.clone()
        if handle.misses is not None:
            srv._fill_misses(handle.misses)
        if handle.arena is not None:
            self.staging.release(handle.arena)
        valid = None
        if handle.inv is not None:
            inv = torch.from_numpy(handle.inv)
            idx, vals = idx[inv], vals[inv]
            valid = torch.from_numpy(handle.valid)
        routed = fdr_route(handle.db, idx, vals, fdr=srv.fdr, valid=valid,
                           num_decoys=handle.num_decoys)
        t_done = srv._clock()
        live: list[Request] = []
        for i, r in enumerate(handle.reqs):
            if r.cancelled:
                continue
            r.result = QueryResult(
                indices=routed.indices[i], scores=routed.scores[i],
                is_target=bool(routed.is_target[i]),
                accept=bool(routed.accept[i]), match=int(routed.match[i]),
                has_candidate=(True if routed.valid is None
                               else bool(routed.valid[i])))
            r.t_done = t_done
            live.append(r)
        if live:
            srv.stats.record_batch(live)
            srv.tenant_stats.setdefault(
                handle.tenant, LatencyStats()).record_batch(live)
        return live


_NUMPY_DTYPE = {torch.int32: np.int32, torch.int8: np.int8}


def _ranks(mesh) -> int:
    """Ranks of a ``DeviceMesh`` (1 for no mesh or a mapping)."""
    if mesh is None or isinstance(mesh, Mapping):
        return 1
    return int(mesh.mesh.numel())


def _spans_group(mesh) -> None:
    """Raises unless ``mesh`` spans the whole default group (the serving
    loop's collectives run over it)."""
    import torch.distributed as dist
    if _ranks(mesh) != dist.get_world_size():
        raise ValueError(f"the mesh spans {_ranks(mesh)} of "
                         f"{dist.get_world_size()} ranks; serving over it "
                         f"needs all of them")


def _any_rank(mesh, flag: bool) -> bool:
    """True on every rank when ``flag`` is True on any rank of ``mesh``
    (one all-reduce over the default group, which the mesh must span)."""
    import torch.distributed as dist
    _spans_group(mesh)
    t = torch.tensor([int(flag)], dtype=torch.int32,
                     device=_mesh_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _gather_rows(mesh, row: torch.Tensor) -> torch.Tensor:
    """Every rank's ``row`` stacked in rank order, on the host: one
    all-gather over the default group, which the mesh must span (on the
    host under gloo, on the mesh's device otherwise). The continuous
    scheduler's plan exchange."""
    import torch.distributed as dist
    _spans_group(mesh)
    dev = (torch.device("cpu") if dist.get_backend() == "gloo"
           else _mesh_device(mesh))
    row = row.to(dev)
    rows = [torch.empty_like(row) for _ in range(dist.get_world_size())]
    dist.all_gather(rows, row)
    return torch.stack(rows).cpu()


class DBSearchServer:
    """Micro-batched, multi-tenant DB-search server.

    Requests carry encoded bipolar query HVs (D,), or raw quantized level
    vectors (F,) when the server holds a :class:`QueryEncoder`, plus a
    tenant name; each tenant searches its own bank. Per batch, query rows
    are encoded through the content-hash :class:`QueryHVCache` (misses
    encoded once, as a batch, on the device), the batch is padded to the
    nearest bucket (pad rows are sliced off before FDR), searched, routed
    through per-batch FDR, and timed into the aggregate and per-tenant
    :class:`LatencyStats`. With ``fused_e2e=True`` the levels go to the
    fused encode->search kernel and skip the cache (nothing intermediate
    exists to memoize).

    **Queue modes.** Flush-sync (default): ``step`` runs one micro-batch,
    dispatch then finalize, when the queue's flush policy fires.
    Continuous (``continuous=True``): a
    :class:`~repro_torch.serve.scheduler.ContinuousScheduler` keeps
    ``num_slots`` batches in flight, retiring completed slots and
    admitting queued requests into freed slots every ``step``
    (``flush_timeout_s`` is inert in this mode). Both modes run the
    identical :class:`SearchExecutor` device path, so results are
    bit-identical across modes.

    With ``oms=`` (an :class:`OMSConfig`; banks built with
    ``precursor=``) every request carries its precursor mass, and each
    batch is sorted by it, planned, and searched on the OMS routes; a
    query with an empty window comes back rejected with
    ``has_candidate=False``.

    **Live banks.** ``append`` streams new refs/decoys into a tenant's
    bank through the registry's delta path (:mod:`repro_torch.serve.delta`):
    searches stay exact and bit-identical to a rebuilt bank. With
    ``compact_threshold=``, ``step`` folds deltas past that fraction of
    the tenant's rows back into the packed base between batches.

    With ``clustering=`` (a :class:`ClusteringConfig`), ``submit_cluster``
    enqueues spectra for per-tenant streaming assign-or-spawn clustering,
    a second request kind sharing the queue, fairness policy, buckets and
    (continuous mode) scheduler slots with search; its results are
    :class:`ClusterAssignment` objects and its centroid snapshots live on
    ``cluster_device``. Clustering tenants need no bank: a server over an
    empty :class:`BankRegistry` serves clustering alone.

    **Over a mesh.** With banks sharded over a multi-rank mesh
    (``BankRegistry(mesh=)``), every rank runs the same server on the same
    submissions (and cancels); the ranks dispatch the same batches and
    meet in the routes' collectives. Flush-sync ``step`` agrees each flush
    across the ranks (one all-reduce); continuous mode runs a
    :class:`~repro_torch.serve.scheduler.CoordinatedScheduler`: rank 0
    decides which slots retire, and that plan and every rank's next
    batches are agreed in one all-gather a step. A rank whose queue
    differs (a request submitted or cancelled there alone) raises
    ``RuntimeError`` on every rank before anything is dispatched.
    Compaction is decided alike on every rank (by the delta fraction,
    which the same appends make equal). Clustering batches ride the same
    plan (their state is each rank's own; nothing of theirs is sharded).

    ``executor_cls`` is the :class:`SearchExecutor` subclass built on this
    server (to observe or replace batches).
    """

    def __init__(self, db: ShardedDatabase | BankRegistry, *, k: int = 4,
                 fdr: float = 0.01, max_batch_size: int = 32,
                 flush_timeout_s: float = 0.01,
                 clock: Callable[[], float] = time.monotonic,
                 cache_bytes: int | None = 64 << 20,
                 buckets: int | Sequence[int] | None = None,
                 fairness_cap: int | None = None,
                 oms: OMSConfig | None = None,
                 encoder: QueryEncoder | None = None,
                 fused_e2e: bool = False,
                 continuous: bool = False, num_slots: int = 2,
                 executor_cls: type[SearchExecutor] = SearchExecutor,
                 compact_threshold: float | None = None,
                 clustering: ClusteringConfig | None = None,
                 cluster_device: str | torch.device = "cuda"):
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
        # cache key -> (its entry's row, not yet filled; the device rows
        # being encoded; the row's index there), for batches in flight
        self._pending: dict[bytes, tuple[np.ndarray, torch.Tensor, int]] = {}
        self.stats = LatencyStats()
        self.tenant_stats: dict[str, LatencyStats] = {}
        self._tenant_cache: dict[str, list[int]] = {}  # tenant -> [hits, misses]
        self._bucket_counts: collections.Counter[int] = collections.Counter()
        self._clock = clock
        self.oms = oms
        self._oms_batches = 0
        self._oms_cand_frac = 0.0
        self._oms_scan_frac = 0.0
        self._oms_no_candidate = 0
        self.encoder = encoder
        self.fused_e2e = bool(fused_e2e)
        if self.fused_e2e and encoder is None:
            raise ValueError("fused_e2e=True requires encoder=")
        if compact_threshold is not None and not 0 < compact_threshold <= 1:
            raise ValueError(f"compact_threshold must be in (0, 1], got "
                             f"{compact_threshold}")
        self.compact_threshold = compact_threshold
        self.clustering = clustering
        self.cluster_device = (None if clustering is None
                               else resolve_device(cluster_device))
        self.clusterers: dict[str, StreamingClusterer] = {}
        self._cluster_requests = 0
        # the mesh the banks are sharded over: its ranks must take the
        # same batches, so flushes (or continuous steps) are agreed
        # across them
        self.mesh = self.banks.mesh if self.db is None else self.db.mesh
        self.executor = executor_cls(self)
        self.scheduler = None
        if continuous and _ranks(self.mesh) > 1:
            import torch.distributed as dist
            self.scheduler = CoordinatedScheduler(
                self.queue, self.executor, num_slots=num_slots, clock=clock,
                exchange=functools.partial(_gather_rows, self.mesh),
                rank=dist.get_rank())
        elif continuous:
            self.scheduler = ContinuousScheduler(
                self.queue, self.executor, num_slots=num_slots, clock=clock)
        # seconds the device spent on served batches' searches and
        # clustering distances (None until a batch ran on a CUDA device)
        self.device_busy_s: float | None = None

    def submit(self, query_hv, tenant: str = "default",
               precursor: float | None = None) -> int:
        """Enqueue one query for ``tenant`` (which must be registered);
        returns the request id. OMS servers need the query's precursor
        mass."""
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
        if self.oms is not None and precursor is None:
            raise ValueError("OMS serving mode requires precursor= on submit")
        return self.queue.submit(q, tenant=tenant, precursor=precursor)

    def submit_cluster(self, query_hv, tenant: str = "default") -> int:
        """Enqueue one spectrum HV (D,) for the clustering endpoint (the
        server must hold a ``clustering=`` config). Clustering tenants are
        independent of bank tenants; state is created on first use. The
        result is a :class:`ClusterAssignment`."""
        if self.clustering is None:
            raise ValueError("server was built without clustering=; pass a "
                             "ClusteringConfig to serve the clustering "
                             "endpoint")
        q = np.asarray(query_hv, dtype=np.int8)
        if q.shape != (self.clustering.dim,):
            raise ValueError(
                f"query shape {q.shape} != ({self.clustering.dim},)")
        return self.queue.submit(q, tenant=tenant, kind="cluster")

    def append(self, tenant: str, refs, decoys=None, *, precursor=None,
               decoy_precursor=None) -> int:
        """Stream new refs/decoys into a tenant's bank (delegates to
        :meth:`~repro_torch.serve.cache.BankRegistry.append`); later
        searches take the exact merged base + delta path until compaction
        folds the delta in."""
        return self.banks.append(tenant, refs, decoys, precursor=precursor,
                                 decoy_precursor=decoy_precursor)

    def cancel(self, rid: int) -> bool:
        """Best-effort cancel: un-queue a pending request, or (continuous
        mode) drop an in-flight one's result at retire time."""
        if self.scheduler is not None:
            return self.scheduler.cancel(rid)
        return self.queue.cancel(rid)

    def _encode_rows(self, db: ShardedDatabase, qs: torch.Tensor,
                     host: np.ndarray) -> torch.Tensor:
        """Stacked raw queries (``host`` and its device copy ``qs``) -> the
        bank's storage form (the staged Eq. 1 encode first when the server
        holds an encoder)."""
        if self.encoder is not None:
            return encode_queries(db, self._encode_levels(qs, host))
        return encode_queries(db, qs)

    def _encode_levels(self, levels: torch.Tensor, host: np.ndarray
                       ) -> torch.Tensor:
        """The staged Eq. 1 encode of device levels, its width read from
        their host copy (so nothing is read back from the device)."""
        width = int((host > 0).sum(axis=1).max()) if host.size else 1
        return encode_levels_batch(levels.to(torch.int32),
                                   self.encoder.id_hvs,
                                   self.encoder.level_hvs, width=width)

    def _levels_batch(self, reqs: list[Request], bucket: int,
                      rows: np.ndarray | None = None) -> np.ndarray:
        """The raw (bucket, F) level batch; request i at row ``rows[i]``
        (default i). Pad rows are all-zero (every peak absent), inert
        under Eq. 1."""
        out = np.zeros((bucket, self.encoder.num_features), np.int32)
        for i, r in enumerate(reqs):
            out[i if rows is None else rows[i]] = r.query
        return out

    def _raw_batch(self, reqs: list[Request], bucket: int,
                   arena: PinnedArena, rows: np.ndarray | None = None
                   ) -> torch.Tensor:
        """The (bucket, D) raw bipolar int8 batch on the device: the query
        form the *unpacked* delta side of a merged search scores against;
        request i at row ``rows[i]``. Encoder servers run the staged
        Eq. 1 encode on the device, so these are exactly the HVs the base
        side packs (the reference's round trip through the host gives the
        same bytes)."""
        if self.encoder is not None:
            levels = self._levels_batch(reqs, bucket, rows)
            return self._encode_levels(arena.upload("raw_levels", levels),
                                       levels)
        out = np.zeros((bucket, len(reqs[0].query)), np.int8)
        for i, r in enumerate(reqs):
            out[i if rows is None else rows[i]] = r.query
        return arena.upload("raw", out)

    def _encode_batch(self, reqs: list[Request], db: ShardedDatabase,
                      bucket: int, tenant: str, arena: PinnedArena,
                      rows: np.ndarray | None = None,
                      start: torch.cuda.Event | None = None
                      ) -> tuple[torch.Tensor, _Misses | None]:
        """The (bucket, width) encoded batch on the bank's device, request
        i at row ``rows[i]`` (default i), through the cache: hits are
        copied from the host (or, while the batch that encoded them is in
        flight, from its device rows), misses encoded once, as a batch, on
        the device and scattered into place. Lookups and insertions are
        the reference's, in its order. ``start`` is recorded between the
        host-side lookups and the first device operation. Returns (batch,
        the misses whose cache entries finalize fills, or None)."""
        width = db.data.shape[-1]
        dtype = _NUMPY_DTYPE[db.data.dtype]
        out = np.zeros((bucket, width), dtype=dtype)
        cache = self.query_cache
        pos = np.arange(len(reqs)) if rows is None else np.asarray(rows)
        miss, miss_keys, in_flight = list(range(len(reqs))), None, []
        if cache is not None:
            variant = (f"{'e2e:' if self.encoder is not None else ''}"
                       f"{'packed' if db.packed else 'int8'}:{db.dim}")
            miss, miss_keys = [], []
            for i, r in enumerate(reqs):
                key = cache.content_key(r.query, variant=variant)
                row = cache.lookup(key)
                if row is None:
                    miss.append(i)
                    miss_keys.append(key)
                    continue
                pending = self._pending.get(key)
                if pending is not None and pending[0] is row:
                    in_flight.append((int(pos[i]), pending[1], pending[2]))
                else:
                    out[pos[i]] = row
            tc = self._tenant_cache.setdefault(tenant, [0, 0])
            tc[0] += len(reqs) - len(miss)
            tc[1] += len(miss)
        _record(start)
        batch = arena.upload("batch", out)
        for p, enc, j in in_flight:
            batch[p].copy_(enc[j])
        if not miss:
            return batch, None
        host = np.stack([reqs[i].query for i in miss])
        enc = self._encode_rows(db, arena.upload("queries", host), host)
        batch.index_copy_(0, arena.upload(
            "miss_rows", pos[miss].astype(np.int64)), enc)
        if miss_keys is None:
            return batch, None
        entries = []
        for j, key in enumerate(miss_keys):
            entry = np.zeros(width, dtype)
            cache.insert(key, entry)
            self._pending[key] = (entry, enc, j)
            entries.append(entry)
        return batch, _Misses(keys=miss_keys, rows=entries, enc=enc)

    def _fill_misses(self, misses: _Misses) -> None:
        """Writes a finalized batch's encoded misses into their cache
        entries (whether or not still cached) and ends their pending
        state."""
        host = misses.host.numpy()
        for j, (key, entry) in enumerate(zip(misses.keys, misses.rows)):
            entry[...] = host[j]
            pending = self._pending.get(key)
            if pending is not None and pending[0] is entry:
                del self._pending[key]

    def step(self, force: bool = False) -> list[Request]:
        """One serving-loop iteration; returns the requests completed this
        step (``result``/``t_done`` filled), [] when nothing finished.

        Flush-sync mode runs at most one micro-batch, dispatch then
        finalize, when the queue policy says so, or whenever requests are
        pending with ``force`` (used to drain). Continuous mode retires
        completed slots and refills them from the queue without blocking
        (``force`` waits out the in-flight slots instead). Either way, due
        compactions run first: compaction happens between batches, never
        under one, so no queued request is dropped (slots already in
        flight keep their pre-compaction bank and delta, whose merged
        results are bit-identical anyway).

        Over a multi-rank mesh every rank must call ``step`` alike, with
        the same requests submitted (and cancelled) in the same order.
        Flush-sync agrees whether to flush across the ranks (any rank's
        flush policy firing flushes all), so they take the same batch.
        Continuous mode agrees each step's plan: the slots rank 0 found
        done retire on every rank and rank 0's next batches are admitted
        everywhere, each rank checking them against its own queue rid for
        rid (a difference raises ``RuntimeError`` on every rank, nothing
        dispatched). Compactions are alike on every rank: they follow the
        delta fraction, which the same appends make equal."""
        self._maybe_compact()
        if self.scheduler is not None:
            return self.scheduler.step(block=force)
        flush = self.queue.ready() or (force and len(self.queue) > 0)
        if _ranks(self.mesh) > 1:
            flush = _any_rank(self.mesh, flush)
        if not flush:
            return []
        reqs = self.queue.take_batch()
        if not reqs:
            return []
        return self.executor.finalize(self.executor.dispatch(reqs))

    def _maybe_compact(self) -> int:
        """Fold every delta past ``compact_threshold`` (delta fraction)
        into its base bank; returns the number of tenants compacted."""
        if self.compact_threshold is None:
            return 0
        done = 0
        for t in self.banks.tenants_with_delta():
            if self.banks.delta_fraction(t) >= self.compact_threshold:
                if self.banks.compact(t):
                    done += 1
        return done

    def run_until_drained(self) -> list[Request]:
        """Serve until queue and in-flight slots are empty; returns all
        completed requests."""
        if self.scheduler is not None:
            return self.scheduler.drain()
        done: list[Request] = []
        while len(self.queue):
            done.extend(self.step(force=True))
        return done

    def summary(self) -> dict:
        """Aggregate latency stats plus per-tenant accounting, query-cache
        and bank-registry counters, bucket usage, the queue mode and its
        scheduler, and ingestion counters."""
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
        s["mode"] = "continuous" if self.scheduler is not None else "flush-sync"
        s["scheduler"] = (None if self.scheduler is None
                          else self.scheduler.summary())
        s["ingest"] = {
            "compact_threshold": self.compact_threshold,
            "appends": self.banks.appends,
            "compactions": self.banks.compactions,
            "tenants_with_delta": self.banks.tenants_with_delta(),
        }
        s["device_busy_s"] = self.device_busy_s
        s["clustering"] = (None if self.clustering is None else {
            "requests": self._cluster_requests,
            "tenants": {t: c.summary() for t, c in self.clusterers.items()},
        })
        s["e2e"] = (None if self.encoder is None else {
            "fused": self.fused_e2e,
            "num_features": self.encoder.num_features,
            "num_levels": self.encoder.num_levels,
        })
        s["oms"] = None
        if self.oms is not None:
            nb = max(self._oms_batches, 1)
            s["oms"] = {
                "tol": self.oms.tol,
                "open_tol": self.oms.open_tol,
                "open_search": self.oms.open_search,
                "batches": self._oms_batches,
                "candidate_fraction": self._oms_cand_frac / nb,
                "scanned_fraction": self._oms_scan_frac / nb,
                "no_candidate": self._oms_no_candidate,
            }
        return s

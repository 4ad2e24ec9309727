"""Streaming spectral clustering as a serving endpoint (SpecPCM §III.C),
in PyTorch.

Counterpart of ``repro.serve.clustering``: per-tenant assign-or-spawn
state behind :class:`~repro_torch.serve.db_search.DBSearchServer`'s
queue, with a query batch against the centroid bank on the device (the
``hamming_pop`` kernel when the centroids are bit-packed) and the
sequential decision loop on the host:

  * **assign-or-spawn**: each spectrum HV joins the nearest cluster
    within ``threshold`` (ties to the lowest-numbered cluster), else
    spawns a new one. Centroids are bipolar majority bundles: the running
    element sum with a sign readout (0 -> +1).
  * **periodic re-consolidation**: every ``consolidate_every`` spectra
    the centroid bank itself is re-clustered with
    :func:`~repro_torch.core.hd.clustering.complete_linkage`; merged
    clusters fold their accumulators together, and old ids stay
    resolvable through :meth:`StreamingClusterer.resolve`.

Batching semantics are the reference's: distances are computed against
the snapshot taken at dispatch; within a batch the host loop is
sequential, so a spectrum that spawns a cluster is assignable to the
rest of its batch (exact host-side distances, the same (D - <q, c>)/2
map). A consolidation between dispatch and finalize is detected through
``struct_version`` and the batch is then scored on the host.

Host state grows by doubling capacity, not by a copy per spawn. The
device keeps a resident (packed) centroid bank in which only the rows a
batch changed or spawned are rewritten at the next dispatch (the whole
bank after a consolidation), so the snapshot equals the sign of the live
accumulators, as the reference's rebuilt snapshot does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.hd.clustering import (
    complete_linkage,
    cross_distances,
    pairwise_distances,
)
from repro_torch.core.hd.similarity import bitpack_bipolar
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    """Per-server clustering policy.

    threshold: assign a spectrum to its nearest centroid when the Hamming
      distance is <= this, else spawn a new cluster.
    link_threshold: complete-linkage threshold for periodic consolidation
      (defaults to ``threshold``).
    consolidate_every: re-consolidate after this many assigned spectra
      per tenant; 0 disables (pure greedy streaming).
    pack: bit-pack centroids for the ``hamming_pop`` distance kernel:
      True / False / "auto" (pack when D % 32 == 0).
    """

    dim: int
    threshold: float
    link_threshold: float | None = None
    consolidate_every: int = 0
    pack: bool | str = "auto"

    @property
    def packed(self) -> bool:
        if self.pack == "auto":
            return self.dim % 32 == 0
        return bool(self.pack)

    @property
    def merge_threshold(self) -> float:
        return (self.threshold if self.link_threshold is None
                else self.link_threshold)


@dataclasses.dataclass
class ClusterAssignment:
    """Per-request clustering result (the endpoint's ``QueryResult``)."""

    cluster_id: int    # public id (stable across consolidations via resolve)
    spawned: bool      # this spectrum started a new cluster
    distance: float    # Hamming distance to the assigned centroid
                       # (0.0 for a spawn: a cluster's founder is its centroid)


class StreamingClusterer:
    """Online assign-or-spawn cluster state for one tenant.

    Host state is the integer accumulator (sum of member bipolar HVs) per
    cluster plus its sign snapshot; ``device`` holds the (packed) copy the
    distance step reads. Public cluster ids are allocated in spawn order
    and survive consolidation through a remap chain. ``hamming`` is the
    packed similarity function of the distance step (None: the
    ``hamming_pop`` kernel; a check passes its plain version). The host
    decision loop's and the consolidations' seconds accumulate in
    ``decide_s`` and ``consolidate_s``.
    """

    def __init__(self, cfg: ClusteringConfig,
                 device: str | torch.device = "cuda",
                 hamming: Callable | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.hamming = hamming
        self._n = 0                                   # live rows
        self._acc_buf = np.zeros((0, cfg.dim), np.int32)
        self._counts_buf = np.zeros((0,), np.int64)
        self._cent_buf = np.zeros((0, cfg.dim), np.int8)  # sign(acc), 0 -> +1
        self._ids: list[int] = []                     # public id per row
        self._next_id = 0
        self._remap: dict[int, int] = {}              # merged-away -> target
        self._bank: torch.Tensor | None = None        # device rows (capacity)
        self._dirty: set[int] = set()                 # rows stale on device
        self._since_consol = 0
        self.struct_version = 0   # bumped when consolidation moves rows
        self.assigned = 0
        self.spawned = 0
        self.consolidations = 0
        self.merges = 0
        self.decide_s = 0.0
        self.consolidate_s = 0.0

    @property
    def num_clusters(self) -> int:
        return self._n

    @property
    def _acc(self) -> np.ndarray:
        return self._acc_buf[:self._n]

    @property
    def _cent(self) -> np.ndarray:
        return self._cent_buf[:self._n]

    def _grow(self, rows: int) -> None:
        """Host capacity for ``rows`` live rows, doubling."""
        cap = self._acc_buf.shape[0]
        if rows <= cap:
            return
        cap = max(8, cap)
        while cap < rows:
            cap *= 2
        for name in ("_acc_buf", "_counts_buf", "_cent_buf"):
            old = getattr(self, name)
            new = np.zeros((cap, *old.shape[1:]), old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)

    # -- device side (called at dispatch) ---------------------------------

    def _to_device(self, hvs: np.ndarray, arena=None, name: str = ""
                   ) -> torch.Tensor:
        """Int8 HV rows on the device, packed when the bank is: through
        the pinned buffer ``name`` of ``arena`` (a
        :class:`~repro_torch.serve.staging.PinnedArena`; no host
        synchronization) when one is given."""
        hvs = np.ascontiguousarray(hvs, np.int8)
        t = (arena.upload(name, hvs) if arena is not None
             else torch.from_numpy(hvs).to(self.device))
        return bitpack_bipolar(t) if self.cfg.packed else t

    def device_bank(self, arena=None) -> torch.Tensor:
        """The live centroid rows on the device, (C, W) packed words or
        (C, D) int8, after rewriting the rows changed since the last
        call (staged through ``arena`` when one is given)."""
        c = self._n
        cap = self._acc_buf.shape[0]
        if self._bank is None or self._bank.shape[0] < cap:
            width = self.cfg.dim // 32 if self.cfg.packed else self.cfg.dim
            bank = torch.empty((cap, width), device=self.device,
                               dtype=torch.int32 if self.cfg.packed
                               else torch.int8)
            if self._bank is not None:
                bank[:self._bank.shape[0]] = self._bank
            self._bank = bank
        if self._dirty:
            rows = np.fromiter(sorted(self._dirty), np.int64,
                               len(self._dirty))
            at = (arena.upload("bank_rows", rows) if arena is not None
                  else torch.from_numpy(rows).to(self.device))
            self._bank[at] = self._to_device(self._cent_buf[rows], arena,
                                             "bank_hvs")
            self._dirty.clear()
        return self._bank[:c]

    def snapshot_distances(self, hvs: np.ndarray, arena=None
                           ) -> torch.Tensor | None:
        """Launch (Q, C) Hamming distances of a bucket-padded int8 batch
        against the current centroid snapshot; None when no clusters
        exist yet (the whole batch spawns). The result is left on the
        device, unsynchronised; with ``arena`` the batch and the changed
        centroid rows reach the device without a host synchronization."""
        if self._n == 0:
            return None
        bank = self.device_bank(arena)
        return cross_distances(self._to_device(hvs, arena, "hvs"), bank,
                               dim=self.cfg.dim, hamming=self.hamming)

    # -- host side (called at finalize) -----------------------------------

    def assign_batch(self, hvs: np.ndarray, dists: np.ndarray | None,
                     c0: int, struct_version: int | None = None
                     ) -> list[ClusterAssignment]:
        """Sequentially assign-or-spawn one batch.

        dists: realized (Q, >=c0) snapshot distances (None when c0 == 0);
        c0 is the cluster count the snapshot covered at dispatch. Rows
        spawned after the snapshot are scored host-side with the identical
        distance map, ties keeping the lower row. If a consolidation
        restructured the rows since dispatch (``struct_version``), the
        whole batch is scored host-side.
        """
        t0 = time.perf_counter()
        if (struct_version is not None
                and struct_version != self.struct_version):
            dists, c0 = None, 0
        out: list[ClusterAssignment] = []
        touched: set[int] = set()
        dim = self.cfg.dim
        for i in range(hvs.shape[0]):
            hv = hvs[i]
            best_row, best_d = -1, np.inf
            c_snap = min(c0, self._n)
            if dists is not None and c_snap:
                row = int(np.argmin(dists[i, :c_snap]))  # ties -> lowest row
                best_row, best_d = row, float(dists[i, row])
            if c_snap < self._n:
                dots = (self._cent_buf[c_snap:self._n].astype(np.int32)
                        @ hv.astype(np.int32))
                host_d = (dim - dots) / 2.0
                row = int(np.argmin(host_d))  # ties -> lowest row
                if host_d[row] < best_d:      # strict: ties keep the lower row
                    best_row, best_d = c_snap + row, float(host_d[row])
            if best_row >= 0 and best_d <= self.cfg.threshold:
                self._acc_buf[best_row] += hv.astype(np.int32)
                self._counts_buf[best_row] += 1
                touched.add(best_row)
                out.append(ClusterAssignment(
                    cluster_id=self._ids[best_row], spawned=False,
                    distance=best_d))
            else:
                cid = self._spawn(hv)
                out.append(ClusterAssignment(
                    cluster_id=cid, spawned=True, distance=0.0))
        for row in touched:
            self._refresh_row(row)
        self.assigned += hvs.shape[0]
        self._since_consol += hvs.shape[0]
        self.decide_s += time.perf_counter() - t0
        self.maybe_consolidate()
        return out

    def _spawn(self, hv: np.ndarray) -> int:
        self._grow(self._n + 1)
        row = self._n
        self._acc_buf[row] = hv.astype(np.int32)
        self._counts_buf[row] = 1
        self._cent_buf[row] = hv.astype(np.int8)
        self._n += 1
        self._dirty.add(row)
        cid = self._next_id
        self._next_id += 1
        self._ids.append(cid)
        self.spawned += 1
        return cid

    def _refresh_row(self, row: int) -> None:
        # bipolar majority bundle: sign of the element sum, zeros -> +1
        self._cent_buf[row] = np.where(self._acc_buf[row] >= 0, 1,
                                       -1).astype(np.int8)
        self._dirty.add(row)

    def maybe_consolidate(self) -> bool:
        """Re-cluster the centroid bank with complete linkage when due;
        merged clusters sum their accumulators and the dropped ids remap
        to the survivor (canonical = lowest-numbered row, i.e. oldest)."""
        cfg = self.cfg
        if (not cfg.consolidate_every
                or self._since_consol < cfg.consolidate_every):
            return False
        self._since_consol = 0
        if self._n < 2:
            return False
        t0 = time.perf_counter()
        merged = self._consolidate()
        self.consolidate_s += time.perf_counter() - t0
        return merged

    def _consolidate(self) -> bool:
        cfg = self.cfg
        dist = pairwise_distances(self.device_bank(), dim=cfg.dim,
                                  hamming=self.hamming)
        res = complete_linkage(dist, cfg.merge_threshold)
        del dist
        labels = res.labels.cpu().numpy()
        self.consolidations += 1
        if res.num_merges == 0:
            return False
        keep = np.unique(labels)                  # sorted survivors
        new_row = np.searchsorted(keep, labels)
        acc = np.zeros((len(keep), cfg.dim), np.int32)
        counts = np.zeros((len(keep),), np.int64)
        np.add.at(acc, new_row, self._acc)
        np.add.at(counts, new_row, self._counts_buf[:self._n])
        for old_row in np.flatnonzero(labels != np.arange(self._n)):
            self._remap[self._ids[old_row]] = self._ids[int(labels[old_row])]
            self.merges += 1
        self._ids = [self._ids[lab] for lab in keep]
        self._n = len(keep)
        self._acc_buf[:self._n] = acc
        self._counts_buf[:self._n] = counts
        self._cent_buf[:self._n] = np.where(acc >= 0, 1, -1).astype(np.int8)
        self._dirty = set(range(self._n))
        self.struct_version += 1
        return True

    def resolve(self, cluster_id: int) -> int:
        """Follow the merge chain: the current canonical id for a cluster
        id handed out earlier (identity for live clusters)."""
        seen = set()
        while cluster_id in self._remap and cluster_id not in seen:
            seen.add(cluster_id)
            cluster_id = self._remap[cluster_id]
        return cluster_id

    def centroid(self, cluster_id: int) -> np.ndarray:
        """The (D,) int8 centroid snapshot for a (resolved) cluster id."""
        row = self._ids.index(self.resolve(cluster_id))
        return self._cent[row].copy()

    def labels_for(self, assignments: list[ClusterAssignment]) -> np.ndarray:
        """Resolved cluster id per assignment: the replayed-stream view
        comparable against a batch ``complete_linkage`` partition."""
        return np.asarray([self.resolve(a.cluster_id) for a in assignments],
                          np.int64)

    def summary(self) -> dict:
        return {
            "clusters": self.num_clusters,
            "assigned": self.assigned,
            "spawned": self.spawned,
            "consolidations": self.consolidations,
            "merges": self.merges,
            "threshold": self.cfg.threshold,
            "packed": self.cfg.packed,
        }

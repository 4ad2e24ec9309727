"""Filesystem checkpointing (``repro.dist.checkpoint``): atomic step
directories, keep-N GC, async save and integrity validation.

Layout (one directory per step, renamed into place atomically):

    <dir>/step_00000042/leaf_00000.bin   # one leaf's bytes, C order
    <dir>/step_00000042/meta.json        # leaf paths, shapes, dtypes,
                                         # CRC-32s; the tree's scalars

The port's own format: a tree (dataclasses, dicts, lists, ``nn.Module``s
by their named parameters, tensors of any dtype, and Python scalars) is
flattened to paths; each tensor leaf is written as its raw bytes, one
file a leaf, so neither a save nor a restore holds more than one leaf on
the host (a full-width training state is tens of GB). Scalars (the step
counters) live in ``meta.json``. A torn write only ever leaves a
``step_XXXXXXXX.tmp-*`` directory behind, which ``list_steps`` ignores.
``restore_latest`` walks steps newest-first and skips any checkpoint whose
files, sizes or CRC-32s do not validate, so a corrupt newest step
degrades to the previous one. Restoring copies each leaf into the
target's tensor in place (as ``load_state_dict`` does: the target keeps
its device and needs no second copy of the state) and returns the target
with the saved scalars.

Over a mesh the format is the same: a ``DTensor`` leaf is gathered whole
to rank 0's host (one leaf at a time: each rank's block copied to its
host and gathered over gloo, a collective every rank takes part in) and
rank 0 writes it; the ranks wait for the write before ``save`` (or ``wait``)
returns. A restore places each leaf as the reference's ``restore(...,
shardings=)`` does: a ``DTensor`` leaf of the target receives its block
in place (read from the leaf's file alone: a memory map, sliced), and a
plain leaf with placements in ``shardings`` becomes a ``DTensor`` on the
installed mesh. A checkpoint written on one mesh (or on one device)
restores on another, since the files hold whole values.
"""

from __future__ import annotations

import dataclasses
import json
import re
import shutil
import threading
import uuid
import zlib
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.dist import sharding as SH

_STEP_RE = re.compile(r"^step_(\d{8})$")
_SCALARS = (bool, int, float, type(None))
_CHUNK = 1 << 26  # bytes a CRC read takes at a time


def _flatten(tree):
    """(path, leaf) pairs in a fixed order; leaves are tensors or
    scalars."""
    return [(p, v) for p, v, _ in _leaves(tree)]


def _leaves(tree, path: str = "", shardings=None):
    """(path, leaf, placements) triples in a fixed order; leaves are
    tensors or scalars, placements the entry of ``shardings`` (a tree
    mirroring ``tree``: a placements tuple or None a tensor, a list in
    ``parameters()`` order a module) or None."""
    if isinstance(tree, torch.Tensor):
        yield path, tree, shardings
    elif isinstance(tree, nn.Module):
        named = list(tree.named_parameters())
        for i, (name, p) in enumerate(named):
            yield (f"{path}/{name}", p,
                   None if shardings is None else shardings[i])
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}/{f.name}",
                                None if shardings is None
                                else getattr(shardings, f.name))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}",
                                None if shardings is None else shardings[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}",
                                None if shardings is None else shardings[i])
    elif isinstance(tree, _SCALARS):
        yield path, tree, None
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{path or '/'}")


def _rebuilt(tree, values: dict, path: str = ""):
    """``tree`` with its scalar leaves, and any tensor leaf that a restore
    replaced (a plain leaf placed on the mesh), taken from ``values``;
    the other tensors and modules are kept (their values were copied in
    place)."""
    if isinstance(tree, torch.Tensor):
        return values.get(path, tree)
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            new = values.get(f"{path}/{name}", p)
            if new is not p:
                owner, _, leaf = name.rpartition(".")
                setattr(tree.get_submodule(owner) if owner else tree, leaf,
                        new)
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _rebuilt(getattr(tree, f.name), values,
                             f"{path}/{f.name}")
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _rebuilt(v, values, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuilt(v, values, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return values[path]


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _block(f: Path, meta: dict, mesh, placements) -> torch.Tensor:
    """This rank's block of a saved leaf (placed by ``placements`` on
    ``mesh``), read through a memory map of its file."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    dtype = getattr(torch, meta["dtype"].removeprefix("torch."))
    shape = tuple(meta["shape"])
    item = torch.empty((), dtype=dtype).element_size()
    local, offset = compute_local_shape_and_global_offset(
        shape, mesh, tuple(placements))
    raw = np.memmap(f, dtype=np.uint8, mode="r").reshape(*shape, item)
    # a copy: the map is read-only, and the block outlives it
    part = np.array(raw[tuple(slice(o, o + n) for o, n in zip(offset, local))])
    return torch.from_numpy(part).view(dtype).reshape(local)


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A leaf's bytes in C order, as a uint8 array on the host (a
    ``DTensor``'s whole value, gathered to this rank, rank 0)."""
    flat = _whole(t).reshape(-1).contiguous()
    return flat.view(torch.uint8).cpu().numpy()


_CPU_GROUP: dict = {}


def _cpu_group():
    """A gloo group over every rank, for the host copies of the blocks:
    the default group when it is gloo, else one made once (every rank
    reaches its first sharded save together)."""
    if dist.get_backend() == "gloo":
        return None
    if "group" not in _CPU_GROUP:
        _CPU_GROUP["group"] = dist.new_group(backend="gloo")
    return _CPU_GROUP["group"]


def _whole(t: torch.Tensor) -> torch.Tensor | None:
    """A leaf's whole value on the host of rank 0 (None on the others): a
    ``DTensor``'s blocks, each copied to its rank's host and gathered to
    rank 0 alone, placed at their offsets; any other tensor as it is.
    Every rank of the mesh (the whole group) takes part."""
    from torch.distributed.tensor import Shard

    if not SH.on_mesh(t):
        return t.detach()
    mesh, pl, shape = t.device_mesh, t.placements, tuple(t.shape)
    if any(not isinstance(p, Shard) and not p.is_replicate() for p in pl):
        raise ValueError(f"a checkpointed leaf is placed {pl}: only sharded "
                         f"and replicated leaves hold a whole value")
    local = t.to_local().detach().contiguous().cpu()
    world = dist.get_world_size()
    blocks = [torch.empty_like(local) for _ in range(world)] \
        if _rank() == 0 else None
    dist.gather(local, blocks, dst=0, group=_cpu_group())
    if _rank() != 0:
        return None
    whole = torch.empty(shape, dtype=t.dtype)
    grid = mesh.mesh
    for r, block in enumerate(blocks):
        coord = (grid == r).nonzero()[0].tolist()
        index, count = {}, {}
        for i, p in enumerate(pl):     # blocks in the mesh's order
            if isinstance(p, Shard):
                index[p.dim] = index.get(p.dim, 0) * grid.shape[i] + coord[i]
                count[p.dim] = count.get(p.dim, 1) * grid.shape[i]
        whole[tuple(slice(index.get(d, 0) * (n // count.get(d, 1)),
                          (index.get(d, 0) + 1) * (n // count.get(d, 1)))
                    for d, n in enumerate(shape))] = block
    return whole


def _file_crc(path: Path) -> int:
    crc = 0
    with open(path, "rb") as f:
        while chunk := f.read(_CHUNK):
            crc = zlib.crc32(chunk, crc)
    return crc


class CheckpointManager:
    """Save/restore trees of tensors under a root directory.

    ``keep=N`` garbage-collects all but the newest N steps after each
    save; ``keep=None`` keeps everything. ``save`` writes leaf by leaf
    from wherever the tensors live; ``save_async`` first copies the tree
    to the host in the caller's thread (the train step updates the state
    in place, so the copy is the only consistent snapshot), then writes on
    a single background thread (serialized, so concurrent calls cannot
    interleave GC with a rename); ``wait()`` drains and re-raises.
    """

    def __init__(self, directory, keep: int | None = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._lock = threading.Lock()
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="ckpt")
        self._futures: list[Future] = []
        self._sharded = False   # an async save of DTensor leaves pending

    # -- listing / validation ------------------------------------------------

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    def list_steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and p.is_dir():
                out.append(int(m.group(1)))
        return sorted(out)

    def _meta(self, step: int) -> dict:
        return json.loads((self._step_dir(step) / "meta.json").read_text())

    def validate(self, step: int) -> bool:
        """True iff the checkpoint's metadata parses and every leaf file
        has the recorded size and CRC-32."""
        d = self._step_dir(step)
        try:
            meta = self._meta(step)
            for i, m in enumerate(meta["leaves"]):
                f = d / f"leaf_{i:05d}.bin"
                if (f.stat().st_size != m["nbytes"]
                        or _file_crc(f) != m["crc32"]):
                    return False
            return True
        except (OSError, ValueError, KeyError, TypeError):
            return False

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree) -> None:
        items = _flatten(tree)
        self._write(step, items)
        self._barrier(items)

    def save_async(self, step: int, tree) -> Future:
        """The host snapshot is taken now (a ``DTensor`` leaf gathered,
        and kept on rank 0 alone); rank 0 writes it in the background."""
        items = _flatten(tree)
        self._sharded = self._sharded or _sharded(items)
        snap = []
        for p, v in items:
            if isinstance(v, torch.Tensor):
                v = _whole(v) if SH.on_mesh(v) else v.detach().to(
                    "cpu", copy=True)
            if _rank() == 0:
                snap.append((p, v))
        if _rank() != 0:
            fut: Future = Future()
            fut.set_result(None)
            return fut
        fut = self._executor.submit(self._write, step, snap)
        self._futures.append(fut)
        return fut

    def wait(self) -> None:
        futs, self._futures = self._futures, []
        for f in futs:
            f.result()
        if self._sharded:
            dist.barrier()

    def _barrier(self, items: list) -> None:
        """Ranks that saved a ``DTensor`` leaf wait for rank 0's write."""
        if _sharded(items):
            dist.barrier()

    def _write(self, step: int, items: list) -> None:
        """Writes the leaves (rank 0); every other rank of a sharded tree
        takes part in the gathers alone."""
        meta = {"step": step, "leaves": [], "scalars": {}}
        if _rank() != 0:
            for _, v in items:
                if isinstance(v, torch.Tensor):
                    _whole(v)
            return
        with self._lock:
            tmp = self.dir / f"step_{step:08d}.tmp-{uuid.uuid4().hex[:8]}"
            tmp.mkdir(parents=True)
            try:
                for path, v in items:
                    if not isinstance(v, torch.Tensor):
                        meta["scalars"][path] = v
                        continue
                    raw = _host_bytes(v)
                    i = len(meta["leaves"])
                    raw.tofile(tmp / f"leaf_{i:05d}.bin")
                    meta["leaves"].append({
                        "path": path, "shape": list(v.shape),
                        "dtype": str(v.dtype), "nbytes": raw.size,
                        "crc32": zlib.crc32(raw)})
                (tmp / "meta.json").write_text(json.dumps(meta))
                final = self._step_dir(step)
                if final.exists():
                    shutil.rmtree(final)
                tmp.rename(final)
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._gc()

    def _gc(self) -> None:
        if self.keep is None:
            return
        steps = self.list_steps()
        for s in steps[:max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore -------------------------------------------------------------

    def restore(self, step: int, target, shardings=None):
        """Load step ``step`` into ``target`` (a tree of the saved
        structure): every tensor leaf receives the saved values in place
        (a ``DTensor`` leaf its block); returns ``target`` with the saved
        scalars. ``shardings`` (a tree mirroring ``target``, placements
        at its tensor leaves, ``sharding.tree_shardings``' form) places
        each leaf: a plain leaf becomes a ``DTensor`` on the installed
        mesh, and a ``DTensor`` leaf must already be so placed.

        Raises ValueError if the saved paths or leaf shapes / dtypes do
        not match ``target``'s, or a ``DTensor`` leaf is placed otherwise
        than ``shardings`` says."""
        d = self._step_dir(step)
        meta = self._meta(step)
        items = list(_leaves(target, shardings=shardings))
        tensors = [(p, v, s) for p, v, s in items
                   if isinstance(v, torch.Tensor)]
        want = [m["path"] for m in meta["leaves"]]
        if [p for p, _, _ in tensors] != want \
                or {p for p, v, _ in items
                    if not isinstance(v, torch.Tensor)} \
                != set(meta["scalars"]):
            raise ValueError(f"checkpoint step {step} structure mismatch:\n"
                             f"  saved:  {want} + {sorted(meta['scalars'])}"
                             f"\n  target: {[p for p, _, _ in items]}")
        for (path, t, pl), m in zip(tensors, meta["leaves"]):
            if m["shape"] != list(t.shape) or m["dtype"] != str(t.dtype):
                raise ValueError(
                    f"{path}: saved {m['dtype']} {m['shape']} != target "
                    f"{t.dtype} {list(t.shape)}")
            if pl is not None and SH.on_mesh(t) \
                    and tuple(t.placements) != tuple(pl):
                raise ValueError(f"{path}: the target is placed "
                                 f"{t.placements}, shardings say {pl}")
        values = dict(meta["scalars"])
        with torch.no_grad():
            for i, (path, t, pl) in enumerate(tensors):
                f = d / f"leaf_{i:05d}.bin"
                if SH.on_mesh(t):
                    t.to_local().copy_(self.leaf_block(
                        step, i, t.device_mesh, t.placements, meta))
                elif pl is not None:
                    from torch.distributed.tensor import DTensor

                    mesh = SH.get_mesh()
                    local = self.leaf_block(step, i, mesh, pl, meta)
                    new = DTensor.from_local(local.to(t.device), mesh,
                                             tuple(pl), run_check=False)
                    values[path] = (nn.Parameter(new, t.requires_grad)
                                    if isinstance(t, nn.Parameter) else new)
                else:
                    raw = np.fromfile(f, dtype=np.uint8)
                    t.copy_(torch.from_numpy(raw).view(t.dtype).reshape(
                        t.shape))
        return _rebuilt(target, values)

    def leaf_block(self, step: int, i: int, mesh, placements,
                   meta: dict | None = None) -> torch.Tensor:
        """This rank's block of saved leaf ``i`` of step ``step`` placed
        by ``placements`` on ``mesh``, on the host (read through a memory
        map of the leaf's file)."""
        meta = meta or self._meta(step)
        return _block(self._step_dir(step) / f"leaf_{i:05d}.bin",
                      meta["leaves"][i], mesh, placements)

    def restore_latest(self, target, shardings=None):
        """(step, tree) from the newest checkpoint that validates and
        matches ``target``'s structure; None if no usable checkpoint."""
        for step in reversed(self.list_steps()):
            if not self.validate(step):
                continue
            try:
                return step, self.restore(step, target, shardings)
            except (ValueError, OSError, KeyError):
                continue
        return None


def _sharded(items: list) -> bool:
    """Whether a flattened tree holds a ``DTensor`` leaf."""
    return any(SH.on_mesh(v) for _, v in items)

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
from torch import nn

_STEP_RE = re.compile(r"^step_(\d{8})$")
_SCALARS = (bool, int, float, type(None))
_CHUNK = 1 << 26  # bytes a CRC read takes at a time


def _flatten(tree, path: str = ""):
    """(path, leaf) pairs in a fixed order; leaves are tensors or
    scalars."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield f"{path}/{name}", p
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _flatten(getattr(tree, f.name), f"{path}/{f.name}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{path}/{i}")
    elif isinstance(tree, _SCALARS):
        yield path, tree
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{path or '/'}")


def _with_scalars(tree, scalars: dict, path: str = ""):
    """``tree`` with its scalar leaves replaced from ``scalars``; tensors
    and modules are kept (their values were copied in place)."""
    if isinstance(tree, (torch.Tensor, nn.Module)):
        return tree
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _with_scalars(getattr(tree, f.name), scalars,
                                  f"{path}/{f.name}")
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _with_scalars(v, scalars, f"{path}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_with_scalars(v, scalars, f"{path}/{i}")
                          for i, v in enumerate(tree))
    return scalars[path]


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """A leaf's bytes in C order, as a uint8 array on the host."""
    flat = t.detach().reshape(-1).contiguous()
    return flat.view(torch.uint8).cpu().numpy()


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
        self._write(step, list(_flatten(tree)))

    def save_async(self, step: int, tree) -> Future:
        snap = [(p, v.detach().to("cpu", copy=True)
                 if isinstance(v, torch.Tensor) else v)
                for p, v in _flatten(tree)]
        fut = self._executor.submit(self._write, step, snap)
        self._futures.append(fut)
        return fut

    def wait(self) -> None:
        futs, self._futures = self._futures, []
        for f in futs:
            f.result()

    def _write(self, step: int, items: list) -> None:
        meta = {"step": step, "leaves": [], "scalars": {}}
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

    def restore(self, step: int, target):
        """Load step ``step`` into ``target`` (a tree of the saved
        structure): every tensor leaf receives the saved values in place;
        returns ``target`` with the saved scalars.

        Raises ValueError if the saved paths or leaf shapes / dtypes do
        not match ``target``'s."""
        d = self._step_dir(step)
        meta = self._meta(step)
        items = list(_flatten(target))
        tensors = [(p, v) for p, v in items if isinstance(v, torch.Tensor)]
        want = [m["path"] for m in meta["leaves"]]
        if [p for p, _ in tensors] != want \
                or {p for p, v in items if not isinstance(v, torch.Tensor)} \
                != set(meta["scalars"]):
            raise ValueError(f"checkpoint step {step} structure mismatch:\n"
                             f"  saved:  {want} + {sorted(meta['scalars'])}"
                             f"\n  target: {[p for p, _ in items]}")
        for (path, t), m in zip(tensors, meta["leaves"]):
            if m["shape"] != list(t.shape) or m["dtype"] != str(t.dtype):
                raise ValueError(
                    f"{path}: saved {m['dtype']} {m['shape']} != target "
                    f"{t.dtype} {list(t.shape)}")
        with torch.no_grad():
            for i, (_, t) in enumerate(tensors):
                raw = np.fromfile(d / f"leaf_{i:05d}.bin", dtype=np.uint8)
                t.copy_(torch.from_numpy(raw).view(t.dtype).reshape(
                    t.shape))
        return _with_scalars(target, meta["scalars"])

    def restore_latest(self, target):
        """(step, tree) from the newest checkpoint that validates and
        matches ``target``'s structure; None if no usable checkpoint."""
        for step in reversed(self.list_steps()):
            if not self.validate(step):
                continue
            try:
                return step, self.restore(step, target)
            except (ValueError, OSError, KeyError):
                continue
        return None

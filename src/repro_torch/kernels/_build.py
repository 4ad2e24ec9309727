"""Builds the port's CUDA sources into shared libraries and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/repro_torch_kernels/<name>-<hash>.so`` at the root of the
checkout, the first time a kernel is needed; the hash covers the source,
every ``csrc/*.cuh`` header and the flags, so an edited source rebuilds
and an unchanged one is reused. The libraries have plain C entry points
and are loaded with ``ctypes``: no PyTorch headers are compiled, which
keeps a build to seconds. Several sources build in parallel, one
``nvcc`` each.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("topk_hamming", "encode_search", "hamming_pop", "hd_encode",
           "imc_mvm")


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``/``CUDA_PATH``, else from ``PATH``, else
    from the toolkit PyTorch locates; raises when there is none."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        home = os.environ.get(var)
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compiles every named kernel whose library is missing, all ``nvcc``
    processes at once; returns name -> library path. Each compiler's
    output (with ``-Xptxas -v``: registers, shared memory, spills) is
    kept beside its library as ``.log``. Raises on a failed build."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        procs[n] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
             str(CSRC / f"{n}.cu")], stdout=log, stderr=subprocess.STDOUT),
            tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, paths[n])
        else:
            failed.append(f"{n} (rc {rc}): "
                          f"{paths[n].with_suffix('.log').read_text()[-4000:]}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` (building it first if needed)."""
    return ctypes.CDLL(str(build((name,))[name]))


def build_log(name: str) -> str:
    """The compiler output kept from the build of kernel ``name``."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""

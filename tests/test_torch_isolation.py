"""The PyTorch port stands alone and never hides the device.

* no module of ``src/repro_torch`` (nor ``chip_smoke.py``) imports JAX or
  the JAX package, and importing the port's serving stack loads no JAX;
* entry points default to CUDA and raise on a host without it;
* a CUDA tensor reaching a kernel wrapper launches the kernel or raises:
  there is no quiet fall back to the plain version.
"""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.hd.encoding import HDEncoderConfig, make_codebooks
from repro_torch.kernels import _build
from repro_torch.kernels.encode_search import (
    encode_search,
    encode_search_banded,
)
from repro_torch.kernels.hamming_pop import hamming_pop
from repro_torch.kernels.hd_encode import hd_encode
from repro_torch.kernels.imc_mvm import imc_mvm
from repro_torch.kernels.topk_hamming import topk_hamming, topk_hamming_banded
from repro_torch.launch import serve_cluster, serve_db
from repro_torch.launch import tune as tune_cli
from repro_torch.serve import (
    BankRegistry,
    ClusteringConfig,
    DBSearchServer,
    QueryEncoder,
    StreamingClusterer,
)
from repro_torch.spectra import SyntheticMSConfig, generate_dataset

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.serve, repro_torch.serve.oms, "
            "repro_torch.spectra.preprocess, repro_torch.launch.serve_db, "
            "repro_torch.launch.serve_cluster, repro_torch.serve.clustering, "
            "repro_torch.core.hd.clustering, repro_torch.kernels.hamming_pop, "
            "repro_torch.kernels.hd_encode, repro_torch.kernels.imc_mvm, "
            "repro_torch.kernels.block_utils, repro_torch.tune, "
            "repro_torch.launch.tune, repro_torch.launch.roofline, "
            "repro_torch.convert; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ,
                              "PYTHONPATH": str(ROOT / "src")})
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("entry", ["codebooks", "dataset", "encoder",
                                   "launcher", "cluster_launcher",
                                   "clusterer", "cluster_server",
                                   "tune_launcher"])
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    calls = {
        "codebooks": lambda: make_codebooks(HDEncoderConfig(dim=64)),
        "dataset": lambda: generate_dataset(SyntheticMSConfig()),
        "encoder": lambda: QueryEncoder.from_config(
            dim=64, num_features=8, num_levels=4),
        "launcher": lambda: serve_db.main(["--reduced"]),
        "cluster_launcher": lambda: serve_cluster.main(["--reduced"]),
        "clusterer": lambda: StreamingClusterer(
            ClusteringConfig(dim=64, threshold=4.0)),
        "cluster_server": lambda: DBSearchServer(
            BankRegistry(), clustering=ClusteringConfig(dim=64,
                                                        threshold=4.0)),
        "tune_launcher": lambda: tune_cli.main(["--quick", "--out",
                                                "unused.json"]),
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports ``is_cuda``: it takes the kernel path."""

    @property
    def is_cuda(self):
        return True


def _cuda_looking(a):
    return torch.from_numpy(a).as_subclass(_CudaLooking)


@pytest.mark.parametrize("kernel", ["topk_hamming", "encode_search",
                                    "topk_hamming_banded",
                                    "encode_search_banded", "hamming_pop",
                                    "hd_encode", "imc_mvm"])
def test_cuda_tensor_without_a_built_kernel_raises(kernel, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR",
                        ROOT / "build" / "never_built_for_this_test")
    monkeypatch.setenv("PATH", "/nonexistent")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if _has_nvcc():
        pytest.skip("a CUDA toolkit is installed here")
    _build.load.cache_clear()
    rng = np.random.default_rng(0)
    rows = _cuda_looking(rng.integers(-5, 5, (40, 2)).astype(np.int32))
    codebooks = (_cuda_looking(np.zeros((3, 8), np.int32)),
                 _cuda_looking(np.ones((8, 64), np.int8)),
                 _cuda_looking(np.ones((4, 64), np.int8)))
    bands = (_cuda_looking(np.zeros(3, np.int32)),
             _cuda_looking(np.full(3, 20, np.int32)))
    kernels = (topk_hamming, encode_search, topk_hamming_banded,
               encode_search_banded, hamming_pop, hd_encode, imc_mvm)
    before = [fn.launches for fn in kernels]
    with pytest.raises(RuntimeError, match="nvcc"):
        if kernel == "topk_hamming":
            topk_hamming(rows[:3], rows, dim=64, k=2)
        elif kernel == "encode_search":
            encode_search(*codebooks, rows, dim=64, k=2)
        elif kernel == "topk_hamming_banded":
            topk_hamming_banded(rows[:3], rows, *bands, dim=64, k=2)
        elif kernel == "hamming_pop":
            hamming_pop(rows[:3], rows, dim=64)
        elif kernel == "hd_encode":
            hd_encode(*codebooks)
        elif kernel == "imc_mvm":
            floats = _cuda_looking(np.ones((5, 130), np.float32))
            imc_mvm(floats, floats, full_scale=10.0)
        else:
            encode_search_banded(*codebooks, rows, *bands, dim=64, k=2)
    assert [fn.launches for fn in kernels] == before


def _has_nvcc():
    try:
        _build.find_nvcc()
    except RuntimeError:
        return False
    return True

"""The PyTorch port stands alone and never hides the device.

* no module of ``src/repro_torch`` (nor ``chip_smoke.py``, nor the tests'
  rank-worker modules ``tests/_torch_*.py``, nor ``examples/torch_*.py``)
  imports JAX or the JAX package, and importing the port's serving stack,
  its mesh modules, the dry run, the examples and the rank workers loads
  no JAX;
* entry points default to CUDA and raise on a host without it;
* a CUDA tensor reaching a kernel wrapper launches the kernel or raises:
  there is no quiet fall back to the plain version.
"""

import ast
import dataclasses
import importlib.util
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import SpecPCMConfig, run_clustering, run_db_search
from repro_torch.core.hd.encoding import HDEncoderConfig, make_codebooks
from repro_torch.core.imc import ArrayConfig, DeviceConfig, ISAExecutor
from repro_torch.kernels import _build
from repro_torch.kernels.encode_search import (
    encode_search,
    encode_search_banded,
)
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
)
from repro_torch.kernels.hamming_pop import hamming_pop
from repro_torch.kernels.hd_encode import hd_encode
from repro_torch.kernels.imc_mvm import imc_mvm, imc_mvm_plain
from repro_torch.kernels.topk_hamming import topk_hamming, topk_hamming_banded
from repro_torch.launch import serve, serve_cluster, serve_db
from repro_torch.launch import train as train_cli
from repro_torch.launch import tune as tune_cli
from repro_torch.models.layers import _imc_linear
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import (
    BankRegistry,
    ClusteringConfig,
    DBSearchServer,
    DeltaBank,
    QueryEncoder,
    StreamingClusterer,
)
from repro_torch.spectra import SyntheticMSConfig, generate_dataset

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tests").glob("_torch_*.py")) + (
    sorted((ROOT / "examples").glob("torch_*.py")))
EXAMPLES = ("torch_quickstart", "torch_db_search_serving",
            "torch_e2e_ms_pipeline")


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
            "repro_torch.convert, repro_torch.launch.serve, "
            "repro_torch.models.model_zoo, repro_torch.data.tokens, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.serve.scheduler, repro_torch.serve.delta, "
            "repro_torch.serve.staging, repro_torch.core, "
            "repro_torch.core.imc, repro_torch.core.pipeline, "
            "repro_torch.train, repro_torch.dist, "
            "repro_torch.launch.train, repro_torch.launch.mesh, "
            "repro_torch.dist.collective_matmul, _torch_mesh_ranks, "
            "_torch_dist_ranks; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests")])})
    assert out.stdout.strip() == "[]", out.stdout


def test_importing_the_mesh_lm_modules_loads_no_jax():
    """The modules the dense LM over a mesh runs, and its tests' rank
    worker, load no JAX."""
    code = ("import sys, repro_torch.dist.sharding, "
            "repro_torch.dist.checkpoint, repro_torch.models.layers, "
            "repro_torch.models.transformer, repro_torch.models.model_zoo, "
            "repro_torch.train.optimizer, repro_torch.train.train_step, "
            "repro_torch.train.serve_step, repro_torch.data.tokens, "
            "repro_torch.convert, repro_torch.launch.mesh, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.launch.serve_db, _torch_lm_mesh_ranks; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests")])})
    assert out.stdout.strip() == "[]", out.stdout


def test_importing_the_mesh_family_modules_loads_no_jax():
    """The modules the MoE, encoder-decoder and VLM families over a mesh
    run (the banded top-k's overflow canonicalization too), and their
    tests' rank worker, load no JAX."""
    code = ("import sys, repro_torch.models.layers, "
            "repro_torch.models.transformer, repro_torch.models.model_zoo, "
            "repro_torch.dist, repro_torch.train.train_step, "
            "repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.kernels.topk_hamming.ops, "
            "_torch_family_mesh_ranks; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests")])})
    assert out.stdout.strip() == "[]", out.stdout


def test_importing_the_recurrent_mesh_and_dcn_modules_loads_no_jax():
    """The modules xLSTM and Hymba over a mesh and the in-pod DCN routes
    run, and their tests' rank workers, load no JAX."""
    code = ("import sys, repro_torch.models.recurrent, "
            "repro_torch.models.transformer, repro_torch.dist.compression, "
            "repro_torch.dist.sharding, repro_torch.train.train_step, "
            "_torch_recurrent_mesh_ranks, _torch_dcn_mesh_ranks; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests")])})
    assert out.stdout.strip() == "[]", out.stdout


def test_importing_the_dryrun_and_the_examples_loads_no_jax():
    """The dry-run cost model and the port's examples load no JAX (the
    examples are loaded as modules; their ``main`` does not run)."""
    loads = "; ".join(
        f"s = importlib.util.spec_from_file_location({name!r}, "
        f"{str(ROOT / 'examples' / (name + '.py'))!r}); "
        f"s.loader.exec_module(importlib.util.module_from_spec(s))"
        for name in EXAMPLES + ("torch_train_lm_imc",))
    code = ("import sys, importlib.util, repro_torch.launch.dryrun, "
            "repro_torch.launch.roofline, _torch_continuous_mesh_ranks; "
            + loads + "; print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": os.pathsep.join(
                             [str(ROOT / "src"), str(ROOT / "tests")])})
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("entry", ["codebooks", "dataset", "encoder",
                                   "launcher", "cluster_launcher",
                                   "clusterer", "cluster_server",
                                   "tune_launcher", "lm_launcher",
                                   "lm_model", "tokens",
                                   "continuous_launcher",
                                   "append_launcher",
                                   "continuous_cluster_launcher",
                                   "delta_bank", "continuous_server",
                                   "run_db_search", "run_clustering",
                                   "isa_executor", "train_launcher",
                                   "train_example", *EXAMPLES])
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
        "lm_launcher": lambda: serve.main(["--arch", "qwen2_7b",
                                           "--reduced", "--kv-quant"]),
        "lm_model": lambda: build_model(get_config("qwen2_7b").reduced()),
        "tokens": lambda: TokenPipeline(2, 8, 256).get(0),
        "continuous_launcher": lambda: serve_db.main(
            ["--reduced", "--fused", "--continuous", "--num-slots", "2"]),
        "append_launcher": lambda: serve_db.main(
            ["--reduced", "--continuous", "--append", "0.25",
             "--compact-threshold", "0.1"]),
        "continuous_cluster_launcher": lambda: serve_cluster.main(
            ["--reduced", "--continuous"]),
        "delta_bank": lambda: DeltaBank(64, oms=False),
        "continuous_server": lambda: DBSearchServer(
            BankRegistry(), continuous=True,
            clustering=ClusteringConfig(dim=64, threshold=4.0)),
        "run_db_search": lambda: run_db_search(
            np.zeros((2, 8), np.float32), np.zeros(2, np.float32),
            np.zeros((3, 8), np.float32), np.zeros(3, np.float32),
            SpecPCMConfig(hd_dim=33)),
        "run_clustering": lambda: run_clustering(
            np.zeros((2, 8), np.float32), np.zeros(2, np.float32),
            np.zeros(2, np.int32), SpecPCMConfig(hd_dim=33)),
        "isa_executor": lambda: ISAExecutor(ArrayConfig(), DeviceConfig()),
        "train_launcher": lambda: train_cli.main(
            ["--arch", "qwen2_7b", "--reduced", "--steps", "1"]),
        "train_example": lambda: _train_example().main(["--steps", "1"]),
        **{name: (lambda n=name: _example(n).main([])) for name in EXAMPLES},
    }
    with pytest.raises(RuntimeError, match="cuda"):
        calls[entry]()


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _train_example():
    return _example("torch_train_lm_imc")


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
                                    "hd_encode", "imc_mvm",
                                    "decode_attention", "imc_linear"])
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
               encode_search_banded, hamming_pop, hd_encode, imc_mvm,
               decode_attention)
    before = [fn.launches for fn in kernels]
    plain_calls = decode_attention_plain.calls
    imc_plain_calls = imc_mvm_plain.calls
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
        elif kernel == "imc_linear":
            cfg = dataclasses.replace(get_config("qwen2_7b").reduced(),
                                      imc_linear=True)
            _imc_linear(_cuda_looking(np.ones((2, 3, 200), np.float32)),
                        _cuda_looking(np.ones((200, 64), np.float32)), cfg)
        elif kernel == "decode_attention":
            decode_attention(
                _cuda_looking(np.ones((2, 2, 7, 16), np.float32)),
                _cuda_looking(np.ones((2, 9, 2, 16), np.int8)),
                _cuda_looking(np.ones((2, 9, 2, 16), np.int8)),
                _cuda_looking(np.ones((2, 9, 2), np.float32)),
                _cuda_looking(np.ones((2, 9, 2), np.float32)), 5)
        else:
            encode_search_banded(*codebooks, rows, *bands, dim=64, k=2)
    assert [fn.launches for fn in kernels] == before
    # a CUDA tensor never reaches the plain version
    assert decode_attention_plain.calls == plain_calls
    assert imc_mvm_plain.calls == imc_plain_calls


def _has_nvcc():
    try:
        _build.find_nvcc()
    except RuntimeError:
        return False
    return True

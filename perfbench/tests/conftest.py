"""Fixtures of the benchmark's own tests (CPU; the ``gpu`` ones decide
inside a fixture whether there is a card).

``tiny_root`` is a checkout-shaped directory holding ``BENCHMARK.json``
and the configuration and mix files at a size the CPU runs in seconds;
the harness's code is the repository's own.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_LIBRARY = {"identities": 48, "spectra_per_identity": 4, "num_bins": 64,
                "peaks_per_peptide": 8, "noise_peaks": 3}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    root = tmp_path_factory.mktemp("tiny")
    b = bench()
    for c in b["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["library"].update(TINY_LIBRARY)
        if "open_window" in cfg["search"]:
            cfg["library"]["precursor_range"] = [400.0, 700.0]
        cfg["hd"]["dim"] = 256
        path = root / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    for w in b["workloads"]:
        src = ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
        mix = json.loads(src.read_text())
        mix["pool_spectra"] = 2048
        if mix["generator"] == "open_loop":
            mix["rate_per_s"] = 400.0
        dst = root / "perfbench" / "traffic" / src.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(json.dumps(mix))
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return root


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)

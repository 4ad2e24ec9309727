"""The port's examples (``examples/torch_*.py``), each run in a subprocess
with ``--device cpu`` (one intra-op thread) at a small size.

What is deterministic is held against the reference's own arithmetic:
the dataset sizes, the packed shape (the reference's ``encode_and_pack``
on the same config) and ``db_search_cost``'s modeled latency and energy
(the reference's function, formatted as the example formats it), line
for line. What is drawn (the port's ``torch.Generator`` streams cannot
reproduce ``jax.random``) is held against the invariants the reference
states: nearest-neighbor accuracy through the analog chain and
identifications at the FDR above stated floors, a cached second pass
(hit rate exactly 50%), one representative per cluster. Every printed
line has the reference example's structure.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest

from repro.core import SpecPCMConfig as JConfig
from repro.core import encode_and_pack as jencode_and_pack
from repro.core.imc.energy import db_search_cost as jcost

ROOT = Path(__file__).resolve().parent.parent
# floors of the drawn quantities: the replicates of one identity are
# near-duplicates (the reference's synthetic model), so the analog chain
# finds the right identity for almost every query, and the FDR filter
# keeps almost every true match
ACCURACY_FLOOR = 0.9
IDENTIFIED_FLOOR = 0.8
E2E_ARGV = ["--identities", "12", "--replicates", "4", "--queries", "24"]


def _run(name: str, argv=()) -> list[str]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        "--device", "cpu", *argv], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout.splitlines()


@pytest.fixture(scope="module")
def quickstart():
    return _run("torch_quickstart.py")


@pytest.fixture(scope="module")
def serving():
    return _run("torch_db_search_serving.py")


@pytest.fixture(scope="module")
def e2e():
    return _run("torch_e2e_ms_pipeline.py", E2E_ARGV)


# ------------------------------------------------------------ quickstart --

def test_quickstart_prints_the_references_lines(quickstart):
    patterns = [r"dataset: \d+ spectra, \d+ m/z bins",
                r"packed HVs: \(\d+, \d+\) int8 \(D=\d+ -> D/n=\d+ for "
                r"\d-bit MLC\)",
                r"nearest-neighbor identity accuracy through the analog "
                r"chain: [\d.]+%",
                r"modeled chip cost: [\d.]+ us, [\d.]+ nJ"]
    assert len(quickstart) == len(patterns)
    for line, pat in zip(quickstart, patterns):
        assert re.fullmatch(pat, line), (line, pat)


def test_quickstart_sizes_are_the_references(quickstart):
    cfg = JConfig(hd_dim=2049, mlc_bits=3, num_levels=16)
    width = jencode_and_pack(jnp.zeros((1, 1024), jnp.float32),
                             cfg).shape[1]
    assert quickstart[0] == "dataset: 256 spectra, 1024 m/z bins"
    assert quickstart[1] == (f"packed HVs: (256, {width}) int8 (D=2049 -> "
                             f"D/n={width} for 3-bit MLC)")


def test_quickstart_cost_is_the_references(quickstart):
    cost = jcost(num_queries=64, num_refs=256, hd_dim=2049,
                 candidate_fraction=1.0)
    assert quickstart[3] == (f"modeled chip cost: "
                             f"{cost.latency_s * 1e6:.2f} us, "
                             f"{cost.energy_j * 1e9:.1f} nJ")


def test_quickstart_accuracy_clears_the_floor(quickstart):
    acc = float(re.search(r"([\d.]+)%$", quickstart[2]).group(1)) / 100
    assert acc >= ACCURACY_FLOOR


# --------------------------------------------------------------- serving --

def test_serving_prints_the_references_lines(serving):
    patterns = [r"registered 2 tenant banks \(lazy; none built yet: "
                r"\[False, False\]\)",
                r"served \d+ queries in \d+ micro-batches: [\d.]+ "
                r"queries/sec, p50 [\d.]+ ms / p95 [\d.]+ ms",
                r"query-HV cache: hit rate \d+% \(\d+ hits / \d+ misses, "
                r"\d+ entries\) — pass 2 was served from cache",
                r"  lab0: \d+ reqs, p95 [\d.]+ ms, cache hit rate \d+%",
                r"  lab1: \d+ reqs, p95 [\d.]+ ms, cache hit rate \d+%",
                r"identified at 5% FDR: \d+/\d+ \(\d+ correct identity\)",
                r"modeled chip cost for the same scan: [\d.]+ us, [\d.]+ uJ"]
    assert len(serving) == len(patterns)
    for line, pat in zip(serving, patterns):
        assert re.fullmatch(pat, line), (line, pat)


def test_serving_serves_every_query_and_caches_the_second_pass(serving):
    assert serving[1].startswith("served 128 queries in ")
    # 64 distinct queries, each submitted twice: the second pass hits
    assert serving[2].startswith(
        "query-HV cache: hit rate 50% (64 hits / 64 misses, 64 entries)")
    for line in serving[3:5]:
        assert ": 64 reqs," in line and line.endswith("cache hit rate 50%")


def test_serving_identifications_clear_the_floor(serving):
    accepted, total, correct = map(int, re.fullmatch(
        r"identified at 5% FDR: (\d+)/(\d+) \((\d+) correct identity\)",
        serving[5]).groups())
    assert total == 128
    assert accepted >= IDENTIFIED_FLOOR * total and correct <= accepted


def test_serving_cost_is_the_references(serving):
    # lab0's bank: 64 x 2 targets and as many decoys
    cost = jcost(num_queries=128, num_refs=256, hd_dim=1024,
                 candidate_fraction=1.0)
    assert serving[6] == (f"modeled chip cost for the same scan: "
                          f"{cost.latency_s * 1e6:.1f} us, "
                          f"{cost.energy_j * 1e6:.2f} uJ")


# ------------------------------------------------------------------- e2e --

def test_e2e_prints_the_references_lines(e2e):
    patterns = [r"\[1/4\] dataset: \d+ spectra \(\d+ peptides x \d+\)",
                r"\[2/4\] clustering: \d+ clusters, clustered-ratio="
                r"[\d.]+%, incorrect=[\d.]+%",
                r"      chip model: [\d.]+ ms, [\d.]+ uJ",
                r"\[3/4\] condensed library: \d+ representatives "
                r"\([\d.]+% of raw\)",
                r"\[4/4\] DB search: \d+/\d+ identified at 1% FDR, "
                r"recall=[\d.]+%",
                r"      chip model: [\d.]+ ms, [\d.]+ uJ"]
    assert len(e2e) == len(patterns)
    for line, pat in zip(e2e, patterns):
        assert re.fullmatch(pat, line), (line, pat)


def test_e2e_sizes_and_one_representative_per_cluster(e2e):
    assert e2e[0] == "[1/4] dataset: 48 spectra (12 peptides x 4)"
    clusters = int(re.search(r"(\d+) clusters", e2e[1]).group(1))
    reps = int(re.search(r"(\d+) representatives", e2e[3]).group(1))
    assert reps == clusters
    assert e2e[3].endswith(f"({reps / 48:.1%} of raw)")


def test_e2e_quality_clears_the_floors(e2e):
    incorrect = float(re.search(r"incorrect=([\d.]+)%", e2e[1]).group(1))
    assert incorrect <= 10.0
    found, total = map(int, re.search(r"(\d+)/(\d+) identified",
                                      e2e[4]).groups())
    assert total == 24 and found >= IDENTIFIED_FLOOR * total
    assert float(re.search(r"recall=([\d.]+)%", e2e[4]).group(1)) >= 90.0

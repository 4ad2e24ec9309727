"""Whole runs of every cell on the CPU at a tiny size: the harness past
its look for a chip, the port's plain paths underneath. A sound run is
correct; the control (the reference over 2-bit cells in the program's
place) and a program broken underneath are not."""

from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import ROOT, bench


def harness():
    import sys
    sys.path.insert(0, str(ROOT / "perfbench"))
    try:
        import run as harness_run
    finally:
        sys.path.remove(str(ROOT / "perfbench"))
    return harness_run


def run_cell(root, capsys, workload, *extra, seed=2**33 + 17, seconds=1.0):
    rc = harness().main(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", "0",
                           *extra], device="cpu", root=root)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    return result


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_a_sound_run_is_correct(tiny_root, capsys, workload):
    r = run_cell(tiny_root, capsys, workload)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    cell = {w["name"]: w for w in bench()["workloads"]}[workload]
    want = {m["name"] for m in bench()["end_to_end"]
            if workload in m.get("workloads", [workload])}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["device"]["count"] == cell["chips"]


def test_the_control_is_not_correct(tiny_root, capsys):
    r = run_cell(tiny_root, capsys, "hek293_oms.backlog", "--control", "2")
    assert r["correct"] is False
    assert r["checks"]["topk_mismatches"]["value"] > 0


def _faults():
    import sys
    sys.path.insert(0, str(ROOT / "perfbench" / "tools"))
    try:
        import faults
    finally:
        sys.path.remove(str(ROOT / "perfbench" / "tools"))
    return faults.FAULTS


@pytest.mark.parametrize("workload,fault,number", [
    ("iprg2012_db.backlog", "answer_altered", "topk_mismatches"),
    ("hek293_oms.delta", "answer_altered", "topk_mismatches"),
    ("iprg2012_db.backlog", "half_batch", "topk_mismatches"),
    ("hek293_oms.backlog", "half_batch", "topk_mismatches"),
    ("hek293_oms.backlog", "bank_bit", "bank_rows_differing"),
    ("iprg2012_db.backlog", "bank_bit", "bank_rows_differing"),
    ("iprg2012_db.live", "answer_dropped", "unanswered"),
    ("hek293_oms.delta", "answer_dropped", "unanswered"),
])
def test_a_fault_underneath_is_caught(tiny_root, capsys, monkeypatch,
                                      workload, fault, number):
    _faults()[fault](monkeypatch)
    # an answer that never comes is waited for; not for a minute here
    from perfbench.harness import loop
    monkeypatch.setattr(loop, "DRAIN_WAIT_S", 2.0)
    r = run_cell(tiny_root, capsys, workload, seconds=1.0)
    assert r["correct"] is False
    assert r["checks"][number]["value"] > 0


def test_same_seed_same_inputs(tiny_root):
    import torch

    from perfbench.harness import data
    cfg = json.loads((tiny_root / "perfbench" / "configs"
                      / "hek293_oms.json").read_text())
    spec = data.SpectraSpec.from_config(cfg["library"])
    a = data.make_library(spec, 16, 2**40 + 3, torch.device("cpu"))
    b = data.make_library(spec, 16, 2**40 + 3, torch.device("cpu"))
    c = data.make_library(spec, 16, 5, torch.device("cpu"))
    assert torch.equal(a.levels, b.levels)
    assert np.array_equal(a.precursor, b.precursor)
    assert not torch.equal(a.levels, c.levels)
    qa = data.make_queries(a, spec, 16, 100, 9, "queries", "cpu")
    qb = data.make_queries(b, spec, 16, 100, 9, "queries", "cpu")
    assert np.array_equal(qa.levels, qb.levels)
    assert (qa.levels.max(axis=1) > 0).all()


def _variant(tiny_root, tmp_path, config: str, change) -> "Path":
    """A copy of the tiny checkout whose configuration ``config`` has
    ``change`` applied to its ``search`` and ``hd`` groups."""
    import shutil
    root = tmp_path / "variant"
    shutil.copytree(tiny_root, root)
    path = root / "perfbench" / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    change(cfg)
    path.write_text(json.dumps(cfg))
    return root


@pytest.mark.parametrize("workload", ["iprg2012_db.backlog",
                                      "iprg2012_db.live"])
def test_flush_sync_serving_is_a_configuration(tiny_root, tmp_path, capsys,
                                               workload):
    root = _variant(tiny_root, tmp_path, "iprg2012_db",
                    lambda c: c["search"].update(continuous=False,
                                                 tenant="lab_a"))
    r = run_cell(root, capsys, workload)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0


def test_a_configuration_the_port_cannot_hold_is_refused(tiny_root, tmp_path,
                                                         capsys):
    root = _variant(tiny_root, tmp_path, "iprg2012_db",
                    lambda c: c["hd"].update(cell_bits=2))
    with pytest.raises(ValueError, match="cell_bits"):
        run_cell(root, capsys, "iprg2012_db.backlog")

"""A traced run of every cell on the card at the tiny size: the profiler
sees the port's kernels, the two clocks align and every per-layer metric
a cell lists is read. Skips without a CUDA device (decided in the
``cuda_device`` fixture)."""

from __future__ import annotations

import json

import pytest

from conftest import ROOT, bench

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_a_traced_run_reads_every_per_layer_metric(tiny_root, capsys,
                                                   cuda_device, workload):
    import sys
    sys.path.insert(0, str(ROOT / "perfbench"))
    try:
        import run as harness_run
    finally:
        sys.path.remove(str(ROOT / "perfbench"))
    rc = harness_run.main(["--workload", workload, "--seed", "3",
                           "--seconds", "2", "--trace", "1"],
                          device=cuda_device, root=tiny_root)
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    want = {m["name"] for m in bench()["per_layer"]
            if workload in m.get("workloads", [workload])}
    assert set(r["metrics"]) == want, err[-3000:]
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["breakdown"]["device_ops"]

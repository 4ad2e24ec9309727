"""Each metric reader on a recorded small trace and a run record."""

from __future__ import annotations

import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest

from perfbench.harness import readers
from perfbench.harness import trace as tr
from perfbench.harness import work

METRICS = Path(__file__).resolve().parents[1] / "metrics"
D, F, K = 8192, 1024, 4


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), readers.reader_file(METRICS, name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def chrome(path: Path, events: list[dict]) -> str:
    path.write_text(json.dumps({"traceEvents": [
        dict(ph="X", **e) for e in events]}))
    return str(path)


def kernel(name, ts_us, dur_us):
    return {"cat": "kernel", "name": name, "ts": ts_us, "dur": dur_us}


def recorded_trace(tmp_path, kernels, syncs=()):
    """A trace of the window 10.0-11.0 s whose clock runs 0.999 s behind
    the host's: the aligning synchronizations, made at host 9.999 s and
    11.001 s, sit at 9.0e6 and 10.002e6 us."""
    ev = [{"cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
           "ts": 9.0e6, "dur": 5.0},
          {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
           "ts": 10.002e6, "dur": 5.0}]
    ev += [{"cat": "cuda_runtime", "name": "cudaStreamSynchronize",
            "ts": s, "dur": d} for s, d in syncs]
    ev += kernels
    return tr.read_chrome_trace(chrome(tmp_path / "t.json", ev), 10.0, 11.0,
                                (9.999, 11.001))


def batch(route, n=32, plan=None, waits=None):
    return types.SimpleNamespace(
        route=route, n=n, plan=plan, t=10.5,
        waits=np.array(waits or [0.001] * n))


def run_record(trace, batches, spans=(), **kw):
    return types.SimpleNamespace(
        trace=trace, traced_batches=batches, batches=batches,
        host_spans=list(spans), device_name="NVIDIA H100 80GB HBM3",
        sizes={"dim": D, "num_features": F, "k": K, "max_batch": 32,
               "base_rows": 1000},
        seconds=20.0, setup_s=12.5, completed=1000, latencies_s=None,
        drain_wait_s=60.0, notes={}, **kw)


def test_trace_is_aligned_to_the_host_clock(tmp_path):
    t = recorded_trace(tmp_path, [kernel("void hd::x<0>(int)", 9.1e6, 1e5)])
    assert t.aligned
    assert t.ops[0][1] == pytest.approx(10.099)
    assert t.busy_s() == pytest.approx(0.1)


def test_encode_search_roofline(tmp_path):
    ks = [kernel("void hd::encode_kernel<0>(int const*)", 9.1e6, 100.0),
          kernel("void hd::tile_scan_kernel<0, 4>(unsigned char const*)",
                 9.1e6 + 100, 1000.0),
          kernel("void hd::merge_splits_kernel<4>(int const*)", 9.1e6 + 1100,
                 100.0),
          kernel("Memcpy HtoD (Pinned -> Device)", 9.1e6 + 1200, 50.0)]
    bs = [batch("exact")]
    got = reader("encode_search.roofline")(run_record(
        recorded_trace(tmp_path, ks), bs))
    w = work.exact_scan(32, 1000, D, D // 8, 4 * F, K)
    want = 100 * w.bound_s(work.peaks("H100")) / 1.2e-3
    assert got == pytest.approx(want)
    # a batch of another route in the window: nothing to attribute
    assert reader("encode_search.roofline")(run_record(
        recorded_trace(tmp_path, ks), bs + [batch("banded")])) is None


def test_banded_and_delta_rooflines(tmp_path):
    plan = types.SimpleNamespace(
        starts=np.array([[0] * 32, [500] * 32]),
        lens=np.array([[100] * 32, [50] * 32]),
        scanned_fraction=0.25)
    merged = types.SimpleNamespace(
        base=plan, scanned_fraction=0.3,
        delta=types.SimpleNamespace(starts=np.array([[0] * 32]),
                                    lens=np.array([[20] * 32])))
    ks = [kernel("void hd::encode_kernel<0>(int)", 9.1e6, 10.0),
          kernel("void hd::band::banded_scan_kernel<0, true>(int)",
                 9.1e6 + 10, 200.0),
          kernel("void hd::band::banded_scan_kernel<1, true>(int)",
                 9.1e6 + 210, 400.0),
          kernel("void hd::merge_splits_kernel<4>(int)", 9.1e6 + 610, 10.0)]
    t = recorded_trace(tmp_path, ks)
    p = work.peaks("H100")
    got = reader("encode_search_banded.roofline")(run_record(
        t, [batch("banded", plan=plan)]))
    # every banded scan launch is counted where the route is the fused one
    w = work.banded_scan(32, plan.starts, plan.lens, D, D // 8, 4 * F, K)
    assert got == pytest.approx(100 * w.bound_s(p) / 620e-6)
    got = reader("delta_scan.roofline")(run_record(
        t, [batch("merged", plan=merged)]))
    w = work.banded_scan(32, merged.delta.starts, merged.delta.lens, D, D,
                         D, K)
    assert got == pytest.approx(100 * w.bound_s(p) / 400e-6)
    assert reader("scanned_fraction")(run_record(
        t, [batch("banded", plan=plan), batch("merged", plan=merged)])) \
        == pytest.approx(0.275)
    assert reader("scanned_fraction")(run_record(t, [batch("exact")])) is None


def test_host_time_idle_share_and_gaps(tmp_path):
    ks = [kernel("void hd::tile_scan_kernel<0, 4>(int)", 9.2e6, 2e5),
          kernel("Memcpy DtoH (Device -> Pinned)", 9.5e6, 1e5)]
    t = recorded_trace(tmp_path, ks, syncs=[(9.05e6, 1e4)])
    spans = [(10.0, 10.1, "step: dispatch"), (10.1, 10.2, "step: poll"),
             (10.2, 10.5, "submit"), (10.5, 11.0, "step: retire")]
    r = run_record(t, [batch("exact"), batch("exact")], spans)
    # working spans 0.1 + 0.3 + 0.5 s, less the 10 ms sync, over 2 batches
    assert reader("host_ms_per_batch")(r) == pytest.approx(445.0)
    assert reader("host_ms_per_batch.live")(r) == pytest.approx(445.0)
    assert reader("device_idle_share")(r) == pytest.approx(70.0)
    assert reader("device_idle_share.live")(r) == pytest.approx(70.0)
    gaps = dict(tr.attribute_gaps(t, spans))
    # busy 10.199-10.399 and 10.499-10.599; idle 10.0-10.199 (dispatch
    # and poll), 10.399-10.499 (submit), 10.599-11.0 (retire)
    assert gaps["step: retire"] == pytest.approx(0.401)
    assert sum(gaps.values()) == pytest.approx(0.7)
    assert t.top_ops()[0] == ["hd::tile_scan_kernel<0, 4>", pytest.approx(0.2)]
    empty = run_record(None, [])
    for name in ("host_ms_per_batch", "device_idle_share",
                 "encode_search.roofline", "delta_scan.roofline"):
        assert reader(name)(empty) is None


def test_scheduler_and_end_to_end_readers():
    bs = [batch("exact", n=8, waits=[0.001 * i for i in range(8)]),
          batch("exact", n=24, waits=[0.002] * 24)]
    r = run_record(None, bs)
    assert reader("batch_fill.live")(r) == pytest.approx(0.5)
    assert reader("queue_wait_p95_ms.live")(r) == pytest.approx(
        1e3 * np.percentile([0.001 * i for i in range(8)] + [0.002] * 24, 95))
    assert reader("spectra_per_s")(r) == pytest.approx(50.0)
    assert reader("setup_s")(r) == 12.5
    assert reader("p95_ms")(r) is None
    r.latencies_s = np.array([0.001] * 95 + [np.inf] * 5)
    # a request never answered counts as the window and the wait after it
    assert reader("p95_ms")(r) == pytest.approx(
        1e3 * np.percentile([0.001] * 95 + [80.0] * 5, 95))

"""The port's autotuner against ``tests/test_tune.py``, case for case, on
the CPU: microbench ceilings, the tuning-table lifecycle, knob resolution,
per-kernel validation, the sweep and the CLI; plus the port's own rules
(the fixed launch rules reproduced exactly, the memoized lookup) and
agreement with the JAX package on bucket strings and ratios.

Tolerance: exact (strings, integers, dicts).
"""

import json

import numpy as np
import pytest
import torch

from repro.tune import table as jax_table
from repro.tune.sweep import tuned_vs_default_ratio as jax_ratio
from repro_torch.kernels.block_utils import (
    ALIGN,
    AUTO,
    DEFAULTS,
    block_aligned,
    resolve_blocks,
    validate_block,
)
from repro_torch.kernels.topk_hamming.ops import (
    BandedPlan,
    plan_banded,
    plan_scan,
    words_per_row,
)
from repro_torch.launch.roofline import HardwareProfile, active_profile
from repro_torch.tune import table as tune_table
from repro_torch.tune.table import (
    TuningTable,
    device_kind,
    load_table,
    lookup_blocks,
    set_active_table,
    shape_bucket,
)

# small tensors: one intra-op thread leaves the cores to the other test
# workers
torch.set_num_threads(1)

RNG = np.random.default_rng(7)
CPU = torch.device("cpu")
H100_SMS = 132
H100_SMEM = 232448


@pytest.fixture(autouse=True)
def _clean_table_state(monkeypatch):
    """Every test starts and ends with no active table, no env var and a
    cleared memo and one-time-log memory."""
    monkeypatch.delenv(tune_table.ENV_VAR, raising=False)
    tune_table.reset()
    yield
    tune_table.reset()


def bip(shape):
    return torch.from_numpy(RNG.choice([-1, 1], size=shape).astype(np.int8))


def words(rows, w):
    return torch.from_numpy(RNG.integers(-2**31, 2**31, size=(rows, w),
                                         dtype=np.int64).astype(np.int32))


# --------------------------------------------------------------------------
# microbench ceilings
# --------------------------------------------------------------------------

def test_measured_ceilings_positive_on_cpu():
    from repro_torch.tune.microbench import (
        measure_mem_bandwidth,
        measure_peak_flops,
    )
    flops = measure_peak_flops(sizes=(128, 256), iters=2, device="cpu")
    bw = measure_mem_bandwidth(sizes_mb=(1, 4), iters=2, device="cpu")
    assert flops["peak_flops"] > 0
    assert all(v > 0 for v in flops["by_size"].values())
    assert bw["hbm_bw"] > 0
    assert flops["peak_flops"] == max(flops["by_size"].values())
    assert bw["hbm_bw"] == max(bw["by_size_mb"].values())


def test_matmul_precision_restored_after_the_sweep():
    from repro_torch.tune.microbench import measure_peak_flops
    before = torch.backends.cuda.matmul.allow_tf32
    measure_peak_flops(sizes=(64,), iters=1, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 == before


def test_ceilings_default_to_the_card_and_raise_without_it():
    from repro_torch.tune.microbench import measure_ceilings
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        measure_ceilings(quick=True)


# --------------------------------------------------------------------------
# table lifecycle
# --------------------------------------------------------------------------

def _mk_table(kind=None, **ceilings):
    return TuningTable(device_kind=kind or device_kind(CPU),
                       ceilings=ceilings, meta={"quick": True})


def test_device_kind_on_the_cpu():
    assert device_kind(CPU) == "cpu"
    assert device_kind("cpu") == "cpu"


def test_shape_bucket_pow2():
    assert shape_bucket((100, 8000, 32)) == "128x8192x32"
    assert shape_bucket((1,)) == "1"
    assert shape_bucket((129,)) == "256"


@pytest.mark.parametrize("shape", [(100, 8000, 32), (1,), (129,), (0, 3),
                                   (32, 1_162_392, 256), (5, 7, 9, 1025)])
def test_shape_bucket_matches_the_jax_package(shape):
    assert shape_bucket(shape) == jax_table.shape_bucket(shape)


def test_table_roundtrip(tmp_path):
    t = _mk_table(peak_flops=1e11, hbm_bw=2e10)
    t.set_entry("topk_hamming", (100, 8000, 32),
                {"block_q": 32, "waves": 2}, us=10.0, default_us=20.0)
    path = t.save(tmp_path / "table.json")
    loaded = load_table(path)
    assert loaded is not None
    assert loaded.device_kind == t.device_kind
    assert loaded.ceilings["peak_flops"] == 1e11
    assert loaded.lookup("topk_hamming", (128, 8192, 32)) == {
        "block_q": 32, "waves": 2}
    assert loaded.lookup("topk_hamming", (128, 1024, 32)) is None
    raw = json.loads(path.read_text())
    assert raw["schema"] == 1 and set(raw) == {
        "schema", "device_kind", "ceilings", "ops", "meta"}


def test_a_port_table_parses_as_a_jax_schema_1_file(tmp_path):
    t = _mk_table(peak_flops=1.0, hbm_bw=2.0)
    t.set_entry("hd_encode", (32, 8192, 1024),
                {"block_b": 8, "block_d": 256})
    raw = json.loads(t.save(tmp_path / "t.json").read_text())
    assert raw["schema"] == jax_table.SCHEMA
    assert list(raw["ops"]["hd_encode"]) == [
        jax_table.shape_bucket((32, 8192, 1024))]


def test_corrupt_table_falls_back(tmp_path, caplog):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    with caplog.at_level("WARNING", logger="repro_torch.tune"):
        assert load_table(p) is None
        assert load_table(p) is None  # second load: no second log line
    assert sum("unreadable" in r.message for r in caplog.records) == 1


@pytest.mark.parametrize("raw", [
    {"schema": 99, "device_kind": "cpu"},
    {"schema": 1},
    {"schema": 1, "device_kind": 3},
    [1, 2, 3],
    {"schema": 1, "device_kind": "cpu", "ops": [1, 2]},
])
def test_partial_table_falls_back(tmp_path, raw):
    p = tmp_path / "partial.json"
    p.write_text(json.dumps(raw))
    assert load_table(p) is None


def test_missing_table_file_falls_back(tmp_path):
    assert load_table(tmp_path / "nowhere.json") is None


def test_misaligned_entry_dropped_at_load(tmp_path, caplog):
    t = _mk_table()
    t.set_entry("topk_hamming", (8, 128, 4), {"block_q": 7, "waves": 4})
    t.set_entry("topk_hamming", (8, 256, 4), {"block_q": 8, "waves": 4})
    t.set_entry("imc_mvm", (8, 256, 4), {"block_q": 32, "tile_cols": 64})
    t.ops["hd_encode"] = {"8x256x4": "not an entry"}
    path = t.save(tmp_path / "table.json")
    with caplog.at_level("WARNING", logger="repro_torch.tune"):
        loaded = load_table(path)
    assert loaded.lookup("topk_hamming", (8, 128, 4)) is None  # dropped
    assert loaded.lookup("topk_hamming", (8, 256, 4)) is not None  # kept
    assert loaded.lookup("imc_mvm", (8, 256, 4)) is None  # not a knob
    assert "hd_encode" not in loaded.ops
    assert any("misaligned" in r.message for r in caplog.records)


def test_unknown_op_dropped_at_load(tmp_path):
    t = _mk_table()
    t.set_entry("not_a_kernel", (8,), {"block_q": 8})
    loaded = load_table(t.save(tmp_path / "table.json"))
    assert loaded.ops == {}


def test_device_kind_mismatch_ignored(tmp_path, caplog):
    t = _mk_table(kind="NVIDIA H100 80GB HBM3")
    t.set_entry("topk_hamming", (8, 128, 4), {"block_q": 8, "waves": 2})
    set_active_table(t.save(tmp_path / "table.json"))
    with caplog.at_level("WARNING", logger="repro_torch.tune"):
        assert lookup_blocks("topk_hamming", (8, 128, 4), CPU) is None
        assert lookup_blocks("topk_hamming", (8, 200, 4), CPU) is None
    kind_logs = [r for r in caplog.records if "device kind" in r.message]
    assert len(kind_logs) == 1  # one-time log


def test_env_var_activation(tmp_path, monkeypatch):
    """The env var is read at the first lookup and again after reset()."""
    t = _mk_table()
    t.set_entry("topk_hamming", (8, 128, 4), {"block_q": 16, "waves": 2})
    path = t.save(tmp_path / "table.json")
    assert tune_table.ENV_VAR == "REPRO_TORCH_TUNING_TABLE"
    assert lookup_blocks("topk_hamming", (8, 128, 4), CPU) is None
    monkeypatch.setenv(tune_table.ENV_VAR, str(path))
    tune_table.reset()
    assert lookup_blocks("topk_hamming", (8, 128, 4), CPU) == {
        "block_q": 16, "waves": 2}
    monkeypatch.delenv(tune_table.ENV_VAR)
    # read once: the table stays until reset()
    assert lookup_blocks("topk_hamming", (8, 128, 4), CPU) is not None
    tune_table.reset()
    assert lookup_blocks("topk_hamming", (8, 128, 4), CPU) is None


def test_the_jax_env_var_is_not_read(tmp_path, monkeypatch):
    t = _mk_table()
    t.set_entry("topk_hamming", (8, 128, 4), {"block_q": 16, "waves": 2})
    monkeypatch.setenv("REPRO_TUNING_TABLE", str(t.save(tmp_path / "t.json")))
    tune_table.reset()
    assert lookup_blocks("topk_hamming", (8, 128, 4), CPU) is None


def test_lookups_are_memoized_until_the_table_changes(monkeypatch):
    t = _mk_table()
    t.set_entry("topk_hamming", (8, 128, 4), {"block_q": 16, "waves": 2})
    set_active_table(t)
    calls = []
    real = tune_table.active_table
    monkeypatch.setattr(tune_table, "active_table",
                        lambda device=None: calls.append(1) or real(device))
    for _ in range(5):
        assert lookup_blocks("topk_hamming", (7, 100, 3), CPU) == {
            "block_q": 16, "waves": 2}
    assert len(calls) == 1           # one bucket: one resolution
    lookup_blocks("topk_hamming", (64, 100, 3), CPU)
    assert len(calls) == 2           # another bucket
    set_active_table(None)
    assert lookup_blocks("topk_hamming", (7, 100, 3), CPU) is None
    assert len(calls) == 3           # a new table clears the memo


def test_resolve_blocks_precedence():
    t = _mk_table()
    t.set_entry("topk_hamming", (8, 128, 4), {"block_q": 16, "waves": 8})
    set_active_table(t)
    none = {"block_q": None, "waves": None}
    # table beats defaults
    assert resolve_blocks("topk_hamming", (8, 128, 4), none, CPU) == {
        "block_q": 16, "waves": 8}
    # explicit beats table
    cfg = resolve_blocks("topk_hamming", (8, 128, 4),
                         {"block_q": 32, "waves": None}, CPU)
    assert cfg == {"block_q": 32, "waves": 8}
    # no table entry for this bucket -> defaults
    assert resolve_blocks("topk_hamming", (64, 1024, 4), none,
                          CPU) == DEFAULTS["topk_hamming"]
    # a table of another kind is not applied
    set_active_table(_mk_table(kind="another card"))
    assert resolve_blocks("topk_hamming", (8, 128, 4), none,
                          CPU) == DEFAULTS["topk_hamming"]


def test_resolution_never_hands_out_the_defaults_themselves():
    cfg = resolve_blocks("imc_mvm", (8, 8, 8), {}, CPU)
    cfg["block_q"] = 64
    assert DEFAULTS["imc_mvm"]["block_q"] == 32


@pytest.mark.parametrize("op", sorted(DEFAULTS))
def test_defaults_are_aligned(op):
    assert set(DEFAULTS[op]) == set(ALIGN[op])
    assert block_aligned(op, DEFAULTS[op])
    for name, value in DEFAULTS[op].items():
        assert validate_block(op, name, value) == value


def test_defaults_are_the_rules_before_the_tuner():
    for op in ("topk_hamming", "encode_search"):
        assert DEFAULTS[op] == {"block_q": AUTO, "waves": 4}
    # the bank-major banded scan fits two blocks an SM: one resident wave
    for op in ("topk_hamming_banded", "encode_search_banded"):
        assert DEFAULTS[op] == {"waves": 2}
    assert "tile_cols" not in ALIGN["imc_mvm"]


@pytest.mark.parametrize("op,name,value,match", [
    ("topk_hamming", "block_q", 12, "one of"),
    ("topk_hamming", "block_q", 64, "compiled instantiations; 0 picks"),
    ("topk_hamming", "waves", 0, "positive multiple of 1"),
    ("topk_hamming_banded", "block_q", 8, "unknown knob"),
    ("encode_search", "waves", 2.0, "waves=2.0"),
    ("hd_encode", "block_d", 100, "32-dim packed codebook words"),
    ("hd_encode", "block_b", True, "block_b=True"),
    ("imc_mvm", "block_r", 100, r"\(32, 64, 128, 256\)"),
    ("imc_mvm", "tile_cols", 128, "unknown knob"),
])
def test_validate_block_names_the_cuda_constraint(op, name, value, match):
    with pytest.raises(ValueError, match=match):
        validate_block(op, name, value)
    assert not block_aligned(op, {name: value})


# --------------------------------------------------------------------------
# the fixed rules: no table -> the launches of the fixed rules
# --------------------------------------------------------------------------

def _fixed_rules(Q, R, k, limit, sms):
    """pick_block_q and split_rows of a packed exact launch with no table
    (block by batch, WAVES = 4), written out from the scans' constants
    (csrc/hd_exact_scan.cuh). A 16- or 32-query block scores on the tensor
    cores: splits of whole 256-row block steps; shared memory for a
    2-stage ring of 32 words (row stride 36) of 256 bank and bq query
    rows, two stages of expanded query words (32 bytes each), a 260-word
    score row per query, the queries' popcounts and the lists. An 8-query
    block keeps the POPC scan: splits of whole 128-row tiles; shared
    memory for its 256 resident query words, the 128 x 36-word tile and
    the lists."""
    def smem(bq):
        if bq == 8:
            return 4 * (bq * 256 + 128 * 36 + 2 * bq * k)
        return 2 * 32 * bq * 32 + 4 * (2 * (256 + bq) * 36 + bq * 260 + bq
                                       + 2 * bq * k)

    fits = [bq for bq in (8, 16, 32) if smem(bq) <= limit]
    bq = next((b for b in fits if b >= Q), fits[-1])
    step = 128 if bq == 8 else 256
    steps = -(-R // step)
    want = max(1, -(-4 * sms // -(-Q // bq)))
    rows = -(-steps // min(want, steps)) * step
    return bq, rows, -(-R // rows)


@pytest.mark.parametrize("Q", [4, 8, 16, 32])
@pytest.mark.parametrize("op", ["topk_hamming", "encode_search"])
def test_no_table_launches_as_before(Q, op):
    R = 1_162_392
    _, qstride = words_per_row(256 * 4)
    cfg = resolve_blocks(op, (Q, R, 256), {}, CPU)
    assert plan_scan(Q, R, qstride, 4, H100_SMEM, H100_SMS, cfg["block_q"],
                     cfg["waves"]) == _fixed_rules(Q, R, 4, H100_SMEM,
                                                   H100_SMS)


@pytest.mark.parametrize("Q", [4, 8, 16, 32])
@pytest.mark.parametrize("bands,num_tiles", [(1, None), (2, 64), (2, 2)])
def test_no_table_banded_splits_as_before(Q, bands, num_tiles):
    """The banded launch with no table, written out from the scan's
    constants (csrc/hd_banded_scan.cuh): at 256 words a row and k = 4 one
    group of all Q <= 32 queries fits shared memory (two stage barriers,
    Q x 1 KB of queries, two stages of 32 rows of 260 words and their
    records, two buffers of 32 x 32 partial sums, the bands and the
    lists); the group's bank is
    split over waves x 132 blocks, no more than its live 32-row tiles:
    all the bank's, or four for each 128-row tile of the plan's budget for
    each band of each 8 queries."""
    R = 1_162_392
    cfg = resolve_blocks("topk_hamming_banded", (Q, R, 256), {}, CPU)
    need = 4 * (4 + Q * 256 + 2 * (32 * 260 + 4) + 2 * 32 * 32
                + 2 * bands * Q + 2 * Q * 4)
    assert need <= H100_SMEM
    tiles = -(-R // 32)
    if num_tiles is not None:
        tiles = min(tiles, -(-Q // 8) * bands * min(num_tiles, -(-R // 128))
                    * 4)
    want = BandedPlan(Q, 1, max(1, min(cfg["waves"] * H100_SMS, tiles)))
    assert plan_banded(Q, R, 256, 4, bands, num_tiles, H100_SMS,
                       cfg["waves"], H100_SMEM) == want


def test_a_table_entry_changes_the_launch():
    R = 1_162_392
    t = _mk_table()
    t.set_entry("topk_hamming", (32, R, 256), {"block_q": 16, "waves": 1})
    set_active_table(t)
    cfg = resolve_blocks("topk_hamming", (32, R, 256), {}, CPU)
    bq, rows, splits = plan_scan(32, R, 256, 4, H100_SMEM, H100_SMS,
                                 cfg["block_q"], cfg["waves"])
    assert bq == 16 and splits == 66    # 2 query blocks x 66 = 132 blocks


def test_an_explicit_block_that_does_not_fit_raises():
    # packed: 32 queries' lists of k = 380 do not fit beside the ring
    with pytest.raises(ValueError, match="block_q=32 needs"):
        plan_scan(32, 1000, 256, 380, H100_SMEM, H100_SMS, 32, 4)
    assert plan_scan(32, 1000, 256, 380, H100_SMEM, H100_SMS, AUTO,
                     4)[0] == 16
    # int8: 32 resident queries of 2048 words do not fit
    with pytest.raises(ValueError, match="block_q=32 needs"):
        plan_scan(32, 1000, 2048, 4, H100_SMEM, H100_SMS, 32, 4,
                  packed=False)
    assert plan_scan(32, 1000, 2048, 4, H100_SMEM, H100_SMS, AUTO, 4,
                     packed=False)[0] == 16


# --------------------------------------------------------------------------
# per-kernel explicit-knob validation (CPU tensors: checked, then ignored)
# --------------------------------------------------------------------------

def test_topk_hamming_rejects_misaligned_blocks():
    from repro_torch.kernels.topk_hamming import topk_hamming
    q, r = words(8, 2), words(128, 2)
    with pytest.raises(ValueError, match="block_q=7 must be one of"):
        topk_hamming(q, r, dim=64, k=4, block_q=7)
    with pytest.raises(ValueError, match="waves=0"):
        topk_hamming(q, r, dim=64, k=4, waves=0)
    with pytest.raises(ValueError, match="waves=-8"):
        topk_hamming(q, r, dim=64, k=4, waves=-8)


def test_topk_hamming_banded_rejects_misaligned_blocks():
    from repro_torch.kernels.topk_hamming import topk_hamming_banded
    q, r = words(8, 2), words(128, 2)
    starts = torch.zeros(8, dtype=torch.int32)
    lens = torch.full((8,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="topk_hamming_banded: waves=3.5"):
        topk_hamming_banded(q, r, starts, lens, dim=64, k=4, waves=3.5)


def test_encode_search_rejects_misaligned_blocks():
    from repro_torch.kernels.encode_search import (
        encode_search,
        encode_search_banded,
    )
    lv = torch.from_numpy(RNG.integers(0, 4, size=(8, 16)).astype(np.int32))
    id_hvs, level_hvs = bip((16, 64)), bip((4, 64))
    bank = words(128, 2)
    with pytest.raises(ValueError, match="block_q=5"):
        encode_search(lv, id_hvs, level_hvs, bank, dim=64, k=4, block_q=5)
    starts = torch.zeros(8, dtype=torch.int32)
    lens = torch.full((8,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="waves=0"):
        encode_search_banded(lv, id_hvs, level_hvs, bank, starts, lens,
                             dim=64, k=4, waves=0)


def test_hd_encode_rejects_misaligned_blocks():
    from repro_torch.kernels.hd_encode import hd_encode
    lv = torch.from_numpy(RNG.integers(0, 4, size=(8, 16)).astype(np.int32))
    with pytest.raises(ValueError, match="block_d=100"):
        hd_encode(lv, bip((16, 128)), bip((4, 128)), block_d=100)
    with pytest.raises(ValueError, match="block_b=0"):
        hd_encode(lv, bip((16, 128)), bip((4, 128)), block_b=0)


def test_imc_mvm_rejects_misaligned_blocks():
    from repro_torch.kernels.imc_mvm import imc_mvm
    q = torch.randn(8, 128)
    w = torch.randn(16, 128)
    with pytest.raises(ValueError, match="block_r=48"):
        imc_mvm(q, w, full_scale=128.0, block_r=48)
    with pytest.raises(ValueError, match="tile_cols=0"):
        imc_mvm(q, w, full_scale=128.0, tile_cols=0)


@pytest.mark.parametrize("op", ["topk_hamming", "encode_search",
                                "hd_encode", "imc_mvm"])
def test_knobs_do_not_change_the_cpu_result(op):
    """On the CPU the knobs are checked, then ignored: an explicit knob set
    and an active table give the default's result."""
    from repro_torch.tune.sweep import _candidates, _same_result, _workload
    shape, run = _workload(op, True, "cpu")
    want = run(DEFAULTS[op])
    t = _mk_table()
    t.set_entry(op, shape, _candidates(op, True)[-1])
    set_active_table(t)
    assert _same_result(want, run({}))
    assert _same_result(want, run(_candidates(op, True)[1]))


# --------------------------------------------------------------------------
# sweep + CLI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["imc_mvm", "hd_encode"])
def test_sweep_op_winner_never_slower(op):
    from repro_torch.tune.sweep import sweep_op
    res = sweep_op(op, quick=True, iters=2, device="cpu")
    assert res["us"] <= res["default_us"]
    assert res["blocks"].keys() == DEFAULTS[op].keys()
    assert not any("rejected" in c for c in res["candidates"])


@pytest.mark.parametrize("op", ["topk_hamming", "topk_hamming_banded",
                                "encode_search", "encode_search_banded",
                                "hd_encode", "imc_mvm"])
def test_candidates_hold_the_default_and_only_valid_knobs(op):
    from repro_torch.tune.sweep import _candidates
    for quick in (True, False):
        cands = _candidates(op, quick)
        assert DEFAULTS[op] in cands
        assert all(block_aligned(op, c) for c in cands)
        assert len({json.dumps(c, sort_keys=True) for c in cands}) == len(
            cands)


def test_a_winner_must_win_in_every_sample(monkeypatch):
    from repro_torch.tune import sweep
    default = sweep.DEFAULTS["imc_mvm"]
    cands = [c for c in sweep._candidates("imc_mvm", True) if c != default]
    # the default's samples, then each other candidate's, in grid order:
    # the first is faster in its median but not in every sample, the
    # second is faster in every sample by more than the margin
    seq = iter([[10e-6, 10.2e-6, 10.4e-6], [5e-6, 5e-6, 11e-6],
                [9.5e-6] * 3] + [[20e-6] * 3] * len(cands))
    monkeypatch.setattr(sweep, "burst_seconds",
                        lambda fn, dev, calls, iters: next(seq))
    res = sweep.sweep_op("imc_mvm", quick=True, iters=3, device="cpu")
    assert res["blocks"] == cands[1]
    assert res["us"] == pytest.approx(9.5)
    assert res["default_spread"] == pytest.approx(0.4 / 10.2)


def test_burst_seconds_times_each_burst_per_call():
    from repro_torch.tune.microbench import burst_seconds
    n = []
    samples = burst_seconds(lambda: n.append(1), CPU, calls=4, iters=3,
                            warmup=2)
    assert len(samples) == 3 and all(t >= 0 for t in samples)
    assert len(n) == 2 + 4 * 3


def test_sweep_rejects_a_candidate_that_changes_the_result(monkeypatch):
    from repro_torch.tune import sweep
    shape, run = sweep._workload("imc_mvm", True, "cpu")

    def wrong(blocks):
        out = run(blocks)
        return out + 1 if blocks.get("block_r") == 64 else out

    monkeypatch.setattr(sweep, "_workload", lambda op, q, d: (shape, wrong))
    res = sweep.sweep_op("imc_mvm", quick=True, iters=1, device="cpu")
    bad = [c for c in res["candidates"] if "rejected" in c]
    assert bad and all(c["blocks"]["block_r"] == 64 for c in bad)
    assert res["blocks"]["block_r"] != 64


def test_tune_cli_produces_usable_table(tmp_path, capsys):
    from repro_torch.launch.tune import main
    from repro_torch.tune.sweep import tuned_vs_default_ratio
    out = tmp_path / "table.json"
    table = main(["--out", str(out), "--quick", "--iters", "1",
                  "--ops", "imc_mvm,hd_encode", "--skip-ceilings",
                  "--device", "cpu"])
    assert out.exists()
    printed = capsys.readouterr().out
    assert "imc_mvm" in printed and "device_kind: cpu" in printed
    assert "worst tuned-vs-default ratio" in printed
    loaded = load_table(out)
    assert loaded is not None and loaded.device_kind == "cpu"
    assert set(loaded.ops) == {"imc_mvm", "hd_encode"}
    assert tuned_vs_default_ratio(table) >= 1.0


def test_tune_cli_rejects_unknown_ops(tmp_path):
    from repro_torch.launch.tune import main
    with pytest.raises(SystemExit):
        main(["--out", str(tmp_path / "t.json"), "--quick", "--ops",
              "decode_attention", "--device", "cpu"])


def test_build_tuning_table_records_ceilings(tmp_path):
    from repro_torch.tune.sweep import build_tuning_table
    assert active_profile(CPU) == HardwareProfile()
    table = build_tuning_table(tmp_path / "t.json", quick=True,
                               ops=("imc_mvm",), iters=1, device="cpu")
    assert table.ceilings["peak_flops_fp32"] > 0
    assert table.ceilings["hbm_bw"] > 0
    assert table.ceilings["matmul"] == "float32, TF32 off"
    set_active_table(table)
    prof = active_profile(CPU)
    assert prof.source == "measured"
    assert prof.peak_flops_fp32 == table.ceilings["peak_flops_fp32"]
    # one precision per field: the bf16 peak is never replaced
    assert prof.peak_flops == HardwareProfile().peak_flops
    assert prof.hbm_bw == table.ceilings["hbm_bw"]
    assert prof.link_bw == HardwareProfile().link_bw


def test_default_profile_is_the_h100_sxm():
    prof = HardwareProfile()
    assert (prof.peak_flops, prof.peak_flops_fp32, prof.hbm_bw,
            prof.link_bw) == (989e12, 67e12, 3.35e12, 450e9)
    assert prof.source == "default:h100-sxm"


@pytest.mark.parametrize("entries", [
    {},
    {"a": (10.0, 20.0)},
    {"a": (10.0, 10.0), "b": (30.0, 31.0)},
    {"a": (None, 5.0), "b": (4.0, 4.0)},
])
def test_ratio_matches_the_jax_package(entries):
    raw = {"schema": 1, "device_kind": "cpu", "ceilings": {}, "ops": {}}
    for i, (name, (us, dus)) in enumerate(entries.items()):
        raw["ops"].setdefault(["imc_mvm", "hd_encode"][i % 2], {})[
            f"{i}x8x8"] = {"blocks": {}, "us": us, "default_us": dus}
    from repro_torch.tune.sweep import tuned_vs_default_ratio
    port = TuningTable(device_kind="cpu", ops=raw["ops"])
    ref = jax_table.TuningTable(device_kind="cpu", ops=raw["ops"])
    assert tuned_vs_default_ratio(port) == jax_ratio(ref)

"""The port's dry-run cost model (``repro_torch.launch.roofline``,
``repro_torch.launch.dryrun``) against the JAX package's.

* ``model_flops_estimate`` equals the reference's, bit for bit, for every
  (arch, shape).
* ``RooflineReport``'s terms, bottleneck and ``mfu_bound`` equal the
  reference's ``roofline_from_compiled`` on the same counts (its HLO
  counters patched to return them), the link term at ``link_bw`` where
  the reference prices ``ici_bw``.
* ``exec_cost`` gives hand-counted FLOPs and bytes on a matmul and an
  MLP (CPU and ``meta`` tensors), and the FLOPs ``FlopCounterMode``
  counts on plain tensors.
* On a fake process group (in a subprocess: the group is process-global)
  ``collective_bytes`` equals a hand count of DTensor redistributions,
  and ``exec_cost`` counts a rank's share of a sharded product;
  ``run_cell`` traces ``qwen2_7b`` ``train_4k`` (batch and sequence cut)
  on small single- and multi-pod meshes (``PRODUCTION_SHAPES`` patched,
  as the reference's test patches its mesh), a decode cell with the int8
  KV store and a skipped cell, each writing the reference's keys; and the
  CLI runs the full-size ``qwen2_7b`` ``train_4k`` cell on 256 fake ranks.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.launch import roofline as JR
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import roofline as RF

REPO = Path(__file__).resolve().parent.parent
# the keys of the reference's ok cell (dryrun.run_cell)
REF_CELL_KEYS = {"arch", "shape", "mesh", "status", "chips", "variant",
                 "lower_s", "compile_s", "memory", "roofline"}
ROOFLINE_KEYS = {"flops", "hbm_bytes", "coll_bytes", "coll_breakdown",
                 "chips", "t_compute", "t_memory", "t_collective",
                 "bottleneck", "model_flops", "peak_flops", "profile_source",
                 "step_time_lower_bound", "mfu_bound"}


def test_the_ports_configs_and_shapes_are_the_references():
    assert list(ARCH_IDS) == list(JARCH_IDS)
    assert list(SHAPES) == list(JSHAPES)


@pytest.mark.parametrize("shape", list(JSHAPES))
@pytest.mark.parametrize("arch", list(JARCH_IDS))
def test_model_flops_estimate_equals_the_reference(arch, shape):
    got = RF.model_flops_estimate(get_config(arch), SHAPES[shape])
    want = JR.model_flops_estimate(jget_config(arch), JSHAPES[shape])
    assert got == want and type(got) is type(want)


COUNTS = [
    # flops, hbm bytes, collective bytes by kind, chips, model flops
    (1.2e15, 3.1e13, {"all-gather": 1.0e10, "reduce-scatter": 5.0e10},
     256, 4.4e16),
    (3.0e12, 9.9e11, {"all-reduce": 7.0e11}, 512, 1.0e14),
    (5.0e14, 1.0e12, {}, 8, 0.0),
]


@pytest.mark.parametrize("case", range(len(COUNTS)))
def test_roofline_report_equals_the_references_formulas(monkeypatch, case):
    flops, hbm, coll, chips, mf = COUNTS[case]
    full = {k: float(coll.get(k, 0.0)) for k in RF.COLLECTIVES}
    prof = RF.HardwareProfile()
    monkeypatch.setattr(JR, "exec_cost", lambda text: (flops, hbm))
    monkeypatch.setattr(JR, "collective_bytes", lambda text: dict(full))
    compiled = type("Compiled", (), {"as_text": lambda self: ""})()
    want = JR.roofline_from_compiled(
        compiled, chips, model_flops=mf,
        profile=JR.HardwareProfile(peak_flops=prof.peak_flops,
                                   hbm_bw=prof.hbm_bw, ici_bw=prof.link_bw,
                                   source=prof.source))
    got = RF.roofline_report(RF.TraceCost(flops=flops, hbm_bytes=hbm,
                                          coll=full), chips, mf, prof)
    assert got.to_dict() == want.to_dict()
    assert set(got.to_dict()) == ROOFLINE_KEYS


def test_profile_defaults_are_the_h100s():
    p = RF.active_profile()
    assert (p.peak_flops, p.hbm_bw, p.link_bw, p.source) == (
        989e12, 3.35e12, 450e9, "default:h100-sxm")


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exec_cost_counts_a_matmul(device, dtype):
    M, K, N = 48, 64, 40
    a = torch.zeros(M, K, dtype=dtype, device=device)
    b = torch.zeros(K, N, dtype=dtype, device=device)
    flops, nbytes = RF.exec_cost(torch.matmul, a, b)
    size = torch.finfo(dtype).bits // 8
    assert flops == 2 * M * K * N
    assert nbytes == size * (M * K + K * N + M * N)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_exec_cost_counts_an_mlp(device):
    B, D, H, O = 16, 32, 96, 8
    x = torch.zeros(B, D, device=device)
    w1 = torch.zeros(D, H, device=device)
    w2 = torch.zeros(H, O, device=device)

    def mlp(x, w1, w2):
        return torch.relu(x @ w1) @ w2

    flops, nbytes = RF.exec_cost(mlp, x, w1, w2)
    assert flops == 2 * B * D * H + 2 * B * H * O
    # each op's inputs and outputs once: mm, relu (in, out), mm
    assert nbytes == 4 * ((B * D + D * H + B * H) + 2 * B * H
                          + (B * H + H * O + B * O))
    assert RF.collective_bytes(mlp, x, w1, w2) == {
        k: 0.0 for k in RF.COLLECTIVES}


def test_exec_cost_flops_equal_flop_counter_mode_on_plain_tensors():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(16, 12, requires_grad=True)

    def step():
        y = torch.tanh(x @ w)
        loss = (y @ w.T).sum()
        loss.backward()
        return loss

    with FlopCounterMode(display=False) as fc:
        step()
    flops, _ = RF.exec_cost(step)
    assert flops == fc.get_total_flops() > 0


def test_views_and_allocations_move_no_bytes():
    x = torch.zeros(8, 8)

    def f(x):
        return x.view(64)[:10], x.t(), x.unsqueeze(0), x.detach()

    assert RF.exec_cost(lambda: torch.empty(100))[1] == 0
    assert RF.exec_cost(f, x) == (0, 0)


# ------------------------------------------- fake process groups (subprocess)

def _run(code: str, timeout: int = 240) -> dict:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    line = next(l for l in r.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def fake_mesh():
    """Hand-countable collectives and a sharded product on a (2, 2) fake
    mesh of 4 ranks."""
    return _run("""
        import json, torch, torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import (
            DTensor, Partial, Replicate, Shard, distribute_tensor)
        from repro_torch.launch import roofline as RF

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=4)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        x = torch.zeros(8, 6)
        out = {}
        sharded = distribute_tensor(x, mesh, [Shard(0), Replicate()])
        out["gather"] = RF.collective_bytes(
            lambda: sharded.redistribute(mesh, [Replicate(), Replicate()]))
        part = DTensor.from_local(x, mesh, [Replicate(), Partial()])
        out["reduce"] = RF.collective_bytes(
            lambda: part.redistribute(mesh, [Replicate(), Replicate()]))
        out["scatter"] = RF.collective_bytes(
            lambda: part.redistribute(mesh, [Replicate(), Shard(0)]))
        a = distribute_tensor(torch.zeros(64, 32, device="meta"), mesh,
                              [Shard(0), Replicate()])
        b = distribute_tensor(torch.zeros(32, 48, device="meta"), mesh,
                              [Replicate(), Shard(1)])
        out["product"] = RF.exec_cost(torch.matmul, a, b)
        t = torch.zeros(5)
        out["explicit"] = RF.collective_bytes(
            lambda: dist.all_reduce(t) or dist.all_gather(
                [torch.empty(5) for _ in range(4)], t))
        print("RESULT " + json.dumps(out))
    """)


def test_collective_bytes_of_an_all_gather(fake_mesh):
    # each rank's (4, 6) float32 block is the operand
    assert fake_mesh["gather"] == {**{k: 0.0 for k in RF.COLLECTIVES},
                                   "all-gather": 4 * 6 * 4}


def test_collective_bytes_of_an_all_reduce(fake_mesh):
    assert fake_mesh["reduce"] == {**{k: 0.0 for k in RF.COLLECTIVES},
                                   "all-reduce": 8 * 6 * 4}


def test_collective_bytes_of_a_reduce_scatter(fake_mesh):
    assert fake_mesh["scatter"] == {**{k: 0.0 for k in RF.COLLECTIVES},
                                    "reduce-scatter": 8 * 6 * 4}


def test_collective_bytes_of_explicit_collectives(fake_mesh):
    assert fake_mesh["explicit"] == {**{k: 0.0 for k in RF.COLLECTIVES},
                                     "all-reduce": 20, "all-gather": 20}


def test_exec_cost_counts_a_ranks_share_of_a_sharded_product(fake_mesh):
    flops, nbytes = fake_mesh["product"]
    # (32, 32) rows of a x (32, 24) columns of b on each rank: a quarter
    # of the global 2 * 64 * 32 * 48
    assert flops == 2 * 32 * 32 * 24 == 2 * 64 * 32 * 48 / 4
    assert nbytes == 4 * (32 * 32 + 32 * 24 + 32 * 24)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """``run_cell`` on small fake meshes (``PRODUCTION_SHAPES`` patched)."""
    out = tmp_path_factory.mktemp("dryrun")
    return _run(f"""
        import dataclasses, json
        from pathlib import Path
        import repro_torch.configs.shapes as shp
        import repro_torch.launch.mesh as M
        from repro_torch.launch import dryrun

        M.PRODUCTION_SHAPES = {{False: ((2, 4), ("data", "model")),
                               True: ((2, 2, 2), ("pod", "data", "model"))}}
        shp.SHAPES["train_4k"] = dataclasses.replace(
            shp.SHAPES["train_4k"], global_batch=8, seq_len=256)
        shp.SHAPES["decode_32k"] = dataclasses.replace(
            shp.SHAPES["decode_32k"], global_batch=8, seq_len=512)
        out = Path(r"{out}")
        res = {{
            "single": dryrun.run_cell("qwen2_7b", "train_4k", "single", out),
            "multi": dryrun.run_cell("qwen2_7b", "train_4k", "multi", out),
            "decode": dryrun.run_cell("qwen2_7b", "decode_32k", "single",
                                      out, kv_quant=True),
            "skipped": dryrun.run_cell("qwen2_7b", "long_500k", "single",
                                       out),
        }}
        res["files"] = sorted(p.name for p in out.iterdir())
        print("RESULT " + json.dumps(res))
    """)


@pytest.mark.parametrize("cell", ["single", "multi", "decode"])
def test_run_cell_traces_on_a_small_fake_mesh(cells, cell):
    got = cells[cell]
    assert got["status"] == "ok", got
    assert got["roofline"]["flops"] > 0 and got["roofline"]["hbm_bytes"] > 0
    assert got["chips"] == 8
    assert REF_CELL_KEYS <= set(got)
    assert set(got["roofline"]) == ROOFLINE_KEYS
    assert got["roofline"]["profile_source"] == "default:h100-sxm"
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] > 0
    assert mem["output_size_in_bytes"] > 0
    assert "temp_size_in_bytes" in mem["not_counted"]


def test_run_cell_collectives_follow_the_mesh(cells):
    # training over data splits the gradients: every mesh reduces; the
    # multi-pod mesh has (2, 2, 2) ranks and the batch over (pod, data)
    for cell in ("single", "multi"):
        assert cells[cell]["roofline"]["coll_bytes"] > 0
    assert cells["decode"]["variant"]["kv_quant"]


def test_run_cell_writes_the_references_files_and_skips(cells):
    assert cells["skipped"]["status"] == "skipped"
    assert cells["files"] == sorted([
        "qwen2_7b__train_4k__single.json", "qwen2_7b__train_4k__multi.json",
        "qwen2_7b__decode_32k__single.json",
        "qwen2_7b__long_500k__single.json"])


def test_the_cli_runs_the_full_size_cell_on_256_fake_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2_7b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(tmp_path)], capture_output=True, text=True, timeout=240,
        env=env, cwd=REPO)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    cell = json.loads((tmp_path / "qwen2_7b__train_4k__single.json")
                      .read_text())
    assert cell["status"] == "ok" and cell["chips"] == 256
    roof = cell["roofline"]
    assert roof["flops"] > 0 and roof["coll_bytes"] > 0
    # per rank: far below the job's model FLOPs
    assert roof["flops"] < roof["model_flops"]
    assert "[ok] qwen2_7b__train_4k__single" in r.stdout


# the decode_32k cells with and without --kv-seq-shard: each process
# traces one full-size cell on 256 fake ranks (a (16, 16) mesh: 8 rows a
# rank of decode_32k's 128)
KV_SEQ_ARCHS = ("granite_20b", "qwen2_7b")


@pytest.fixture(scope="module")
def kv_seq_cells(tmp_path_factory):
    """Every (arch, flag) decode_32k cell, the CLIs started at once."""
    out = tmp_path_factory.mktemp("kv_seq")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    runs = {(arch, flag): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "decode_32k", "--out", str(out)]
        + (["--kv-seq-shard", "--tag", "_kv_seq"] if flag else []),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for arch in KV_SEQ_ARCHS for flag in (False, True)}
    cells = {}
    for (arch, flag), p in runs.items():
        text, _ = p.communicate(timeout=240)
        assert p.returncode == 0, text[-3000:]
        assert f"[ok] {arch}__decode_32k__single" in text
        name = f"{arch}__decode_32k__single{'_kv_seq' if flag else ''}.json"
        cells[arch, flag] = json.loads((out / name).read_text())
    return cells


@pytest.mark.parametrize("arch", KV_SEQ_ARCHS)
def test_kv_seq_shard_cuts_the_decode_cache_by_the_model_axis(
        kv_seq_cells, arch):
    """The flag stripes each cache's 32,768 slots over the 16-way model
    axis: a rank's cache bytes are 1/16 of the cell without it (granite's
    1 kv head and qwen2_7b's 4, which model does not divide, are whole on
    every rank without it: 6.5 and 14 GiB in bfloat16)."""
    cfg = get_config(arch)
    plain, striped = (kv_seq_cells[arch, f] for f in (False, True))
    assert plain["status"] == striped["status"] == "ok"
    rows = SHAPES["decode_32k"].global_batch // 16
    whole = (cfg.num_layers * rows * 32_768 * cfg.num_kv_heads
             * cfg.resolved_head_dim * 2 * 2)
    assert whole == {"granite_20b": 6.5, "qwen2_7b": 14}[arch] * 2**30
    assert plain["memory"]["cache_size_in_bytes"] == whole
    assert striped["memory"]["cache_size_in_bytes"] == whole // 16


@pytest.mark.parametrize("arch", KV_SEQ_ARCHS)
def test_kv_seq_shard_counts_the_gather_and_the_combine(kv_seq_cells,
                                                        arch):
    """A step's collectives gain, a layer: the combine's two all-reduces
    over a rank's rows and every query head (the log-sum-exp's MAX, then
    the SUM of the weighted output and its weight: hd + 2 floats a
    head), and the gather of the bfloat16 query heads where model splits
    them (granite's 48 over 16; qwen2_7b's 28 are whole on every rank;
    both models' kv heads are)."""
    cfg = get_config(arch)
    plain, striped = (kv_seq_cells[arch, f]["roofline"]["coll_breakdown"]
                      for f in (False, True))
    rows = SHAPES["decode_32k"].global_batch // 16
    h, hd = cfg.num_heads, cfg.resolved_head_dim
    combine = cfg.num_layers * rows * h * (hd + 2) * 4
    assert striped["all-reduce"] - plain["all-reduce"] == combine
    heads = h // 16 if h % 16 == 0 else 0
    assert (striped["all-gather"] - plain["all-gather"]
            == cfg.num_layers * rows * heads * hd * 2)


# ------------------------------------------------- dryrun's axes (no group)

@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dryrun module, imported with its XLA_FLAGS line
    undone at once (it sets them for a process of its own; here JAX is
    already live, and subprocesses must not inherit 512 host devices)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdr
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jdr


def _axes_leaves(tree) -> set:
    """The logical-axes tuples of an axes tree (the port's dataclasses,
    tuples and lists), as a set."""
    import dataclasses

    if isinstance(tree, tuple) and all(isinstance(e, (str, type(None)))
                                       for e in tree):
        return {tree}
    if dataclasses.is_dataclass(tree):
        return set().union(*(_axes_leaves(getattr(tree, f.name))
                             for f in dataclasses.fields(tree)))
    return set().union(*(_axes_leaves(e) for e in tree))


@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("arch", list(JARCH_IDS))
def test_cache_axes_for_matches_the_references(jdryrun, arch, kv_quant):
    """Every cache leaf's logical axes are the reference's, less its
    stacked-layer dim (the port's layers are not stacked)."""
    import dataclasses

    import jax
    from jax.tree_util import tree_leaves as jleaves

    from repro.models.model_zoo import build_model as jbuild
    from repro_torch.launch import dryrun
    from repro_torch.models.model_zoo import build_model

    cfg = dataclasses.replace(get_config(arch).reduced(),
                              kv_quant_int8=kv_quant)
    jcfg = dataclasses.replace(jget_config(arch).reduced(),
                               kv_quant_int8=kv_quant)
    cache = build_model(cfg, "meta").init_cache(2, 16)
    got = _axes_leaves(dryrun.cache_axes_for(cfg, cache))
    jcache = jax.eval_shape(lambda: jbuild(jcfg).init_cache(2, 16))
    want = {tuple(a for a in axes if a != "layer") for axes in jleaves(
        jdryrun.cache_axes_for(jcfg, jcache), is_leaf=jdryrun._leaf_axes)}
    assert got == want


@pytest.mark.parametrize("arch", KV_SEQ_ARCHS)
def test_cache_axes_under_kv_seq_are_the_references(jdryrun, arch):
    """Under ``kv_seq="model"`` on the (16, 16) mesh, every cache leaf's
    axes, and the spec they resolve to, are the reference's
    ``cache_axes_for``'s (less its stacked-layer dim)."""
    import dataclasses
    import types

    import jax
    from jax.tree_util import tree_leaves as jleaves

    from repro.dist import sharding as JSH
    from repro.models.model_zoo import build_model as jbuild
    from repro_torch.dist import sharding as SH
    from repro_torch.launch import dryrun
    from repro_torch.models.model_zoo import build_model

    sizes = {"data": 16, "model": 16}
    cfg = dataclasses.replace(get_config(arch), kv_quant_int8=True)
    jcfg = dataclasses.replace(jget_config(arch), kv_quant_int8=True,
                               num_layers=2)
    cache = build_model(cfg, "meta").init_cache(128, 32_768)
    jcache = jax.eval_shape(lambda: jbuild(jcfg).init_cache(128, 32_768))
    jaxes = jleaves(jdryrun.cache_axes_for(jcfg, jcache),
                    is_leaf=jdryrun._leaf_axes)
    rules = JSH.ShardingRules().replace(kv_seq="model")
    want = {(tuple(a for a in axes if a != "layer"), tuple(
        JSH.logical_to_spec(axes, leaf.shape, types.SimpleNamespace(
            shape=sizes), rules))[1:]) for axes, leaf in zip(
                jaxes, jleaves(jcache), strict=True)}
    with SH.rules_override(kv_seq="model"):
        got = set()
        for entry in cache[:1]:
            for f in dataclasses.fields(entry):
                axes = getattr(dryrun.cache_axes_for(cfg, entry), f.name)
                got.add((axes, SH.logical_to_spec(
                    axes, getattr(entry, f.name).shape, sizes)))
    assert got == want
    assert all(spec[1] == "model" and spec[2] is None for _, spec in got)


def test_batch_axes_and_shardings_of_place_the_batch():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import dryrun

    specs = {"tokens": torch.empty((8, 16), dtype=torch.int32,
                                   device="meta"),
             "patches": torch.empty((8, 2, 32), device="meta")}
    axes = dryrun.batch_axes_for(None, specs)
    assert axes == {"tokens": ("batch", None),
                    "patches": ("batch", None, None)}
    got = dryrun.shardings_of(axes, specs, {"data": 2, "model": 2})
    assert got == {"tokens": (Shard(0), Replicate()),
                   "patches": (Shard(0), Replicate())}

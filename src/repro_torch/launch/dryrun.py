"""Multi-pod dry run: trace one step of every (arch x shape) cell on the
production meshes, proving the distribution config is coherent, and
record per-rank memory, cost and collective counts for the roofline
table. The counterpart of ``repro.launch.dryrun``.

Runs as a process of its own, on the CPU: it starts a ``fake`` process
group (``torch.testing._internal.distributed.fake_pg.FakeStore``) of 256
ranks (``--mesh single``) or 512 (``multi``), in which this process is
rank 0 and every collective returns at once, so the port's
``make_production_mesh`` builds on one host. The group is process-global:
do not run this module inside a process that serves or trains.

Each cell builds the model on ``meta`` tensors (nothing is allocated),
places it with the port's ``logical_to_sharding`` (parameters, optimizer
state and batch as DTensors; the caches as each rank's block, as the
port builds them) and traces one train, prefill or decode step under
:func:`repro_torch.launch.roofline.trace_cost`. The counts are **per
rank** (rank 0's local ops, below DTensor: a sharded product counts
this rank's share, replicated work counts in full); FLOPs counted above
DTensor would be the global product's. A kernel whose CUDA path has no
``meta`` implementation (``decode_attention`` with ``--kv-quant``) runs
its plain version, as on the CPU.

The cell JSON has the reference's keys and ``status`` values (``ok``,
``skipped``, ``fail``) and the same ``roofline`` keys, priced on the
port's :class:`~repro_torch.launch.roofline.HardwareProfile` (link term
at ``link_bw``; ``profile_source`` is ``default:h100-sxm`` or
``measured``). Every time in it is a bound, not a measurement. ``memory``
holds each rank's argument and output bytes from the local shard shapes
and lists what the port cannot count; ``cache_size_in_bytes`` is the
rank's share of the caches among its arguments (0 for a train cell).
``--kv-seq-shard`` stripes the caches' sequence over ``model``
(``rules.replace(kv_seq="model")``, as the reference's flag does): each
rank's cache is its block of slots (``layers.kv_block``), and a decode
cell counts the query heads' gather and the blocks' combine
(``layers.attention_decode``) among its collectives.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_7b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
      --out artifacts/dryrun_torch
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.shapes import applicable
from repro_torch.dist import sharding as SH
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.roofline import (
    active_profile,
    model_flops_estimate,
    roofline_from_trace,
)
from repro_torch.models import layers as L
from repro_torch.models import recurrent as R
from repro_torch.models import transformer as T
from repro_torch.models.model_zoo import build_model
from repro_torch.train.serve_step import make_decode_step, make_prefill
from repro_torch.train.train_step import (
    TrainConfig,
    abstract_train_state,
    make_train_step,
    state_axes,
)

# what a traced eager step cannot count, listed in each cell's memory
NOT_COUNTED = {
    "temp_size_in_bytes": "activations and temporaries: an eager step on "
                          "meta tensors allocates nothing, and no compiler "
                          "plans its buffers",
    "generated_code_size_in_bytes": "no code is generated",
    "alias_size_in_bytes": "no buffer is donated",
}


def batch_axes_for(cfg, specs: dict) -> dict:
    """Each input's logical axes: its leading dim is the batch."""
    return {k: ("batch",) + (None,) * (v.ndim - 1) for k, v in specs.items()}


def cache_axes_for(cfg, cache):
    """Logical axes of the port's cache (a list of per-layer entries; the
    layers are not stacked), by entry type, as the reference's
    ``cache_axes_for``: K / V and their scales, the recurrent states
    (``recurrent.*_STATE_AXES``) and a decoder's cross K / V."""
    kv, scale = L.CACHE_AXES, L.CACHE_SCALE_AXES

    def node_axes(node):
        if isinstance(node, L.QuantKVCache):
            return L.QuantKVCache(k=kv, v=kv, k_scale=scale, v_scale=scale)
        if isinstance(node, L.KVCache):
            return L.KVCache(k=kv, v=kv)
        if isinstance(node, R.MambaState):
            return R.MambaState(h=R.MAMBA_STATE_AXES)
        if isinstance(node, R.MLSTMState):
            return R.MLSTMState(C=R.MLSTM_C_AXES, n=R.MLSTM_N_AXES)
        if isinstance(node, R.SLSTMState):
            return R.SLSTMState(c=R.SLSTM_STATE_AXES, n=R.SLSTM_STATE_AXES)
        if isinstance(node, T.CrossKV):
            return T.CrossKV(k=L.KV_AXES, v=L.KV_AXES)
        if isinstance(node, tuple):
            return tuple(node_axes(e) for e in node)
        if isinstance(node, list):
            return [node_axes(e) for e in node]
        raise TypeError(f"not a cache entry: {type(node).__name__}")

    return node_axes(cache)


def shardings_of(axes_tree, shapes_tree, mesh):
    """Each leaf's DTensor placements by ``logical_to_sharding``."""
    return SH.tree_shardings(axes_tree, shapes_tree, mesh)


def input_specs(model, shape) -> dict:
    """The step's inputs on ``meta`` (the reference's
    ``Model.input_specs``): train / prefill batches by family, a prefill's
    and decode's cache (this rank's blocks: its rows, kv heads and, under
    ``kv_seq``, its block of slots), a decode's token and position (the
    cache's last)."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    dt = L._dtype(cfg)

    def tok(b, s):
        return torch.empty((b, s), dtype=torch.int32, device="meta")

    def batch():
        if cfg.family == "vlm":
            p_len = S // cfg.vision_fraction
            return {"patches": torch.empty((B, p_len, cfg.d_model), dtype=dt,
                                           device="meta"),
                    "tokens": tok(B, S - p_len)}
        if cfg.is_encoder_decoder:
            return {"frames": torch.empty((B, S // 2, cfg.d_model), dtype=dt,
                                          device="meta"),
                    "tokens": tok(B, S // 2)}
        return {"tokens": tok(B, S)}

    if shape.kind == "train":
        return batch()
    # an encoder-decoder decodes S // 2 tokens (the rest are frames)
    cache_len = S // 2 if cfg.is_encoder_decoder else S
    cache = model.init_cache(B, cache_len)
    if shape.kind == "prefill":
        return {"batch": batch(), "cache": cache}
    if cfg.is_encoder_decoder:
        # a decode follows a prefill that stored each decoder layer's cross
        # K / V of the S // 2 encoded frames (the reference's cache holds
        # them from the start)
        cache = [(kv, T.CrossKV(*(torch.empty(
            (x.shape[0], cache_len) + tuple(x.shape[2:]), dtype=x.dtype,
            device="meta") for x in (xkv.k, xkv.v)))) for kv, xkv in cache]
    return {"token": tok(B, 1), "cache": cache, "pos": cache_len - 1}


def _local_bytes(tree) -> int:
    """Bytes of this rank's blocks of every tensor leaf of ``tree``."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    if isinstance(tree, torch.Tensor):
        t = SH.local_value(tree)
        return t.numel() * t.element_size()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(_local_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


def fake_group(world: int) -> None:
    """This process as rank 0 of a ``fake`` group of ``world`` ranks (an
    existing group of another size is replaced)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def production_mesh(mesh_kind: str):
    """``make_production_mesh`` over a fake group of its size."""
    multi = mesh_kind == "multi"
    shape, _ = mesh_mod.PRODUCTION_SHAPES[multi]
    world = 1
    for s in shape:
        world *= s
    fake_group(world)
    return mesh_mod.make_production_mesh(multi_pod=multi, device_type="cpu")


def _write(out_dir: Path, tag: str, result: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             remat: str = "full", rules=None, cast_params: bool = False,
             kv_quant: bool = False, tag_suffix: str = "") -> dict:
    cfg = get_config(arch)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant_int8=True)
    shape = SHAPES[shape_name]
    if not applicable(cfg.family, shape_name, cfg.supports_long_decode):
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                  "status": "skipped",
                  "reason": "long_500k requires sub-quadratic decode "
                            "(DESIGN.md §4); this arch is pure full-attention"}
        _write(out_dir, f"{arch}__{shape_name}__{mesh_kind}", result)
        return result
    mesh = production_mesh(mesh_kind)
    chips = mesh.mesh.numel()
    SH.set_mesh(mesh, rules)
    try:
        t0 = time.time()
        model = build_model(cfg, "meta", mesh=mesh)
        specs = input_specs(model, shape)
        if shape.kind == "train":
            tcfg = TrainConfig(remat=remat, cast_params_bf16=cast_params)
            state, axes = abstract_train_state(model, tcfg)
            state = SH.distribute_tree(state, state_axes(axes, tcfg), mesh)
            batch = SH.distribute_tree(specs, batch_axes_for(cfg, specs),
                                       mesh)
            fn, args = make_train_step(model, tcfg, mesh), (state, batch)
        else:
            params = T.init_lm(cfg, "meta", None, mesh=mesh)
            cache = specs["cache"]
            if shape.kind == "prefill":
                bspecs = specs["batch"]
                batch = SH.distribute_tree(
                    bspecs, batch_axes_for(cfg, bspecs), mesh)
                fn, args = make_prefill(model), (params, batch, cache)
            else:
                tok = SH.place(specs["token"], ("batch", None), mesh)
                fn = make_decode_step(model)
                args = (params, tok, cache, specs["pos"])
        t_lower = time.time() - t0
        arg_bytes = _local_bytes(args)
        cache_bytes = _local_bytes(specs.get("cache"))
        prof = active_profile()
        t0 = time.time()
        roof, out = roofline_from_trace(
            fn, *args, chips=chips,
            model_flops=model_flops_estimate(cfg, shape), profile=prof)
        t_trace = time.time() - t0
    finally:
        SH.set_mesh(None)

    mem = {"argument_size_in_bytes": arg_bytes,
           "cache_size_in_bytes": cache_bytes,
           "output_size_in_bytes": _local_bytes(out),
           "not_counted": NOT_COUNTED}
    print("memory (per rank):", {k: v for k, v in mem.items()
                                 if k != "not_counted"})
    print("cost (per rank): flops=%.3e bytes=%.3e coll=%.3e (ceilings: %s; "
          "bounds, not measurements)"
          % (roof.flops, roof.hbm_bytes, roof.coll_bytes, prof.source))
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "status": "ok", "chips": chips,
        "variant": {"cast_params": cast_params, "kv_quant": kv_quant,
                    "remat": remat},
        "lower_s": round(t_lower, 2), "compile_s": None,
        "trace_s": round(t_trace, 2),
        "memory": mem,
        "roofline": roof.to_dict(),
    }
    _write(out_dir, f"{arch}__{shape_name}__{mesh_kind}{tag_suffix}",
           result)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--cast-params", action="store_true",
                    help="bf16 cast before the forward (perf variant)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (perf variant)")
    ap.add_argument("--kv-seq-shard", action="store_true",
                    help="stripe KV cache seq axis over the model axis")
    ap.add_argument("--rules", default="default",
                    help="sharding rule preset (default | fsdp_only)")
    ap.add_argument("--tag", default="", help="artifact filename suffix")
    args = ap.parse_args(argv)

    rules = SH.RULE_PRESETS[args.rules]
    if args.kv_seq_shard:
        rules = rules.replace(kv_seq="model")

    out = Path(args.out)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(a, s, m) for a in archs for s in shapes for m in meshes]

    failures = 0
    for a, s, m in cells:
        tag = f"{a}__{s}__{m}"
        if args.skip_existing and (out / f"{tag}.json").exists():
            print(f"[skip-existing] {tag}")
            continue
        print(f"=== {tag} ===", flush=True)
        try:
            r = run_cell(a, s, m, out, remat=args.remat, rules=rules,
                         cast_params=args.cast_params,
                         kv_quant=args.kv_quant, tag_suffix=args.tag)
            print(f"[{r['status']}] {tag} "
                  + (f"trace={r.get('trace_s')}s "
                     f"bottleneck={r['roofline']['bottleneck']}"
                     if r["status"] == "ok" else r.get("reason", "")),
                  flush=True)
        except Exception:
            failures += 1
            err = traceback.format_exc()
            print(f"[FAIL] {tag}\n{err}", flush=True)
            _write(out, tag, {"arch": a, "shape": s, "mesh": m,
                              "status": "fail",
                              "error": err.splitlines()[-1]})
    print(f"done: {len(cells)} cells, {failures} failures")
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()

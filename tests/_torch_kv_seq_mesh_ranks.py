"""Rank workers for the KV cache striped over ``kv_seq``
(``tests/test_torch_kv_seq_mesh.py``).

It imports only ``torch``, numpy and ``repro_torch``: the tests start each
rank with the ``spawn`` method, and a child imports this module afresh,
so it must not pull in JAX. Each rank joins a gloo group through a
``file://`` store, runs one intra-op thread, builds each ``(data, model)``
mesh of its world size over the group, serves every case on it and
writes what it computed (whole logits and its own cache blocks, numpy)
to ``<out>/rank<r>.pkl``; a failure writes its traceback to
``<out>/rank<r>.err`` first. The parameters (the reference's, as numpy)
come from the test process.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import pickle
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data.tokens import TokenPipeline
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model

MESHES = {2: ((1, 2),), 4: ((1, 4), (2, 2))}
NAMES = ("data", "model")
# reduced granite_20b (MQA: 1 kv head, which no model axis divides),
# reduced qwen2_7b (GQA: 4 heads over 2 kv heads) and reduced hymba_1_5b
# (its attention in a 16-slot sliding-window ring)
CONFIGS = {"granite": "granite_20b", "qwen": "qwen2_7b",
           "hymba": "hymba_1_5b"}
SERVE_B = 4
# the dense prompt and decode: 20 slots, 10 or 5 a rank on model = 2 or
# 4, so the decode steps (positions 11..18) write into the second and
# later blocks, a valid length meets a block's edge (15 at position 14)
# and the last block is empty until position 15
PROMPTS = {"granite": 11, "qwen": 11, "hymba": 32}
GEN = 9
# Hymba's prompt of two whole windows (the reference's ring is aligned),
# its decode past the wrap (slots 0..7); a 20-position prompt shifts the
# ring by 4 (held against one process of the port)
RING_PROMPT = 20
# a cache of 19 slots (prime): no model axis divides it, and kv_seq falls
# back to the placement without it
FALLBACK = ("qwen", 11, 8)
KV_SEQ = SH.DEFAULT_RULES.replace(kv_seq="model")
# the other families with the int8 cache, held against one process of the
# port (their own seeded draw): (arch, pipeline length, generated tokens),
# each cache 16 slots: the MoE's 8-token prompt (a batch of 4 x 8 is one
# 32-token group), Whisper's 12 decoder tokens (beside 12 frames) and
# InternVL2's 1 patch and 11 tokens
FAMILIES = {"moe": ("deepseek_moe_16b", 8, 8), "encdec": ("whisper_medium",
                                                          24, 4),
            "vlm": ("internvl2_76b", 12, 4)}
# the meshes they run on (the time limit: (2, 2) adds no case of its own)
FAMILY_MESHES = ((1, 2), (1, 4))


def cfg_of(name: str, **kw):
    return dataclasses.replace(get_config(CONFIGS[name]).reduced(), **kw)


def prompt_tokens(vocab: int, prompt: int) -> np.ndarray:
    return TokenPipeline(SERVE_B, prompt, vocab).get(3, "cpu")[
        "tokens"].numpy()


def forced_tokens(vocab: int, prompt: int, gen: int = GEN) -> np.ndarray:
    """The (SERVE_B, gen - 1) tokens forced into the decode steps."""
    rng = np.random.default_rng(prompt)
    return rng.integers(0, vocab, size=(SERVE_B, gen - 1)).astype(np.int32)


def attention_cache(entry):
    """A layer's KV cache (a hybrid's entry holds its Mamba state too)."""
    return entry[0] if isinstance(entry, tuple) else entry


def cache_block(cache) -> dict:
    """The rank's block of a KV cache: its tensors (numpy) and where it
    lies."""
    out = {f.name: getattr(cache, f.name).detach().numpy().copy()
           for f in dataclasses.fields(cache)}
    blk = cache.seq_block
    out["seq_block"] = None if blk is None else tuple(blk)
    return out


def serve(params: dict, name: str, kv_quant: bool, prompt: int,
          gen: int = GEN, mesh=None) -> dict:
    """Prefill and gen - 1 forced decode steps on the installed mesh and
    rules: every step's whole logits, each layer's cache block, this
    rank's rows and the gloo collectives issued."""
    cfg = cfg_of(name, kv_quant_int8=kv_quant)
    model = build_model(cfg, "cpu", mesh)
    lm = lm_params_from_numpy(params[name], cfg, "cpu", mesh=mesh)
    before = sum(SH.GLOO_COLLECTIVES.values())
    cache = model.init_cache(SERVE_B, prompt + gen)
    tokens = torch.from_numpy(prompt_tokens(cfg.vocab_size, prompt))
    with torch.no_grad():
        logits, cache = model.prefill(lm, {"tokens": tokens}, cache)
        steps = [SH.full_value(logits).numpy().copy()]
        forced = torch.from_numpy(forced_tokens(cfg.vocab_size, prompt, gen))
        for i in range(gen - 1):
            logits, cache = model.decode_step(lm, forced[:, i:i + 1], cache,
                                              prompt + i)
            steps.append(SH.full_value(logits).numpy().copy())
    return {"logits": steps,
            "blocks": [cache_block(attention_cache(e)) for e in cache],
            "rows": SH.local_range(L.Q_AXES, (SERVE_B, 1, cfg.num_heads,
                                              cfg.resolved_head_dim), 0,
                                   mesh),
            "collectives": sum(SH.GLOO_COLLECTIVES.values()) - before}


def family_serve(name: str, mesh=None) -> dict:
    """A FAMILIES config's prefill and forced decode steps with the int8
    cache: every step's whole logits and each self-attention cache's
    ``seq_block``."""
    arch, seq, gen = FAMILIES[name]
    cfg = dataclasses.replace(get_config(arch).reduced(), kv_quant_int8=True)
    model = build_model(cfg, "cpu", mesh)
    lm = model.init(seed=0)
    batch = TokenPipeline(SERVE_B, seq, cfg.vocab_size).get_for(cfg, 0,
                                                                "cpu")
    prompt = seq // 2 if cfg.is_encoder_decoder else seq
    cache = model.init_cache(SERVE_B, prompt + gen)
    with torch.no_grad():
        logits, cache = model.prefill(lm, batch, cache)
        steps = [SH.full_value(logits).numpy().copy()]
        forced = torch.from_numpy(forced_tokens(cfg.vocab_size, seq, gen))
        for i in range(gen - 1):
            logits, cache = model.decode_step(lm, forced[:, i:i + 1], cache,
                                              prompt + i)
            steps.append(SH.full_value(logits).numpy().copy())
    blocks = [attention_cache(e).seq_block for e in cache]
    return {"logits": steps,
            "seq_blocks": [None if b is None else tuple(b) for b in blocks]}


def run_mesh(mesh, params: dict) -> dict:
    """Every case on ``mesh``: each config with the int8 and the float
    cache under ``kv_seq`` on ``model``, Hymba's shifted ring, the other
    families, and the fallback length with and without ``kv_seq``."""
    res = {}
    SH.set_mesh(mesh, KV_SEQ)
    for name in CONFIGS:
        for kv in (False, True):
            res[name, kv] = serve(params, name, kv, PROMPTS[name],
                                  mesh=mesh)
    res["ring"] = serve(params, "hymba", True, RING_PROMPT, mesh=mesh)
    if tuple(mesh.mesh.shape) in FAMILY_MESHES:
        for name in FAMILIES:
            res[name] = family_serve(name, mesh)
    name, prompt, gen = FALLBACK
    for rules in ("kv_seq", "default"):
        SH.set_mesh(mesh, KV_SEQ if rules == "kv_seq" else None)
        res["fallback", rules] = serve(params, name, True, prompt, gen,
                                       mesh=mesh)
    return res


def worker(rank: int, world: int, store: str, out: str, params: dict
           ) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    out_dir = Path(out)
    t0 = time.perf_counter()
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            res = {}
            for shape in MESHES[world]:
                mesh = init_device_mesh("cpu", shape, mesh_dim_names=NAMES)
                res[shape] = run_mesh(mesh, params)
                SH.set_mesh(None)
            res["seconds"] = time.perf_counter() - t0
        finally:
            SH.set_mesh(None)
            dist.destroy_process_group()
        (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(res))
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def start(world: int, out: Path, params: dict) -> list:
    """``world`` ranks of ``worker``, spawned and left running."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=worker,
                         args=(r, world, str(out / "store"), str(out),
                               params))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs

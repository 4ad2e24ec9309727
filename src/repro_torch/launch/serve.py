"""Batched LM serving launcher (``repro.launch.serve``): prefill + decode
loop with a KV cache, on one device or over a device mesh.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_7b \
      --reduced --device cpu --kv-quant --batch 2 --prompt-len 16 --gen 4

The flags are the reference's (``--arch --reduced --batch --prompt-len
--gen --temperature``) plus ``--device`` (default ``cuda``; asking for it
without a card raises) and ``--kv-quant``, the reference's own switch for
the int8 KV store (``kv_quant_int8``, as its dry run sets it), whose decode
attention runs the ``decode_attention`` kernel on the card. Parameters are
the port's own seeded draw (seed 0), prompts the synthetic token pipeline
(step 0; ``get_for``: a VLM's prompt is its patches then its tokens, an
encoder-decoder's its frames and its decoder tokens, half of
``--prompt-len`` each). The decode starts after the prompt's positions
(the VLM's patches and tokens; the decoder's tokens) and the cache holds
the prompt and ``--gen`` more, as the reference's launcher sizes it. The
decode loop reads nothing back from the card: the greedy (or
Gumbel-sampled) token stays on the device and the position is a Python
int. On the card, prefill and every decode step are timed with
CUDA events; on the CPU with the host clock.

Over a mesh (``torchrun``, as the training launcher joins it) the run
serves on ``make_debug_mesh()``, as the reference does: the parameters
placed by ``param_axes``, the prompt by its batch dim, each rank's KV
cache holding its block; rank 0 alone prints, every rank returns the
same generated ids; every family runs over more than one rank (the
recurrent states, as the KV cache, hold the rank's block). It prints the
reference's ``mesh: {...} devices=N`` line.

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch qwen2_7b --reduced --device cpu --kv-quant
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as SH
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.launch.mesh import join_group, make_debug_mesh, mesh_line
from repro_torch.models.model_zoo import Model, build_model
from repro_torch.train.serve_step import make_decode_step, make_prefill

SAMPLE_SEED = 1


@dataclasses.dataclass
class ServeRun:
    """What one serving run produced and how long it took."""
    model: Model
    params: torch.nn.Module
    batch: dict                 # the prompt, as get_for makes it
    start: int                  # position of the first decoded token
    cache_len: int              # positions the KV cache holds
    tokens: torch.Tensor        # (B, gen) generated ids (whole, each rank)
    prefill_s: float
    step_ms: list[float]        # one per decode step
    decode_s: float
    clock: str                  # "cuda events" or "host"
    peak_bytes: int | None      # CUDA max_memory_allocated, None on the CPU
    launches: int               # decode_attention launches in the run
    logits: list | None = None  # per decode step (B, 1, V), when kept
    #                             (whole values on a mesh)

    @property
    def decode_tokens_per_s(self) -> float:
        steps = len(self.step_ms)
        return self.tokens.shape[0] * steps / self.decode_s if steps else 0.0

    def step_percentile_ms(self, q: float) -> float:
        return float(torch.quantile(torch.tensor(self.step_ms,
                                                 dtype=torch.float64), q))


class _Clock:
    """CUDA events on the card (recorded without a sync), the host clock
    on the CPU; ``intervals_s()`` synchronizes once at the end."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_s(self) -> list[float]:
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3
                    for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def prompt_positions(cfg, batch: dict) -> tuple[int, int]:
    """(the first decode position, the prompt's length) of a batch: a
    VLM's patches and tokens both; an encoder-decoder's decoder tokens,
    and its frames and tokens; else its tokens."""
    n = batch["tokens"].shape[1]
    if cfg.family == "vlm":
        n += batch["patches"].shape[1]
        return n, n
    if cfg.is_encoder_decoder:
        return n, batch["frames"].shape[1] + n
    return n, n


@SH.in_mesh_context
def generate(model: Model, params, batch: dict, gen: int,
             temperature: float = 0.0, keep_logits: bool = False
             ) -> ServeRun:
    """Prefill ``batch`` then decode ``gen - 1`` tokens, as the reference's
    launcher does (a cache of the prompt's length + ``gen`` positions);
    returns the tokens and the timings. On a mesh the tokens stay
    DTensors through the loop (the sampler's draws, the same on every
    rank, are taken as replicated)."""
    dev = model.device
    B = batch["tokens"].shape[0]
    start, prompt = prompt_positions(model.cfg, batch)
    cache = model.init_cache(B, prompt + gen)
    prefill = make_prefill(model)
    decode = make_decode_step(model)
    sampler = torch.Generator(device=dev).manual_seed(SAMPLE_SEED)

    def pick(logits):
        if temperature > 0:   # Gumbel-max: jax.random.categorical's method
            u = torch.rand(logits.shape, generator=sampler, device=dev)
            logits = logits / temperature - torch.log(-torch.log(u))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    launches0 = decode_attention.launches
    pre = _Clock(dev)
    pre.mark()
    logits, cache = prefill(params, batch, cache)
    tok = pick(logits)
    pre.mark()
    out_tokens, kept = [tok], [] if keep_logits else None
    steps = _Clock(dev)
    steps.mark()
    for i in range(gen - 1):
        logits, cache = decode(params, tok, cache, start + i)
        tok = pick(logits)
        out_tokens.append(tok)
        if keep_logits:
            kept.append(SH.full_value(logits))
        steps.mark()
    step_s = steps.intervals_s()
    prefill_s = pre.intervals_s()[0]
    return ServeRun(
        model=model, params=params, batch=batch, start=start,
        cache_len=prompt + gen,
        tokens=SH.full_value(torch.cat(out_tokens, dim=1)),
        prefill_s=prefill_s,
        step_ms=[1e3 * s for s in step_s], decode_s=sum(step_s),
        clock="cuda events" if dev.type == "cuda" else "host",
        peak_bytes=(torch.cuda.max_memory_allocated(dev)
                    if dev.type == "cuda" else None),
        launches=decode_attention.launches - launches0, logits=kept)


def main(argv=None, keep_logits: bool = False) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV store (decode attention on the "
                         "decode_attention kernel)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    own_group = join_group(device)
    try:
        # rank 0 alone reports
        quiet = dist.is_initialized() and dist.get_rank() > 0
        with (contextlib.redirect_stdout(io.StringIO()) if quiet
              else contextlib.nullcontext()):
            return _serve(args, device, keep_logits)
    finally:
        if own_group:
            dist.destroy_process_group()


def _serve(args, device, keep_logits: bool) -> ServeRun:
    """The launcher's run on this rank."""
    mesh = make_debug_mesh(device_type=device.type)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant_int8=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        if cfg.kv_quant_int8:   # set-up: the kernel builds before timing
            _build.load("decode_attention")
    print(mesh_line(mesh))
    model = build_model(cfg, device, mesh)
    params = model.init(seed=0)
    pipe = TokenPipeline(batch=args.batch, seq=args.prompt_len,
                         vocab=cfg.vocab_size)
    batch = pipe.get_for(cfg, 0, device, mesh)
    run = generate(model, params, batch, args.gen, args.temperature,
                   keep_logits)

    steps = len(run.step_ms)
    enc = (f" (+ {cfg.num_encoder_layers} encoder)"
           if cfg.is_encoder_decoder else "")
    print(f"model: {cfg.name}, {cfg.num_layers} layers{enc}, d_model "
          f"{cfg.d_model}, {cfg.dtype}, kv cache "
          f"{'int8' if cfg.kv_quant_int8 else cfg.dtype}, device {device} "
          f"(timed by {run.clock})")
    print(f"prefill: {run.prefill_s:.3f}s for {args.batch}x{args.prompt_len}")
    if steps:
        print(f"decode:  {run.decode_s:.3f}s for {steps} steps "
              f"({1000 * run.decode_s / steps:.1f} ms/tok; p50 "
              f"{run.step_percentile_ms(0.5):.3f} ms, p95 "
              f"{run.step_percentile_ms(0.95):.3f} ms per step; "
              f"{run.decode_tokens_per_s:.1f} tokens/s)")
    peak = ("not measured on the cpu" if run.peak_bytes is None
            else f"{run.peak_bytes / 2**30:.2f} GiB")
    print(f"peak memory: {peak}; decode_attention launches: {run.launches}")
    print("generated token ids (first row):", run.tokens[0][:16].tolist())
    return run


if __name__ == "__main__":
    main()

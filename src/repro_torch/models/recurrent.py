"""Recurrent sequence-mixing layers (``repro.models.recurrent``): the
Mamba-style selective SSM of Hymba's SSM heads, and xLSTM's mLSTM and
sLSTM blocks. All are linear recurrences run chunkwise, as the reference
runs them: a Python loop over fixed-size time chunks carrying the state
(the reference's ``lax.scan``), with parallel math inside each chunk.

Each layer has:
  init_*           -> the parameters (``nn.ParameterDict``)
  *_train          -> full-sequence forward (chunked recurrence)
  *_decode         -> one token against an explicit state
  init_*_state     -> zero state for decoding

States are dataclasses of float32 tensors, of bounded size (O(d * state)
a layer); a decode step returns the new state, as the reference does.

On a device mesh (``DeviceMesh`` DTensors) each layer's forward runs in
one local region (``sharding.local_map_axes``) on each rank's ``batch``
block with the whole sequence (the input's sequence gathered first,
``layers.gather_seq``), and its output is placed as the residual
(``layers.SEQ_AXES``). The reference has no ``constrain`` here and places
the states ``("batch", None, None)`` (Mamba), ``("batch", "heads", None,
None)`` / ``("batch", "heads", None)`` (mLSTM's C / n) and ``("batch",
None)`` (sLSTM; ``launch/dryrun.cache_axes_for``), so:

* Mamba and sLSTM take every leaf whole (the FSDP and ``ff`` dims
  gathered) and scan with ``d`` whole; the ranks of one batch block do
  the same work. Mamba's fused ``w_in`` product is split after the
  gather, inside the region: split over ``model`` first, its halves would
  land on different ranks (all of ``xi`` on rank 0 of ``model`` = 2), and
  DTensor refuses views of a sharded dim (torch 2.11). A decode step
  gathers the fused product instead of the weight, where it is the
  smaller (:func:`on_mesh`'s ``up``; mLSTM's ``w_up`` likewise).
* mLSTM splits its heads over ``model`` (``MLSTM_HEAD_AXES``): ``w_up``
  is gathered whole, so that ``xi`` is whole over ``d_inner`` before the
  per-head projections, and a rank takes only the ``z`` columns and the
  ``w_down`` rows of its own heads; its output is a partial sum over the
  heads' ranks, reduced onto the residual's layout (in float32 under
  autograd, rounded once, as ``layers.project`` reduces). Heads that do
  not divide ``model`` stay whole on every rank.

A decode step or a prefill's state holds this rank's block as plain
tensors (``*_STATE_AXES``), as a KV cache does, and is read and written
inside the region.

``lax.associative_scan`` has no PyTorch counterpart: :func:`associative_scan`
follows JAX's odd/even recursion, so the port sums and multiplies in the
reference's order. Its combine here is always :func:`_affine`, elementwise
multiply and add.

Storage: the matrices the reference casts to the activation dtype before
every use (Mamba's ``w_in`` / ``w_b`` / ``w_c`` / ``w_dt`` / ``w_out``,
mLSTM's ``w_up`` / ``w_down``) are kept in ``cfg.dtype`` for serving;
every other leaf stays float32 (Mamba's ``a_log``, ``d_skip``,
``dt_bias``; mLSTM's ``w_q`` / ``w_k`` / ``w_v``, which its decode reads
in float32, ``w_i``, ``w_f``, ``f_bias``; every sLSTM leaf), since the
reference computes with them in float32. Where the reference multiplies
a float32 activation by such a leaf without a cast, the port casts the
leaf to float32 at the site: a no-op on the float32 store, and the
reference's promotion on the training path's bfloat16 view
(``cast_params_bf16``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L

Params = nn.ParameterDict
Pair = tuple[torch.Tensor, torch.Tensor]

# the leaves the serving store keeps in float32 (with every sLSTM leaf)
MAMBA_FLOAT32 = ("a_log", "d_skip", "dt_bias")
MLSTM_FLOAT32 = ("w_q", "w_k", "w_v", "w_i", "w_f", "f_bias")

# the logical axes of the states (the reference's ``cache_axes_for``)
MAMBA_STATE_AXES = ("batch", None, None)
MLSTM_C_AXES = ("batch", "heads", None, None)
MLSTM_N_AXES = ("batch", "heads", None)
SLSTM_STATE_AXES = ("batch", None)
# the mLSTM leaves a rank takes by its block of heads on a mesh (the others
# whole)
MLSTM_HEAD_AXES = {"w_q": (None, "heads", None), "w_k": (None, "heads", None),
                   "w_v": (None, "heads", None), "w_i": (None, "heads"),
                   "w_f": (None, "heads"), "f_bias": ("heads",)}
# a (B, S, D) input inside the region: the rank's batch block, every
# position
X_AXES = ("batch", None, None)
# the fused up-projections' axes (Mamba's ``w_in``, mLSTM's ``w_up``)
W_UP_AXES = ("fsdp", "ff")


# ---------------------------------------------------------------------------
# the associative scan
# ---------------------------------------------------------------------------

def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along dim 0 (``a`` as long as ``b`` or
    one longer)."""
    n = b.shape[0]
    out = torch.stack([a[:n], b], dim=1).flatten(0, 1)
    return torch.cat([out, a[n:]]) if a.shape[0] > n else out


def _scan(fn: Callable, elems: list[torch.Tensor]) -> list[torch.Tensor]:
    n = elems[0].shape[0]
    if n < 2:
        return elems
    # combine adjacent pairs, scan the half-length sequence, then fill in
    # the even positions from the odd ones
    reduced = fn(tuple(e[0:-1:2] for e in elems),
                 tuple(e[1::2] for e in elems))
    odd = _scan(fn, list(reduced))
    tail = tuple(e[2::2] for e in elems)
    if n % 2 == 0:
        even = fn(tuple(e[:-1] for e in odd), tail)
    else:
        even = fn(tuple(odd), tail)
    even = [torch.cat([e[:1], r]) for e, r in zip(elems, even)]
    return [_interleave(a, b) for a, b in zip(even, odd)]


def associative_scan(fn: Callable, elems, dim: int = 0) -> tuple:
    """Inclusive scan of ``elems`` (a tuple of tensors of equal length
    along ``dim``) under the associative ``fn((l...), (r...)) -> (...)``,
    by JAX's recursion (``jax.lax.associative_scan``): element ``t`` is
    ``fn`` folded over elements ``0..t``, combined in the reference's
    tree order."""
    moved = [e.movedim(dim, 0) for e in elems]
    return tuple(e.movedim(0, dim) for e in _scan(fn, moved))


def _affine(l: Pair, r: Pair) -> Pair:
    """Composition of ``h -> a h + b`` maps: (al, bl) then (ar, br)."""
    al, bl = l
    ar, br = r
    return al * ar, bl * ar + br


def _chunk(s: int, chunk: int, what: str) -> int:
    """The reference's chunk ``min(chunk, s)``; a sequence longer than the
    chunk and not a multiple of it raises (the reference asserts)."""
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"{what}: sequence length {s} is not a multiple of "
                         f"the chunk {c}")
    return c


def _whole(name: str, t: torch.Tensor) -> tuple:
    return (None,) * t.ndim


def _by_heads(name: str, t: torch.Tensor) -> tuple:
    return MLSTM_HEAD_AXES.get(name, _whole(name, t))


def on_mesh(fn: Callable, p, x: torch.Tensor, leaf_axes: Callable = _whole,
            reduced: tuple = (), out: bool = True, up: str | None = None):
    """``fn(leaves, x)`` on each rank's blocks, in one local region: ``x``
    (B, S, D) with its sequence gathered (``X_AXES``), each leaf of ``p``
    placed by ``leaf_axes(name, leaf)`` and handed over as a dict of this
    rank's blocks. ``fn`` returns this rank's (B_local, S, D) output, a
    partial sum over the mesh axes the names in ``reduced`` took, which
    is placed as the residual (``layers.SEQ_AXES``) in ``x``'s dtype; with
    ``out=False`` it returns nothing (a state kept by ``fn``).

    ``up`` names a fused up-projection (placed ``W_UP_AXES``) that ``fn``
    only multiplies ``x`` by. Without autograd, where ``x`` has fewer rows
    than it (a decode step), the product is taken on its column blocks
    and gathered in place of the weight (a decode step's 32 rows of Mamba's
    ``x @ w_in`` are 1/50 of ``w_in``'s elements), and ``fn`` finds it as
    ``leaves["up"]``, the weight left out."""
    leaves = dict(p.items())
    axes = {n: leaf_axes(n, t) for n, t in leaves.items()}
    dt = x.dtype
    xs = L.gather_seq(x)
    if up is not None and not torch.is_grad_enabled() and (
            x.shape[0] * x.shape[1] < p[up].shape[0]):
        w = L.gather_fsdp(leaves.pop(up).to(dt), W_UP_AXES)
        del axes[up]
        leaves["up"] = SH.constrain(L.project(xs, w, ("batch", None, "ff")),
                                    *X_AXES)
        axes["up"] = X_AXES
    names = list(leaves)

    def local(xl, *blocks):
        # gather_seq widens to float32 under autograd: back to the
        # activation dtype (the cast's backward reduces in float32)
        return fn(dict(zip(names, blocks)), xl.to(dt))

    run = SH.local_map_axes(
        local, (X_AXES,) + tuple(axes[n] for n in names),
        (X_AXES,) if out else (), reduced)
    y = run(xs, *(leaves[n] for n in names))
    return SH.constrain(y, *L.SEQ_AXES).to(dt) if out else None


def state_on_mesh(fn: Callable, p, x: torch.Tensor, cfg: ArchConfig,
                  leaf_axes: Callable = _whole):
    """``fn(p, x, cfg)``, a function of the whole prompt that returns a
    state, run on each rank's blocks (:func:`on_mesh`): the state of this
    rank's block, plain tensors."""
    kept = []
    on_mesh(lambda pl, xl: kept.append(fn(pl, xl, cfg)), p, x, leaf_axes,
            out=False)
    return kept[0]


def _decode_on_mesh(decode: Callable, p, x: torch.Tensor, cfg: ArchConfig,
                    state, up: str | None = None):
    """``decode(p, x, cfg, state)`` with every leaf whole on each rank's
    batch block (:func:`on_mesh`; ``up`` its fused up-projection),
    ``state`` this rank's block: the output, and the new state of the
    block."""
    new = []

    def local(pl, xl):
        y, st = decode(pl, xl, cfg, state)
        new.append(st)
        return y

    return on_mesh(local, p, x, up=up), new[0]


def _block_shape(axes: tuple, shape: tuple, mesh) -> tuple:
    """This rank's block of a tensor of global ``shape`` placed by
    ``axes`` on ``mesh`` (default: the installed one)."""
    return tuple(SH.local_range(axes, shape, i, mesh)[1]
                 for i in range(len(shape)))


# ---------------------------------------------------------------------------
# Mamba-style selective SSM (diagonal A), Hymba's SSM heads
# ---------------------------------------------------------------------------

def init_mamba(cfg: ArchConfig, device="cpu",
               generator: torch.Generator | None = None,
               trainable: bool = False) -> Params:
    """The reference's distributions: the matrices normal x ``d**-0.5``,
    ``a_log = log(linspace(1, n, n))`` on every row, ``d_skip`` ones,
    ``dt_bias`` uniform on [-4, -2]."""
    d, n = cfg.d_model, cfg.ssm_state
    s = d ** -0.5
    t = trainable
    f32 = torch.float32

    def mat(shape):
        return L._normal(shape, s, cfg, device, generator, t)

    dt_bias = torch.rand(d, generator=generator, device=device, dtype=f32)
    p = {
        "w_in": mat((d, 2 * d)),
        "w_b": mat((d, n)),
        "w_c": mat((d, n)),
        "w_dt": mat((d, 1)),
        "a_log": L._param(torch.log(torch.linspace(
            1.0, float(n), n, device=device))[None, :].repeat(d, 1), t),
        "d_skip": L._param(torch.ones(d, device=device), t),
        "w_out": mat((d, d)),
        "dt_bias": L._param(dt_bias.mul_(2.0).sub_(4.0), t),
    }
    return nn.ParameterDict(p)


def _mamba_scan_chunk(h0, xb, dtb, Bb, Cb, a):
    """One chunk of the diagonal-SSM recurrence by associative scan.

    h0: (B, d, n) carry; xb / dtb: (B, T, d); Bb / Cb: (B, T, n); a: (d, n)
    h_t = exp(dt_t * a) * h_{t-1} + dt_t * B_t * x_t ;  y_t = C_t . h_t
    """
    decay = torch.exp(dtb[..., None] * a)                   # (B, T, d, n)
    inp = (dtb * xb)[..., None] * Bb[:, :, None, :]         # (B, T, d, n)
    aa, bb = associative_scan(_affine, (decay, inp), dim=1)
    h = aa * h0[:, None] + bb
    y = torch.einsum("btdn,btn->btd", h, Cb)
    return h[:, -1], y


def _mamba_inputs(p: Params, x: torch.Tensor):
    """x, z, B, C and dt of the selective SSM over ``x`` (B, S, D), and
    ``a = -exp(a_log)``, at the reference's dtypes."""
    dt_ = x.dtype
    # on a mesh's decode step the product may come gathered (on_mesh)
    xz = p["up"] if "up" in p else x @ p["w_in"].to(dt_)
    xi, z = xz.chunk(2, dim=-1)
    Bt = (x @ p["w_b"].to(dt_)).float()
    Ct = (x @ p["w_c"].to(dt_)).float()
    dt = F.softplus((x @ p["w_dt"].to(dt_)).float() + p["dt_bias"])
    return xi.float(), z, Bt, Ct, dt, -torch.exp(p["a_log"])


def mamba_train(p: Params, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 64) -> torch.Tensor:
    if SH.on_mesh(x):
        return on_mesh(lambda pl, xl: mamba_train(pl, xl, cfg, chunk), p, x,
                       up="w_in")
    b, s, d = x.shape
    xi_f, z, Bt, Ct, dt, a = _mamba_inputs(p, x)
    c = _chunk(s, chunk, "Mamba")
    h = torch.zeros((b, d, cfg.ssm_state), device=x.device)
    ys = []
    for j in range(0, s, c):
        sl = slice(j, j + c)
        h, y = _mamba_scan_chunk(h, xi_f[:, sl], dt[:, sl], Bt[:, sl],
                                 Ct[:, sl], a)
        ys.append(y)
    y = torch.cat(ys, dim=1) + xi_f * p["d_skip"]
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["w_out"].to(x.dtype)


@dataclasses.dataclass
class MambaState:
    h: torch.Tensor  # (B, d, n) float32


def init_mamba_state(cfg: ArchConfig, batch: int, device="cpu", mesh=None
                     ) -> MambaState:
    """Zeros; on a ``DeviceMesh`` (``mesh``, default: the installed one)
    this rank's block (``MAMBA_STATE_AXES``)."""
    shape = _block_shape(MAMBA_STATE_AXES,
                         (batch, cfg.d_model, cfg.ssm_state), mesh)
    return MambaState(h=torch.zeros(shape, device=device))


def mamba_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """x: (B, 1, D)."""
    if SH.on_mesh(x):
        return _decode_on_mesh(mamba_decode, p, x, cfg, state, up="w_in")
    xi_f, z, Bt, Ct, dt, a = _mamba_inputs(p, x)
    xi_f, Bt, Ct, dt = xi_f[:, 0], Bt[:, 0], Ct[:, 0], dt[:, 0]
    decay = torch.exp(dt[..., None] * a)                    # (B, d, n)
    h = state.h * decay + (dt * xi_f)[..., None] * Bt[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Ct) + xi_f * p["d_skip"]
    y = y[:, None].to(x.dtype) * F.silu(z)
    return y @ p["w_out"].to(x.dtype), MambaState(h=h)


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory block)
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ArchConfig) -> tuple[int, int, int]:
    d_inner = 2 * cfg.d_model
    h = cfg.num_heads
    return d_inner, h, d_inner // h


def init_mlstm(cfg: ArchConfig, device="cpu",
               generator: torch.Generator | None = None,
               trainable: bool = False) -> Params:
    """The reference's distributions: ``w_up`` normal x ``d**-0.5``, the
    others normal x ``d_inner**-0.5``, ``f_bias`` 3 (open forget
    gates)."""
    d = cfg.d_model
    d_inner, h, dh = _mlstm_dims(cfg)
    s, si = d ** -0.5, d_inner ** -0.5
    t = trainable
    f32 = torch.float32

    def mat(shape, std, dtype=None):
        return L._normal(shape, std, cfg, device, generator, t, dtype)

    p = {
        "w_up": mat((d, 2 * d_inner), s),
        "w_q": mat((d_inner, h, dh), si, f32),
        "w_k": mat((d_inner, h, dh), si, f32),
        "w_v": mat((d_inner, h, dh), si, f32),
        "w_i": mat((d_inner, h), si, f32),
        "w_f": mat((d_inner, h), si, f32),
        "f_bias": L._param(torch.full((h,), 3.0, device=device), t),
        "w_down": mat((d_inner, d), si),
    }
    return nn.ParameterDict(p)


def _mlstm_gates(p: Params, xf: torch.Tensor):
    """Input and forget gates of float32 ``xf`` (..., d_inner)."""
    ig = torch.exp(torch.clamp(xf @ p["w_i"].float(), -10.0, 5.0))
    fg = torch.sigmoid(xf @ p["w_f"].float() + p["f_bias"])
    return ig, fg


def _mlstm_heads(p, xi: torch.Tensor, chunk: int) -> torch.Tensor:
    """The chunkwise scan of the heads whose projections ``p`` holds
    (``w_q`` (d_inner, H, dh), ...) over ``xi`` (B, S, d_inner): (B, S, H
    * dh) in ``xi``'s dtype."""
    dt_ = xi.dtype
    b, s, _ = xi.shape
    _, h, dh = p["w_q"].shape
    q = L._proj(xi, p["w_q"]).float()
    k = L._proj(xi, p["w_k"]).float()
    v = L._proj(xi, p["w_v"]).float()
    ig, fg = _mlstm_gates(p, xi.float())
    q = q * dh ** -0.5

    c = _chunk(s, chunk, "mLSTM")
    mask = torch.ones((c, c), dtype=torch.bool, device=xi.device).tril()
    mask = mask[None, :, :, None]
    C = torch.zeros((b, h, dh, dh), device=xi.device)
    n = torch.zeros((b, h, dh), device=xi.device)
    outs = []
    for j in range(0, s, c):
        sl = slice(j, j + c)
        qb, kb, vb, ib, fb = q[:, sl], k[:, sl], v[:, sl], ig[:, sl], fg[:, sl]
        logf = torch.log(torch.clamp(fb, min=1e-9))         # (b, c, h)
        Fc = torch.cumsum(logf, dim=1)                      # prod f_1..t
        # intra-chunk decay D[t, u] = exp(F_t - F_u) * i_u for u <= t; the
        # exponent is taken before the mask, as the reference takes it
        D = torch.where(mask, torch.exp(Fc[:, :, None] - Fc[:, None])
                        * ib[:, None], 0.0)                 # (b, t, u, h)
        scores = torch.einsum("bthk,buhk->btuh", qb, kb) * D
        h_intra = torch.einsum("btuh,buhk->bthk", scores, vb)
        # inter-chunk: the carried state, decayed by f_1..f_t
        decay_t = torch.exp(Fc)                             # (b, c, h)
        h_inter = torch.einsum("bthk,bhkl->bthl", qb, C) * decay_t[..., None]
        n_inter = torch.einsum("bthk,bhk->bth", qb, n) * decay_t
        nk = torch.einsum("btuh,buhk->bthk", D, kb)
        n_t = torch.einsum("bthk,bthk->bth", qb, nk) + n_inter
        denom = torch.clamp(n_t.abs(), min=1.0)[..., None]
        outs.append((h_intra + h_inter) / denom)
        # state update
        FT = Fc[:, -1]                                      # (b, h)
        wk = torch.exp(FT[:, None] - Fc) * ib               # (b, c, h)
        eT = torch.exp(FT)
        C = C * eT[..., None, None] + torch.einsum(
            "buhk,buhl->bhkl", kb * wk[..., None], vb)
        n = n * eT[..., None] + torch.einsum("buhk,buh->bhk", kb, wk)
    return torch.cat(outs, dim=1).reshape(b, s, h * dh).to(dt_)


def _mlstm_on_mesh(p, x: torch.Tensor, cfg: ArchConfig,
                   heads: Callable) -> torch.Tensor:
    """The mLSTM block on a mesh (see the module docstring): each rank
    takes ``xi`` whole, ``heads(leaves, xi)`` of its block of heads, the
    ``z`` columns and ``w_down`` rows of those heads; a partial sum over
    the heads' ranks, reduced onto the residual's layout."""
    d_inner, _, dh = _mlstm_dims(cfg)
    h0, hl = SH.local_range(MLSTM_HEAD_AXES["w_q"], p["w_q"].shape, 1)
    cols = slice(h0 * dh, (h0 + hl) * dh)
    # where ``ff`` splits w_down's rows as the heads split, a rank's own
    # block is its heads' rows; else w_down is taken whole
    own = SH.local_range(("ff", None), tuple(p["w_down"].shape), 0) == (
        cols.start, cols.stop - cols.start)

    def axes(name, t):
        return ("ff", None) if name == "w_down" and own else _by_heads(name,
                                                                       t)

    def local(pl, xl):
        if "up" in pl:
            up = pl["up"]
            xi, zh = up[..., :d_inner], up[..., d_inner:][..., cols]
        else:
            w = pl["w_up"].to(xl.dtype)
            xi, zh = xl @ w[:, :d_inner], xl @ w[:, d_inner:][:, cols]
        out = heads(pl, xi) * F.silu(zh)
        w_down = pl["w_down"] if own else pl["w_down"][cols]
        if torch.is_grad_enabled():
            # the partial sums reduced in float32 and rounded once
            return out.float() @ w_down.float()
        return out @ w_down.to(out.dtype)

    return on_mesh(local, p, x, axes, reduced=("heads",), up="w_up")


def mlstm_train(p: Params, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM with sigmoid forget gates: decay-weighted
    attention-like scores within a chunk, the (dh, dh) matrix and (dh,)
    normaliser state carried across chunks."""
    if SH.on_mesh(x):
        return _mlstm_on_mesh(p, x, cfg,
                              lambda pl, xi: _mlstm_heads(pl, xi, chunk))
    dt_ = x.dtype
    up = x @ p["w_up"].to(dt_)
    xi, z = up.chunk(2, dim=-1)
    out = _mlstm_heads(p, xi, chunk) * F.silu(z)
    return out @ p["w_down"].to(dt_)


@dataclasses.dataclass
class MLSTMState:
    C: torch.Tensor  # (B, H, dh, dh) float32
    n: torch.Tensor  # (B, H, dh) float32


def init_mlstm_state(cfg: ArchConfig, batch: int, device="cpu", mesh=None
                     ) -> MLSTMState:
    """Zeros; on a ``DeviceMesh`` (``mesh``, default: the installed one)
    this rank's (batch, heads) block (``MLSTM_C_AXES``, ``MLSTM_N_AXES``)."""
    _, h, dh = _mlstm_dims(cfg)
    return MLSTMState(
        C=torch.zeros(_block_shape(MLSTM_C_AXES, (batch, h, dh, dh), mesh),
                      device=device),
        n=torch.zeros(_block_shape(MLSTM_N_AXES, (batch, h, dh), mesh),
                      device=device))


def _mlstm_step(p, xi: torch.Tensor, state: MLSTMState
                ) -> tuple[torch.Tensor, MLSTMState]:
    """One token of the heads whose projections ``p`` holds: (B, 1, H *
    dh) in ``xi``'s dtype and their new state."""
    dt_ = xi.dtype
    b = xi.shape[0]
    _, h, dh = p["w_q"].shape
    xf = xi[:, 0].float()
    # q, k and v in float32 (the reference casts the leaves to float32)
    q = L._proj(xf, p["w_q"]) * dh ** -0.5                  # (b, h, dh)
    k = L._proj(xf, p["w_k"])
    v = L._proj(xf, p["w_v"])
    ig, fg = _mlstm_gates(p, xf)                            # (b, h)
    C = state.C * fg[..., None, None] + ig[..., None, None] * torch.einsum(
        "bhk,bhl->bhkl", k, v)
    n = state.n * fg[..., None] + ig[..., None] * k
    num = torch.einsum("bhk,bhkl->bhl", q, C)
    den = torch.clamp(torch.einsum("bhk,bhk->bh", q, n).abs(), min=1.0)
    out = (num / den[..., None]).reshape(b, 1, h * dh).to(dt_)
    return out, MLSTMState(C=C, n=n)


def mlstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    if SH.on_mesh(x):
        new = []

        def heads(pl, xi):
            out, st = _mlstm_step(pl, xi, state)
            new.append(st)
            return out

        return _mlstm_on_mesh(p, x, cfg, heads), new[0]
    dt_ = x.dtype
    up = x @ p["w_up"].to(dt_)
    xi, z = up.chunk(2, dim=-1)
    out, st = _mlstm_step(p, xi, state)
    return (out * F.silu(z)) @ p["w_down"].to(dt_), st


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar-memory block): an elementwise linear recurrence
# ---------------------------------------------------------------------------

def init_slstm(cfg: ArchConfig, device="cpu",
               generator: torch.Generator | None = None,
               trainable: bool = False) -> Params:
    """The reference's distributions: the five matrices normal x
    ``d**-0.5``, ``f_bias`` 3; every leaf float32."""
    d = cfg.d_model
    s = d ** -0.5
    t = trainable
    f32 = torch.float32
    p = {name: L._normal((d, d), s, cfg, device, generator, t, f32)
         for name in ("w_z", "w_i", "w_f", "w_o")}
    p["f_bias"] = L._param(torch.full((d,), 3.0, device=device), t)
    p["w_down"] = L._normal((d, d), s, cfg, device, generator, t, f32)
    return nn.ParameterDict(p)


def _slstm_gates(p: Params, xf: torch.Tensor):
    z = torch.tanh(xf @ p["w_z"].float())
    i = torch.sigmoid(xf @ p["w_i"].float())
    f = torch.sigmoid(xf @ p["w_f"].float() + p["f_bias"])
    return z, i, f


def slstm_train(p: Params, x: torch.Tensor, cfg: ArchConfig
                ) -> torch.Tensor:
    if SH.on_mesh(x):
        return on_mesh(lambda pl, xl: slstm_train(pl, xl, cfg), p, x)
    xf = x.float()
    z, i, f = _slstm_gates(p, xf)
    o = torch.sigmoid(xf @ p["w_o"].float())
    # c_t = f_t c_{t-1} + i_t z_t ; n_t = f_t n_{t-1} + i_t (zero state)
    _, c = associative_scan(_affine, (f, i * z), dim=1)
    _, n = associative_scan(_affine, (f, i), dim=1)
    h = o * (c / torch.clamp(n, min=1e-6))
    return (h @ p["w_down"].float()).to(x.dtype)


@dataclasses.dataclass
class SLSTMState:
    c: torch.Tensor  # (B, D) float32
    n: torch.Tensor  # (B, D) float32


def init_slstm_state(cfg: ArchConfig, batch: int, device="cpu", mesh=None
                     ) -> SLSTMState:
    """Zeros; on a ``DeviceMesh`` (``mesh``, default: the installed one)
    this rank's block (``SLSTM_STATE_AXES``)."""
    shape = _block_shape(SLSTM_STATE_AXES, (batch, cfg.d_model), mesh)
    return SLSTMState(c=torch.zeros(shape, device=device),
                      n=torch.zeros(shape, device=device))


def slstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    if SH.on_mesh(x):
        return _decode_on_mesh(slstm_decode, p, x, cfg, state)
    xf = x[:, 0].float()
    z, i, f = _slstm_gates(p, xf)
    o = torch.sigmoid(xf @ p["w_o"].float())
    c = f * state.c + i * z
    n = torch.clamp(f * state.n + i, min=1e-6)
    h = o * (c / n)
    y = (h @ p["w_down"].float())[:, None].to(x.dtype)
    return y, SLSTMState(c=c, n=n)

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
from repro_torch.models import layers as L

Params = nn.ParameterDict
Pair = tuple[torch.Tensor, torch.Tensor]

# the leaves the serving store keeps in float32 (with every sLSTM leaf)
MAMBA_FLOAT32 = ("a_log", "d_skip", "dt_bias")
MLSTM_FLOAT32 = ("w_q", "w_k", "w_v", "w_i", "w_f", "f_bias")


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
    xz = x @ p["w_in"].to(dt_)
    xi, z = xz.chunk(2, dim=-1)
    Bt = (x @ p["w_b"].to(dt_)).float()
    Ct = (x @ p["w_c"].to(dt_)).float()
    dt = F.softplus((x @ p["w_dt"].to(dt_)).float() + p["dt_bias"])
    return xi.float(), z, Bt, Ct, dt, -torch.exp(p["a_log"])


def mamba_train(p: Params, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 64) -> torch.Tensor:
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


def init_mamba_state(cfg: ArchConfig, batch: int, device="cpu"
                     ) -> MambaState:
    return MambaState(h=torch.zeros((batch, cfg.d_model, cfg.ssm_state),
                                    device=device))


def mamba_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """x: (B, 1, D)."""
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


def mlstm_train(p: Params, x: torch.Tensor, cfg: ArchConfig,
                chunk: int = 256) -> torch.Tensor:
    """Chunkwise-parallel mLSTM with sigmoid forget gates: decay-weighted
    attention-like scores within a chunk, the (dh, dh) matrix and (dh,)
    normaliser state carried across chunks."""
    dt_ = x.dtype
    b, s, _ = x.shape
    _, h, dh = _mlstm_dims(cfg)
    up = x @ p["w_up"].to(dt_)
    xi, z = up.chunk(2, dim=-1)
    q = L._proj(xi, p["w_q"]).float()
    k = L._proj(xi, p["w_k"]).float()
    v = L._proj(xi, p["w_v"]).float()
    ig, fg = _mlstm_gates(p, xi.float())
    q = q * dh ** -0.5

    c = _chunk(s, chunk, "mLSTM")
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    mask = mask[None, :, :, None]
    C = torch.zeros((b, h, dh, dh), device=x.device)
    n = torch.zeros((b, h, dh), device=x.device)
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
    out = torch.cat(outs, dim=1).reshape(b, s, h * dh).to(dt_)
    out = out * F.silu(z)
    return out @ p["w_down"].to(dt_)


@dataclasses.dataclass
class MLSTMState:
    C: torch.Tensor  # (B, H, dh, dh) float32
    n: torch.Tensor  # (B, H, dh) float32


def init_mlstm_state(cfg: ArchConfig, batch: int, device="cpu"
                     ) -> MLSTMState:
    _, h, dh = _mlstm_dims(cfg)
    return MLSTMState(C=torch.zeros((batch, h, dh, dh), device=device),
                      n=torch.zeros((batch, h, dh), device=device))


def mlstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    dt_ = x.dtype
    b = x.shape[0]
    _, h, dh = _mlstm_dims(cfg)
    up = x @ p["w_up"].to(dt_)
    xi, z = up.chunk(2, dim=-1)
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
    out = out * F.silu(z)
    return out @ p["w_down"].to(dt_), MLSTMState(C=C, n=n)


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


def init_slstm_state(cfg: ArchConfig, batch: int, device="cpu"
                     ) -> SLSTMState:
    return SLSTMState(c=torch.zeros((batch, cfg.d_model), device=device),
                      n=torch.zeros((batch, cfg.d_model), device=device))


def slstm_decode(p: Params, x: torch.Tensor, cfg: ArchConfig,
                 state: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    xf = x[:, 0].float()
    z, i, f = _slstm_gates(p, xf)
    o = torch.sigmoid(xf @ p["w_o"].float())
    c = f * state.c + i * z
    n = torch.clamp(f * state.n + i, min=1e-6)
    h = o * (c / n)
    y = (h @ p["w_down"].float())[:, None].to(x.dtype)
    return y, SLSTMState(c=c, n=n)

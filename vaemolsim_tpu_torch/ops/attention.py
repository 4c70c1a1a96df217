"""The GA-attention pair grid in one kernel (port of the TPU kernel
``_kernel`` / ``_one_frame`` of ``vaemolsim_tpu/ops/attention_pallas.py``).

Per frame of N particles, over the (N, N) pair grid, with the
rotation-invariant pair features ``q_ij = [r_i . r_j, |r_i x r_j|,
|r_i|^2, |r_j|^2]`` of the coordinates:

    h_s    = act(ni_s[i] + nj_s[j] + b1_s + sum_m q_ijm wq_s[m])    (H,)
    s_ij   = h_s . w2_s + b2_s
    h_v    = ni_v[i] + nj_v[j] + b1_v + sum_m q_ijm wq_v[m]          (H,)
    v_ij   = act(LayerNorm(h_v)) @ w2_v + b2_v                      (Fo,)

``ni_*`` / ``nj_*`` are the node projections ``values @ W[:F]`` and
``values @ W[F:2F]`` of the score and value nets' first layers (their
bias excluded), computed outside.  With the pair mask ``pm = m_i m_j``
the masked logits become -1e9, ``e = exp(s - max) pm`` and ``alpha = e /
max(sum e, 1e-30)``, with the max and the sum taken per row i
(``reduce=False``: output (B, N, Fo), ``sum_j alpha_ij v_ij``) or over
the whole grid (``reduce=True``: output (B, Fo)).  A fully masked row
or cloud gives exact zeros.

:func:`pair_attention_plain` is the plain version (it computes the
invariants itself).  :func:`pair_attention_cuda` launches
``csrc/pair_attention.cu`` on float32 CUDA tensors.
:func:`pair_attention` runs the plain version on a CPU tensor; on a CUDA
tensor it launches the kernel (or raises), differentiable by
recomputing through the plain version, as the JAX ``custom_vjp``
recomputes through the XLA path.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from vaemolsim_tpu_torch import _build

Tensor = torch.Tensor

__all__ = ["pair_invariants", "pair_attention_plain", "pair_attention_cuda",
           "pair_attention", "kernel_plan", "ACT_CODES", "KERNEL"]

KERNEL = _build.Kernel(
    "pair_attention", "csrc/pair_attention.cu", "pair_attention_launch",
    [ctypes.c_void_p] * 17 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_longlong],
    replaces="vaemolsim_tpu/ops/attention_pallas.py:53")

ACT_CODES = {None: 0, "linear": 0, "relu": 1, "tanh": 2}
_NEG_INF = -1e9
# The kernel's launch: 256 threads a block, at most 8 frames a block, at
# least 264 blocks (two an SM of the H100's 132) where B allows, the card's
# dynamic shared memory per block, and per SM (228 KB, 1 KB of it reserved
# per block).  The rows regime: lanes hold 2, 4, 5 or 8 hidden units each,
# at most a warp a row (H <= 256); the stream regime up to 16 (H <= 512),
# over keys in chunks of 128; the grid regime about 512 pairs a block.
_THREADS, _MAX_FRAMES, _MIN_BLOCKS, _MAX_SMEM = 256, 8, 264, 232448
_SM_SMEM, _BLOCK_RESERVE = 233472, 1024
_UNITS = (2, 4, 5, 8)
_STREAM_UNITS = (2, 4, 5, 8, 12, 16)
_CHUNK = 128
_GRID_PAIRS = 512
_REGIMES = {"rows": 0, "grid": 1, "stream": 2}


def _frames(B: int, want: int, smem_of) -> int:
    """Frames per block: ``want`` (1 to 8), fewer where B is small (to
    keep _MIN_BLOCKS blocks) or shared memory runs out."""
    T = min(max(want, 1), _MAX_FRAMES)
    if B // _MIN_BLOCKS < T:
        T = max(B // _MIN_BLOCKS, 1)
    while T > 1 and smem_of(T) > _MAX_SMEM:
        T -= 1
    return T


def kernel_plan(B: int, N: int, H: int, Fo: int,
                regime: str | None = None) -> dict:
    """How ``csrc/pair_attention.cu`` runs a call, decided here and only
    validated by the kernel's launch.  ``regime`` "rows" where H <= 256
    and either two of its blocks of one frame fit an SM's shared memory
    or a block holds 32 lane groups (or the grid regime's frame does not
    fit): a group of ``lanes`` per row (a power of two, the fewest holding
    H units at <= 5 each, at most a warp), ``units`` per lane (the
    smallest compiled count, 2, 4, 5 or 8, that covers H), as many
    ``frames`` per block as give each lane group a row; "grid" otherwise:
    a thread per pair, about 512 pairs a block.  The rule is the H100's:
    over N = 6 to 64 and H = 16 to 200, in both modes, it picks the faster
    regime or one within 4% of it (chip_turns.py's sweep); the grid wins
    where an SM holds one rows block of 16 or 8 lane groups (N = 50 and 64
    at H = 64, N = 50 at H = 100, N = 37 and 50 at H = 128, N = 37 at H =
    200).  "stream" where H <= 512 and one frame fits neither (N = 100
    at H = 40, N = 400 at H = 300): a block a frame, the rows regime's lane
    groups with up to 16 units a lane (2, 4, 5, 8, 12 or 16), the keys
    walked in chunks of 128 by an online softmax, so that shared memory
    holds a chunk's scores and a row's accumulators per group and nothing
    of size N.  ``smem`` bytes per block, ``blocks``; ``refused`` where no
    regime fits a block's shared memory (H > 512 with a frame beyond the
    grid regime, or a value head too large for it).  A given ``regime``
    is taken where the shapes allow it (to measure or test one regime at
    a shape the rule gives another)."""
    def r4(v):
        return (v + 3) & ~3

    lanes = 1
    while lanes < 32 and lanes * 5 < H:
        lanes *= 2
    need = -(-H // lanes)
    units = next((u for u in _UNITS if u >= need), None)
    s_units = next((u for u in _STREAM_UNITS if u >= need), None)
    ld = H | 1

    def rows_smem(T):
        return 4 * (r4(H * Fo + Fo) + _THREADS // 32
                    + T * r4(4 * N * N + 4 * N * H + N * N + N * H + 5 * N))

    def grid_smem(T):
        return 4 * (13 * H + H * Fo + Fo + 1
                    + T * (4 * N + 4 * N * ld + 7 * N * N + N * H + N))

    def stream_smem(G):
        return 4 * (r4(H * Fo + Fo) + G * (_CHUNK + r4(H)) + 3 * G)

    rows_ok = units is not None and rows_smem(1) <= _MAX_SMEM
    asked = regime
    if regime is None:
        two = 2 * (rows_smem(1) + _BLOCK_RESERVE) <= _SM_SMEM
        regime = ("rows" if rows_ok and (two or _THREADS // lanes >= 32
                                         or grid_smem(1) > _MAX_SMEM)
                  else "grid")
    if regime == "rows" and rows_ok:
        T = _frames(B, (_THREADS // lanes) // N, rows_smem)
        plan = dict(regime="rows", lanes=lanes, units=units, frames=T,
                    smem=rows_smem(T))
    else:
        T = _frames(B, -(-_GRID_PAIRS // (N * N)), grid_smem)
        plan = dict(regime="grid", lanes=None, units=None, frames=T,
                    smem=grid_smem(T))
    if s_units is not None and (asked == "stream" or (
            asked is None and plan["smem"] > _MAX_SMEM)):
        plan = dict(regime="stream", lanes=lanes, units=s_units, frames=1,
                    smem=stream_smem(_THREADS // lanes))
    plan.update(blocks=-(-B // plan["frames"]),
                refused=plan["smem"] > _MAX_SMEM)
    return plan


def pair_invariants(coords: Tensor) -> Tensor:
    """(..., N, 3) -> (..., N, N, 4): [r_i . r_j, |r_i x r_j|, |r_i|^2,
    |r_j|^2], with 1e-12 under the square root."""
    dots = coords @ coords.transpose(-1, -2)
    cross = torch.linalg.cross(coords[..., :, None, :],
                               coords[..., None, :, :], dim=-1)
    cross_norm = torch.sqrt((cross * cross).sum(-1) + 1e-12)
    n2 = (coords * coords).sum(-1)
    return torch.stack([dots, cross_norm,
                        n2[..., :, None].expand(dots.shape),
                        n2[..., None, :].expand(dots.shape)], -1)


def _activate(h: Tensor, act) -> Tensor:
    if act == "relu":
        return torch.relu(h)
    if act == "tanh":
        return torch.tanh(h)
    return h


def pair_attention_plain(coords: Tensor, ni_s: Tensor, nj_s: Tensor,
                         ni_v: Tensor, nj_v: Tensor, mask: Tensor,
                         wq_s: Tensor, b1_s: Tensor, w2_s: Tensor,
                         b2_s: Tensor, wq_v: Tensor, b1_v: Tensor,
                         ln_g: Tensor, ln_b: Tensor, w2_v: Tensor,
                         b2_v: Tensor, *, reduce: bool, act=None,
                         ln_eps: float = 1e-3) -> Tensor:
    """The pair grid in plain PyTorch (the reference and the gradient
    path).  coords (B, N, 3); ni/nj (B, N, H); mask (B, N) float;
    wq (4, H); b1, w2_s, ln_g, ln_b (H,); b2_s (1,); w2_v (H, Fo);
    b2_v (Fo,)."""
    q = pair_invariants(coords)                       # (B, N, N, 4)

    def trunk(ni, nj, wq, b1):
        h = ni[:, :, None, :] + nj[:, None, :, :] + b1
        for m in range(4):
            h = h + q[..., m, None] * wq[m]
        return h

    h_s = _activate(trunk(ni_s, nj_s, wq_s, b1_s), act)
    scores = (h_s * w2_s).sum(-1) + b2_s[0]
    h_v = trunk(ni_v, nj_v, wq_v, b1_v)
    mu = h_v.mean(-1, keepdim=True)
    var = ((h_v - mu) ** 2).mean(-1, keepdim=True)
    h_v = _activate((h_v - mu) * torch.rsqrt(var + ln_eps) * ln_g + ln_b,
                    act)
    vals = h_v @ w2_v + b2_v                          # (B, N, N, Fo)
    pm = mask[:, :, None] * mask[:, None, :]
    scores = torch.where(pm > 0.5, scores, torch.full_like(scores, _NEG_INF))
    if reduce:
        m0 = scores.amax((-2, -1), keepdim=True)
        e = torch.exp(scores - m0) * pm
        alpha = e / e.sum((-2, -1), keepdim=True).clamp_min(1e-30)
        return (alpha[..., None] * vals).sum((1, 2))
    m0 = scores.amax(-1, keepdim=True)
    e = torch.exp(scores - m0) * pm
    alpha = e / e.sum(-1, keepdim=True).clamp_min(1e-30)
    return (alpha[..., None] * vals).sum(2)


def pair_attention_cuda(coords: Tensor, ni_s: Tensor, nj_s: Tensor,
                        ni_v: Tensor, nj_v: Tensor, mask: Tensor,
                        wq_s: Tensor, b1_s: Tensor, w2_s: Tensor,
                        b2_s: Tensor, wq_v: Tensor, b1_v: Tensor,
                        ln_g: Tensor, ln_b: Tensor, w2_v: Tensor,
                        b2_v: Tensor, *, reduce: bool, act=None,
                        ln_eps: float = 1e-3) -> Tensor:
    """Launch ``csrc/pair_attention.cu`` on float32 CUDA tensors with the
    plan of :func:`kernel_plan`.  Raises where the plan is refused."""
    if coords.dim() != 3 or coords.shape[-1] != 3:
        raise ValueError(f"coords: expected (B, N, 3), got "
                         f"{tuple(coords.shape)}")
    if act not in ACT_CODES:
        raise ValueError(f"the pair-attention kernel takes relu, tanh or "
                         f"linear, got {act!r}")
    B, N, _ = coords.shape
    H = wq_s.shape[-1]
    Fo = w2_v.shape[-1]

    def req(t, what, shape):
        return _build.require(t.contiguous(), what, shape)

    args = [req(coords, "coords", (B, N, 3))]
    args += [req(t, w, (B, N, H)) for t, w in
             ((ni_s, "ni_s"), (nj_s, "nj_s"), (ni_v, "ni_v"), (nj_v, "nj_v"))]
    args.append(req(mask, "mask", (B, N)))
    args += [req(t, w, s) for t, w, s in (
        (wq_s, "wq_s", (4, H)), (b1_s, "b1_s", (H,)), (w2_s, "w2_s", (H,)),
        (b2_s, "b2_s", (1,)), (wq_v, "wq_v", (4, H)), (b1_v, "b1_v", (H,)),
        (ln_g, "ln_g", (H,)), (ln_b, "ln_b", (H,)), (w2_v, "w2_v", (H, Fo)),
        (b2_v, "b2_v", (Fo,)))]
    plan = kernel_plan(B, N, H, Fo)
    if plan["refused"]:
        raise ValueError(f"pair_attention: no regime of the kernel takes a "
                         f"frame of N={N}, H={H}, Fo={Fo} (it needs "
                         f"{plan['smem']} bytes of shared memory, the card "
                         f"has {_MAX_SMEM}; the stream regime takes any N "
                         f"up to H={32 * _STREAM_UNITS[-1]})")
    out = torch.empty((B, Fo) if reduce else (B, N, Fo), dtype=coords.dtype,
                      device=coords.device)
    KERNEL.launch(coords.device, *[t.data_ptr() for t in args],
                  out.data_ptr(), B, N, H, Fo, ACT_CODES[act], int(reduce),
                  float(ln_eps), _REGIMES[plan["regime"]],
                  plan["lanes"] or 0, plan["units"] or 0, plan["frames"],
                  plan["smem"], outputs=(out,))
    return out


def pair_attention(coords: Tensor, ni_s: Tensor, nj_s: Tensor, ni_v: Tensor,
                   nj_v: Tensor, mask: Tensor, weights: Sequence[Tensor], *,
                   reduce: bool, act=None, ln_eps: float = 1e-3) -> Tensor:
    """The pair grid: the plain version on a CPU tensor, the kernel on a
    CUDA tensor, differentiable through the plain version with respect
    to the coordinates, the four node projections and the ten
    ``weights`` (wq_s, b1_s, w2_s, b2_s, wq_v, b1_v, ln_g, ln_b, w2_v,
    b2_v)."""
    kw = dict(reduce=reduce, act=act, ln_eps=ln_eps)
    tensors = (coords, ni_s, nj_s, ni_v, nj_v, mask, *weights)
    if not coords.is_cuda:
        return pair_attention_plain(*tensors, **kw)
    return _build.call_with_plain_grad(
        lambda *ts: pair_attention_cuda(*ts, **kw),
        lambda *ts: pair_attention_plain(*ts, **kw), *tensors)

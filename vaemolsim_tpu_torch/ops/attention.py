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
           "pair_attention", "ACT_CODES", "KERNEL"]

KERNEL = _build.Kernel(
    "pair_attention", "csrc/pair_attention.cu", "pair_attention_launch",
    [ctypes.c_void_p] * 17 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_float],
    replaces="vaemolsim_tpu/ops/attention_pallas.py:53")

ACT_CODES = {None: 0, "linear": 0, "relu": 1, "tanh": 2}
_NEG_INF = -1e9


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
    """Launch ``csrc/pair_attention.cu`` on float32 CUDA tensors.  A
    frame whose pair grid does not fit shared memory is refused by the
    kernel's launch, which raises."""
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
    out = torch.empty((B, Fo) if reduce else (B, N, Fo), dtype=coords.dtype,
                      device=coords.device)
    KERNEL.launch(coords.device, *[t.data_ptr() for t in args],
                  out.data_ptr(), B, N, H, Fo, ACT_CODES[act], int(reduce),
                  float(ln_eps))
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

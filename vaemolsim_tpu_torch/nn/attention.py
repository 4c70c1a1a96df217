"""Geometric-algebra attention over local particle environments (port of
``vaemolsim_tpu/nn/attention.py``).

For every ordered particle pair (i, j) the rotation-invariant features
``q_ij = [r_i . r_j, |r_i x r_j|, |r_i|^2, |r_j|^2]`` join the node values
in one pair input ``concat(v_i, v_j, q_ij)``, read by a score net and a
value net; a masked softmax over j (``reduce=False``, permutation
equivariant) or over the whole grid (``reduce=True``, invariant) weighs
the values.  The first Dense of each net is evaluated split by input
block (``_dense_blocks``): the node matmuls run on (N, F) tensors and
only adds touch the (N, N) grid.

A CUDA :class:`VectorAttention` whose wiring the pair-attention kernel
supports runs through it (``ops/attention.py``, ``csrc/pair_attention.cu``):
one activation, relu, tanh or linear, shared by the score trunk and the
value net, no activation on ``value_net.d1`` or on either head, and the
float32 compute dtype.  Every other wiring takes the plain path.  A CUDA
call of that wiring always launches the kernel: its stream regime takes
any frame size up to a hidden width of 512, and a call that no regime
takes (``ops.attention.kernel_plan``: a hidden width above 512 with a
frame beyond the grid regime) raises ``ValueError`` naming the limit; it
never falls back to the plain layer on the card.  There is no switch:
the JAX package's ``set_attention_pallas`` / ``use_attention_pallas``
chose a TPU backend that its own study measured
slower than XLA; here the kernel is the route whenever it applies.  On
the CPU the kernel route runs the kernel's plain version.

``VectorAttentionTwoStage`` (``attention="two_stage"``) is the
paper-faithful two-stage layer: a value net on the pair invariants
alone, a learned merge of the node values, a learned join of the two,
and scores from the joined representation.  The JAX package runs it on
XLA; here it is plain PyTorch on any device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch
from torch import nn

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.core import (Dense, LayerNorm, compute_dtype,
                                         resolve_activation)
from vaemolsim_tpu_torch.nn.mappings import DistanceSelection
from vaemolsim_tpu_torch.ops.attention import (_NEG_INF, ACT_CODES,
                                               pair_attention,
                                               pair_invariants)

Tensor = torch.Tensor

__all__ = ["pair_invariants", "VectorAttention", "VectorAttentionTwoStage",
           "AttentionBlock", "ParticleEmbedding", "LocalParticleDescriptors"]


def _dense_blocks(d: Dense, parts: Sequence[Tuple[Tensor, Optional[str]]]
                  ) -> Tensor:
    """``d(concat(parts))`` over the (N, N) pair grid without building
    the concatenation: ``concat(a, b, ...) @ W = a @ W[:fa] + b @
    W[fa:fa+fb] + ...``.  A part of kind ``"i"`` / ``"j"`` is an
    (..., N, F) node tensor broadcast along the j / i pair axis; ``None``
    an (..., N, N, F) grid.  Float32 only."""
    W = d.kernel
    y = None
    off = 0
    for arr, kind in parts:
        f = arr.shape[-1]
        t = arr @ W[off:off + f]
        off += f
        if kind == "i":
            t = t[..., :, None, :]
        elif kind == "j":
            t = t[..., None, :, :]
        y = t if y is None else y + t
    if off != W.shape[0]:
        raise ValueError(f"parts cover {off} of {W.shape[0]} input dims")
    return resolve_activation(d.activation)(y + d.bias)


class _ScoreNet(nn.Module):
    """Dense(hidden, act) -> Dense(1)."""

    def __init__(self, d1: Dense, d2: Dense):
        super().__init__()
        self.d1, self.d2 = d1, d2

    @classmethod
    def create(cls, generator, in_dim: int, hidden_dim: int,
               activation: str = "relu", device=None) -> "_ScoreNet":
        device = default_device(device)
        return cls(Dense.create(generator, in_dim, hidden_dim, activation,
                                device=device),
                   Dense.create(generator, hidden_dim, 1, device=device))

    def forward(self, x: Tensor) -> Tensor:
        return self.d2(self.d1(x))[..., 0]


class _ValueNet(nn.Module):
    """Dense -> LayerNorm -> act -> Dense."""

    def __init__(self, d1: Dense, ln: LayerNorm, d2: Dense,
                 activation: str = "relu"):
        super().__init__()
        self.d1, self.ln, self.d2 = d1, ln, d2
        self.activation = activation

    @classmethod
    def create(cls, generator, in_dim: int, hidden_dim: int, out_dim: int,
               activation: str = "relu", device=None) -> "_ValueNet":
        device = default_device(device)
        return cls(Dense.create(generator, in_dim, hidden_dim, device=device),
                   LayerNorm.create(hidden_dim, device=device),
                   Dense.create(generator, hidden_dim, out_dim,
                                device=device), activation)

    def forward(self, x: Tensor) -> Tensor:
        return self.d2(resolve_activation(self.activation)(
            self.ln(self.d1(x))))


class VectorAttention(nn.Module):
    """Rank-2 geometric-algebra attention over a point cloud:
    ``forward(coords (..., N, 3), values (..., N, F), mask (..., N) bool)``
    gives (..., N, F_out), or (..., F_out) with ``reduce=True``."""

    def __init__(self, score_net: _ScoreNet, value_net: _ValueNet,
                 reduce: bool = False):
        super().__init__()
        self.score_net, self.value_net = score_net, value_net
        self.reduce = reduce

    @classmethod
    def create(cls, generator, value_dim: int, out_dim: int,
               hidden_dim: int = 40, reduce: bool = False,
               activation: str = "relu", device=None) -> "VectorAttention":
        device = default_device(device)
        pair_in = 2 * value_dim + 4
        return cls(_ScoreNet.create(generator, pair_in, hidden_dim,
                                    activation, device),
                   _ValueNet.create(generator, pair_in, hidden_dim, out_dim,
                                    activation, device), reduce)

    @property
    def kernel_wiring(self) -> bool:
        """Whether the pair-attention kernel computes this layer: the
        create() wiring (one shared activation among relu, tanh and
        linear; linear value_net.d1 and heads) at the float32 compute
        dtype."""
        s, v = self.score_net, self.value_net
        act = s.d1.activation
        return (act in ACT_CODES and v.activation in ACT_CODES
                and ACT_CODES[act] == ACT_CODES[v.activation]
                and ACT_CODES.get(v.d1.activation) == 0
                and ACT_CODES.get(s.d2.activation) == 0
                and ACT_CODES.get(v.d2.activation) == 0
                and compute_dtype() in (None, torch.float32))

    def forward(self, coords: Tensor, values: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        if self.kernel_wiring:
            maskf = (torch.ones(coords.shape[:-1], dtype=coords.dtype,
                                device=coords.device) if mask is None
                     else mask.to(coords.dtype))
            return self.pair_grid(coords, values, maskf)
        return self.plain_call(coords, values, mask)

    def pair_args(self, coords: Tensor, values: Tensor, maskf: Tensor):
        """The arguments of ``ops.attention.pair_attention`` for (B, N, 3)
        coordinates, (B, N, F) values and a (B, N) float mask: the node
        projections (computed here), the mask and the ten weights, and
        the keyword arguments."""
        F = values.shape[-1]
        s, vn = self.score_net, self.value_net
        w_s, w_v = s.d1.kernel, vn.d1.kernel
        args = (coords, values @ w_s[:F], values @ w_s[F:2 * F],
                values @ w_v[:F], values @ w_v[F:2 * F], maskf,
                (w_s[2 * F:], s.d1.bias, s.d2.kernel[:, 0], s.d2.bias,
                 w_v[2 * F:], vn.d1.bias, vn.ln.scale, vn.ln.offset,
                 vn.d2.kernel, vn.d2.bias))
        return args, dict(reduce=self.reduce, act=s.d1.activation,
                          ln_eps=vn.ln.eps)

    def pair_grid(self, coords: Tensor, values: Tensor,
                  maskf: Tensor) -> Tensor:
        """The kernel route: node projections here, the pair grid in
        ``ops.attention.pair_attention`` (the kernel on CUDA)."""
        lead = coords.shape[:-2]
        N, F = coords.shape[-2], values.shape[-1]
        args, kw = self.pair_args(coords.reshape(-1, N, 3),
                                  values.reshape(-1, N, F),
                                  maskf.reshape(-1, N))
        out = pair_attention(*args, **kw)
        fo = self.value_net.d2.out_dim
        return out.reshape(lead + ((fo,) if self.reduce else (N, fo)))

    def plain_call(self, coords: Tensor, values: Tensor,
                   mask: Optional[Tensor] = None) -> Tensor:
        """The JAX package's XLA path, for any wiring: split-weight nets
        over the grid, masked softmax, contraction."""
        N = coords.shape[-2]
        parts = [(values, "i"), (values, "j"), (pair_invariants(coords),
                                                None)]
        scores = self.score_net.d2(_dense_blocks(self.score_net.d1,
                                                 parts))[..., 0]
        h = self.value_net.ln(_dense_blocks(self.value_net.d1, parts))
        vals = self.value_net.d2(
            resolve_activation(self.value_net.activation)(h))
        pair_mask = (None if mask is None
                     else mask[..., :, None] & mask[..., None, :])
        if pair_mask is not None:
            scores = torch.where(pair_mask, scores,
                                 torch.full_like(scores, _NEG_INF))
        if self.reduce:
            flat = scores.reshape(scores.shape[:-2] + (N * N,))
            alpha = torch.softmax(flat, -1).reshape(scores.shape)
            out = (alpha[..., None] * vals).sum((-3, -2))
            if mask is not None:
                # A fully masked cloud gives zeros, not uniform weights
                # over padding.
                out = torch.where(mask.any(-1)[..., None], out, 0.0)
            return out
        alpha = torch.softmax(scores, -1)
        if pair_mask is not None:
            # Fully masked rows would get uniform weights: zero them.
            alpha = torch.where(pair_mask, alpha, 0.0)
        return (alpha[..., None] * vals).sum(-2)


class AttentionBlock(nn.Module):
    """VectorAttention(reduce=False), then Dense -> LayerNorm -> act ->
    Dense with a residual add."""

    def __init__(self, attn: VectorAttention, post_d1: Dense,
                 post_ln: LayerNorm, post_d2: Dense,
                 activation: str = "relu"):
        super().__init__()
        self.attn = attn
        self.post_d1, self.post_ln, self.post_d2 = post_d1, post_ln, post_d2
        self.activation = activation

    @classmethod
    def create(cls, generator, working_dim: int, hidden_dim: int = 40,
               activation: str = "relu", attention: str = "fused",
               device=None) -> "AttentionBlock":
        device = default_device(device)
        return cls(_make_attention(attention, generator, working_dim,
                                   working_dim, hidden_dim, False,
                                   activation, device),
                   Dense.create(generator, working_dim, hidden_dim,
                                device=device),
                   LayerNorm.create(hidden_dim, device=device),
                   Dense.create(generator, hidden_dim, working_dim,
                                device=device), activation)

    def forward(self, coords: Tensor, embedding: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        act = resolve_activation(self.activation)
        new = self.attn(coords, embedding, mask)
        return self.post_d2(act(self.post_ln(self.post_d1(new)))) + embedding


class VectorAttentionTwoStage(nn.Module):
    """The two-stage geometric-algebra attention (Spellings 2021 §3, the
    layer the reference configures): ``value_net`` reads the pair
    invariants alone; ``merge`` projects ``concat(v_i, v_j)``; ``join``
    projects ``concat(merged, value_net(q_ij))``; ``score_net`` scores
    the joined representation, and the output is the attention-weighted
    sum of the joined representations.  Same call and invariances as
    :class:`VectorAttention`.  Plain PyTorch (split-weight Dense over the
    grid, as ``_dense_blocks``)."""

    def __init__(self, value_net: _ValueNet, merge: Dense, join: Dense,
                 score_net: _ScoreNet, reduce: bool = False):
        super().__init__()
        self.value_net, self.merge, self.join = value_net, merge, join
        self.score_net = score_net
        self.reduce = reduce

    @classmethod
    def create(cls, generator, value_dim: int, out_dim: int,
               hidden_dim: int = 40, reduce: bool = False,
               activation: str = "relu",
               device=None) -> "VectorAttentionTwoStage":
        device = default_device(device)
        return cls(_ValueNet.create(generator, 4, hidden_dim, out_dim,
                                    activation, device),
                   Dense.create(generator, 2 * value_dim, out_dim,
                                device=device),
                   Dense.create(generator, 2 * out_dim, out_dim,
                                device=device),
                   _ScoreNet.create(generator, out_dim, hidden_dim,
                                    activation, device), reduce)

    def forward(self, coords: Tensor, values: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        N = coords.shape[-2]
        inv_vals = self.value_net(pair_invariants(coords))
        merged = _dense_blocks(self.merge, [(values, "i"), (values, "j")])
        joined = _dense_blocks(self.join, [(merged, None),
                                           (inv_vals, None)])
        scores = self.score_net(joined)
        pair_mask = (None if mask is None
                     else mask[..., :, None] & mask[..., None, :])
        if pair_mask is not None:
            scores = torch.where(pair_mask, scores,
                                 torch.full_like(scores, _NEG_INF))
        if self.reduce:
            flat = scores.reshape(scores.shape[:-2] + (N * N,))
            alpha = torch.softmax(flat, -1).reshape(scores.shape)
            out = torch.einsum("...ij,...ijf->...f", alpha, joined)
            if mask is not None:
                out = torch.where(mask.any(-1)[..., None], out, 0.0)
            return out
        alpha = torch.softmax(scores, -1)
        if pair_mask is not None:
            alpha = torch.where(pair_mask, alpha, 0.0)
        return torch.einsum("...ij,...ijf->...if", alpha, joined)


def _make_attention(kind: str, generator, value_dim: int, out_dim: int,
                    hidden_dim: int, reduce: bool, activation: str, device):
    if kind == "fused":
        return VectorAttention.create(generator, value_dim, out_dim,
                                      hidden_dim, reduce, activation, device)
    if kind == "two_stage":
        return VectorAttentionTwoStage.create(generator, value_dim, out_dim,
                                              hidden_dim, reduce, activation,
                                              device)
    raise ValueError(
        f"attention must be 'fused' or 'two_stage', got {kind!r}")


class ParticleEmbedding(nn.Module):
    """Point cloud + per-particle info -> a rotation-invariant embedding:
    a linear ``info_net``, ``num_blocks`` AttentionBlocks (equivariant),
    then a reduce=True VectorAttention (invariant).  With ``mask_zero``
    and no explicit mask, rows whose coordinates are exactly (0, 0, 0)
    are padding (DistanceSelection zero-fills invalid rows)."""

    def __init__(self, info_net: Dense, blocks: Sequence[AttentionBlock],
                 final_attn: VectorAttention, mask_zero: bool = True):
        super().__init__()
        self.info_net = info_net
        self.blocks = nn.ModuleList(blocks)
        self.final_attn = final_attn
        self.mask_zero = mask_zero

    @classmethod
    def create(cls, generator, info_dim: int, embedding_dim: int,
               hidden_dim: int = 40, num_blocks: int = 2,
               mask_zero: bool = True, activation: str = "relu",
               attention: str = "fused", device=None) -> "ParticleEmbedding":
        device = default_device(device)
        info_net = Dense.create(generator, info_dim, embedding_dim,
                                device=device)
        blocks: List[AttentionBlock] = [
            AttentionBlock.create(generator, embedding_dim, hidden_dim,
                                  activation, attention, device)
            for _ in range(num_blocks)]
        final = _make_attention(attention, generator, embedding_dim,
                                embedding_dim, hidden_dim, True, activation,
                                device)
        return cls(info_net, blocks, final, mask_zero)

    def forward(self, coords: Tensor, particle_info: Tensor,
                mask: Optional[Tensor] = None) -> Tensor:
        if mask is None and self.mask_zero:
            mask = (coords != 0.0).any(-1)
        embedding = self.info_net(particle_info)
        for block in self.blocks:
            embedding = block(coords, embedding, mask)
        return self.final_attn(coords, embedding, mask)


class LocalParticleDescriptors(nn.Module):
    """DistanceSelection, then an embedding of the selected particles."""

    def __init__(self, select: DistanceSelection, embed: Any):
        super().__init__()
        self.select = select
        self.embed = embed

    def forward(self, coords: Tensor, ref: Tensor, particle_info: Tensor,
                mask: Optional[Tensor] = None,
                box_lengths: Optional[Tensor] = None) -> Tensor:
        sel, valid, sel_info = self.select(coords, ref, mask=mask,
                                           particle_info=particle_info,
                                           box_lengths=box_lengths)
        return self.embed(sel, sel_info, mask=valid)

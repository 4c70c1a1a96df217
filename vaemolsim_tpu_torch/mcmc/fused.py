"""The whole VAE proposal in one kernel (port of
``vaemolsim_tpu/mcmc/fused.py``).

For the flagship model family (1-hidden-layer FCDeepNN normal encoder
and decoder, a 1-D latent, a constant-spline RQS MAF prior over a
diagonal-normal base) one call draws

    z1 ~ q(.|x1),  z2 ~ p(.),  x2 ~ q(.|z2)

and returns x2, the forward and reverse log-densities

    forward = log q(z1|x1) + log p(z2) + log q(x2|z2)
    reverse = log q(z2|x2) + log p(z1) + log q(x1|z1)

and (z1, z2).  On a CUDA tensor it is the kernel ``csrc/vae_proposal.cu``;
on the CPU, :func:`vae_proposal_plain`.  Both draw their normals from
the same Philox4x32-10 stream (key = the two seed words, counter =
(chain, draw)), so on the same seed they compute the same proposal up to
float32 rounding.  ``noise=`` feeds given normals instead.

Target evaluation and the Metropolis accept/reject stay in PyTorch, so
``log_target_fn`` is any callable.  :func:`make_fused_vae_step` raises
:class:`UnsupportedModelError` for a model outside the family; use
``mcmc.make_mcmc_step`` for those.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, NamedTuple, Optional

import torch

from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.dists.layers import _positive
from vaemolsim_tpu_torch.mcmc.engine import MCMCState, apply_mh, log_uniform
from vaemolsim_tpu_torch.nn.core import resolve_activation
from vaemolsim_tpu_torch.ops.distributions import Independent, Normal
from vaemolsim_tpu_torch.ops.rqs import (rqs_forward_plain, rqs_inverse_plain,
                                         table_floats)

Tensor = torch.Tensor

__all__ = ["make_fused_vae_step", "fused_vae_proposal", "vae_proposal_plain",
           "vae_proposal_cuda", "kernel_plan", "philox4x32_10",
           "UnsupportedModelError", "KERNEL"]

KERNEL = _build.Kernel(
    "vae_proposal", "csrc/vae_proposal.cu", "vae_proposal_launch",
    [ctypes.c_void_p] * 20 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 6
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2,
    replaces="vaemolsim_tpu/mcmc/fused.py:185")

_ACT_CODES = {"tanh": 1, "relu": 2}
MAX_DX = 8  # the d_x instantiations in csrc/vae_proposal.cu
# The H100's SMs and the most dynamic shared memory a block may take.
_SMS, _MAX_SMEM = 132, 232448


def kernel_plan(n: int, d_x: int, H: int, B: int, K: int) -> dict:
    """How ``csrc/vae_proposal.cu`` runs a call, decided here and only
    validated by the kernel's launch.  ``R`` chains a lane group of R
    lanes (4 for d_x <= 4, 2 above, where the decoder's 2 d_x head sums
    per chain fill the registers); chain i runs on thread i, so a group
    is R neighbouring lanes of one warp.  Hidden units are padded
    to ``units``, a multiple of 2R (a lane's last step takes two).
    ``threads`` a block: the largest of 128, 64, 32 that still makes a
    block per SM (``blocks`` >= 132), else 32.  ``smem``: bytes of the
    unit records (``enc``, ``dec`` floats a unit), B knot tables, the raw
    spline rows and the head biases; ``refused`` where they exceed a
    block's shared memory."""
    R = 4 if d_x <= 4 else 2
    units = -(-H // (2 * R)) * 2 * R
    enc, dec = (3 + d_x + 3) & ~3, (2 + 2 * d_x + 3) & ~3
    smem = 4 * (units * (enc + dec) + B * (table_floats(K) + 3 * K - 1)
                + 2 + 2 * d_x)
    threads = next((t for t in (128, 64, 32) if -(-n // t) >= _SMS), 32)
    return dict(R=R, units=units, enc=enc, dec=dec, threads=threads,
                blocks=-(-n // threads), smem=smem,
                refused=smem > _MAX_SMEM)


class UnsupportedModelError(ValueError):
    """The VAE is outside the fused kernel's model family."""


class _Spec(NamedTuple):
    d_x: int
    d_z: int
    enc_act: str
    dec_act: str
    num_bins: int
    range_min: float


# ---------------------------------------------------------------------------
# Philox4x32-10 (Salmon et al. 2011), on int64 tensors holding 32-bit words
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF


def _mulhilo(a: Tensor, m: int):
    """(hi, lo) 32-bit words of a * m, with no int64 overflow."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    lo_full = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (lo_full >> 32)) & _MASK, lo_full & _MASK


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """The four output words of Philox4x32-10 for counter (c0..c3) and
    key (k0, k1), each an int64 tensor (or int) of 32-bit values."""
    for r in range(10):
        if r:
            k0 = (k0 + 0x9E3779B9) & _MASK
            k1 = (k1 + 0xBB67AE85) & _MASK
        hi0, lo0 = _mulhilo(c0, 0xD2511F53)
        hi1, lo1 = _mulhilo(c2, 0xCD9E8D57)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _philox_normals(seed: Tensor, n: int, n_noise: int,
                    chain0: int = 0) -> Tensor:
    """(n, n_noise) standard normals, the kernel's stream: chain i's word
    w is lane w % 4 of Philox call (chain0 + i, w // 4); pair j takes
    u1 = word j and u2 = word n_pair + j through Box-Muller."""
    n_pair = (n_noise + 1) // 2
    key = seed.to(torch.int64) & _MASK
    chain = torch.arange(chain0, chain0 + n, dtype=torch.int64,
                         device=seed.device) & _MASK
    zero = torch.zeros_like(chain)
    words = []
    for c in range((2 * n_pair + 3) // 4):
        words += philox4x32_10(chain, torch.full_like(chain, c), zero, zero,
                               key[0], key[1])

    def unit(w):  # top 24 bits -> (0, 1)
        return (w >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25

    r = torch.stack([torch.sqrt(-2.0 * torch.log(unit(words[j])))
                     for j in range(n_pair)], -1)
    theta = torch.stack([2.0 * math.pi * unit(words[n_pair + j])
                         for j in range(n_pair)], -1)
    return torch.cat([r * torch.cos(theta), r * torch.sin(theta)],
                     -1)[:, :n_noise]


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _mlp(x, w1, b1, w2, b2, act):
    """One-hidden-layer trunk + linear head, input terms added in order."""
    h = b1
    for i in range(w1.shape[0]):
        h = h + x[:, i:i + 1] * w1[i]
    return resolve_activation(act)(h) @ w2 + b2


def _normal_params(raw: Tensor):
    """Per-DOF interleaved (loc, raw_scale) -> loc, softplus + eps (the
    IndependentBlockwise normal family)."""
    return raw[:, 0::2], _positive(raw[:, 1::2])


def _normal_logprob(x, loc, scale):
    return Normal(loc, scale).log_prob(x).sum(-1)


def vae_proposal_plain(x1: Tensor, seed: Tensor, enc_w, dec_w,
                       spline_tables, base_params: Tensor, spec: _Spec,
                       noise: Optional[Tensor] = None, chain0: int = 0):
    """The proposal in plain PyTorch; returns (x2, forward, reverse, z1,
    z2).  Without ``noise`` it draws the kernel's Philox stream, row i
    as global chain ``chain0 + i``."""
    d_z = spec.d_z
    if noise is None:
        noise = _philox_normals(seed, x1.shape[0], 2 * d_z + spec.d_x,
                                chain0)
    sw, sh, ss = spline_tables
    loc, scale = base_params[0], base_params[1]

    def flow(v, inverse):
        ldj = 0.0
        for b in (reversed(range(sw.shape[0])) if inverse
                  else range(sw.shape[0])):
            fn = rqs_inverse_plain if inverse else rqs_forward_plain
            v, l = fn(v, sw[b:b + 1], sh[b:b + 1], ss[b:b + 1],
                      spec.range_min)
            ldj = ldj + l.sum(-1)
        return v, ldj

    mu, sig = _normal_params(_mlp(x1, *enc_w, spec.enc_act))
    z1 = mu + sig * noise[:, :d_z]
    u = loc + scale * noise[:, d_z:2 * d_z]
    z2, fldj = flow(u, False)
    mu_x, sig_x = _normal_params(_mlp(z2, *dec_w, spec.dec_act))
    x2 = mu_x + sig_x * noise[:, 2 * d_z:]
    fwd = (_normal_logprob(z1, mu, sig)
           + _normal_logprob(u, loc, scale) - fldj
           + _normal_logprob(x2, mu_x, sig_x))

    u1, ildj = flow(z1, True)
    rev = (_normal_logprob(z2, *_normal_params(_mlp(x2, *enc_w,
                                                    spec.enc_act)))
           + _normal_logprob(u1, loc, scale) + ildj
           + _normal_logprob(x1, *_normal_params(_mlp(z1, *dec_w,
                                                      spec.dec_act))))
    return x2, fwd, rev, z1, z2


# ---------------------------------------------------------------------------
# Kernel wrapper and dispatch
# ---------------------------------------------------------------------------


def vae_proposal_cuda(x1: Tensor, seed: Tensor, enc_w, dec_w, spline_tables,
                      base_params: Tensor, spec: _Spec,
                      noise: Optional[Tensor] = None, chain0: int = 0):
    """Launch ``csrc/vae_proposal.cu``; returns (x2, forward, reverse,
    z1, z2).  Row i draws the Philox stream of global chain
    ``chain0 + i``."""
    if spec.d_z != 1 or not 1 <= spec.d_x <= MAX_DX:
        raise ValueError(f"the proposal kernel takes d_z = 1 and "
                         f"1 <= d_x <= {MAX_DX}, got {spec}")
    if spec.enc_act not in _ACT_CODES or spec.dec_act not in _ACT_CODES:
        raise ValueError(f"the proposal kernel takes relu or tanh, got {spec}")
    req = _build.require
    n, d_x = x1.shape
    if d_x != spec.d_x:
        raise ValueError(f"x1 has {d_x} DOFs, the spec {spec.d_x}")
    H = enc_w[0].shape[1]
    B, K = spline_tables[0].shape
    x1 = req(x1, "x1")
    seed = req(seed, "seed", (2,), torch.int32)
    if noise is not None:
        noise = req(noise, "noise", (n, 2 + d_x))
    ew = [req(t.detach(), f"encoder[{i}]", s) for i, (t, s) in enumerate(
        zip(enc_w, [(d_x, H), (H,), (H, 2), (2,)]))]
    dw = [req(t.detach(), f"decoder[{i}]", s) for i, (t, s) in enumerate(
        zip(dec_w, [(1, H), (H,), (H, 2 * d_x), (2 * d_x,)]))]
    tables = [req(t.detach(), name, s) for t, name, s in zip(
        spline_tables, ("widths", "heights", "slopes"),
        [(B, K), (B, K), (B, K - 1)])]
    base = req(base_params.detach(), "base_params", (2,))
    plan = kernel_plan(n, d_x, H, B, K)
    if plan["refused"]:
        raise ValueError(f"the proposal kernel does not take H = {H}, "
                         f"B = {B}, K = {K}: {plan['smem']} bytes of shared "
                         f"memory, more than the card's {_MAX_SMEM}")
    x2 = torch.empty_like(x1)
    fwd, rev, z1, z2 = (torch.empty(s, dtype=torch.float32, device=x1.device)
                        for s in ((n,), (n,), (n, 1), (n, 1)))
    KERNEL.launch(x1.device, x1.data_ptr(), seed.data_ptr(),
                  _build.ptr(noise), *[t.data_ptr() for t in ew + dw + tables],
                  base.data_ptr(), x2.data_ptr(), fwd.data_ptr(),
                  rev.data_ptr(), z1.data_ptr(), z2.data_ptr(), n,
                  int(chain0), d_x, H, B,
                  K, _ACT_CODES[spec.enc_act], _ACT_CODES[spec.dec_act],
                  float(spec.range_min), plan["R"], plan["threads"],
                  plan["blocks"], plan["smem"],
                  outputs=(x2, fwd, rev, z1, z2))
    return x2, fwd, rev, z1, z2


def fused_vae_proposal(x1: Tensor, seed: Tensor, enc_w, dec_w, spline_tables,
                       base_params: Tensor, spec: _Spec,
                       noise: Optional[Tensor] = None, chain0: int = 0):
    """The proposal over all chains: the kernel on CUDA, the plain version
    on the CPU.  ``seed``: (2,) int32 Philox key words; ``noise``:
    optional (N, 2*d_z + d_x) standard normals to use instead of the
    Philox stream; ``chain0``: the global index of row 0 (a rank's first
    chain), the Philox counter of each row being its global chain.
    Returns (x2, forward_log_p, reverse_log_p, z1, z2)."""
    fn = vae_proposal_cuda if x1.is_cuda else vae_proposal_plain
    return fn(x1, seed, enc_w, dec_w, spline_tables, base_params, spec,
              noise, chain0)


# ---------------------------------------------------------------------------
# Model extraction and step wiring
# ---------------------------------------------------------------------------


def _require(cond, what):
    if not cond:
        raise UnsupportedModelError(
            f"fused VAE step requires {what}; use mcmc.make_mcmc_step for "
            f"general models")


def _extract_mlp(m2d, label):
    """((w1, b1, w2, b2), activation, in_dim, out_dofs) of a
    MappingToDistribution with a 1-hidden-layer FCDeepNN and an
    all-normal IndependentBlockwise."""
    from vaemolsim_tpu_torch.dists import IndependentBlockwise
    from vaemolsim_tpu_torch.nn.mappings import FCDeepNN

    mapping, dist = m2d.mapping, m2d.dist
    _require(isinstance(mapping, FCDeepNN), f"{label}: FCDeepNN mapping")
    _require(len(mapping.layers) == 1 and not mapping.batch_norm
             and not any(mapping.periodic_mask),
             f"{label}: single plain hidden layer")
    act = mapping.layers[0].activation or "linear"
    _require(act in _ACT_CODES, f"{label}: relu/tanh activation")
    _require(isinstance(dist, IndependentBlockwise)
             and all(f == "normal" for f in dist.families),
             f"{label}: all-normal IndependentBlockwise")
    lyr, head = mapping.layers[0], mapping.head
    _require(head.activation in (None, "linear"), f"{label}: linear head")
    return ((lyr.kernel, lyr.bias, head.kernel, head.bias), act,
            lyr.kernel.shape[0], dist.num_dofs)


def _extract_prior(prior):
    """(tables_fn, base_params): ``tables_fn()`` gives the constant spline
    tables ((B, K), (B, K), (B, K-1)) and range_min of a
    StaticFlowedDistribution(1-D RQSSplineMAF, diagonal-normal base)."""
    from vaemolsim_tpu_torch.dists import StaticFlowedDistribution
    from vaemolsim_tpu_torch.flows import RQSSplineMAF

    _require(isinstance(prior, StaticFlowedDistribution),
             "a StaticFlowedDistribution prior")
    flow = prior.flow
    _require(isinstance(flow, RQSSplineMAF) and flow.data_dim == 1
             and not flow.conditional and not flow.bn_params
             and flow.before_flow_transform is None
             and flow.after_flow_transform is None,
             "a plain 1-D unconditional RQSSplineMAF prior flow")
    base = prior.base
    _require(isinstance(base, Independent)
             and isinstance(base.base, Normal),
             "an Independent(Normal) base")
    loc, scale = prior.base_loc.reshape(-1), prior.base_scale.reshape(-1)
    _require(loc.shape == (1,) and scale.shape == (1,),
             "a 1-D diagonal-normal base")

    def tables():
        splines = [blk._spline(torch.zeros((1, 1), device=loc.device), None)
                   for blk in flow.blocks]
        return (tuple(torch.stack([getattr(s, a).reshape(-1)
                                   for s in splines])
                      for a in ("bin_widths", "bin_heights", "knot_slopes")),
                splines[0].range_min)

    return tables, torch.cat([loc, scale])


def make_fused_vae_step(vae, log_target_fn: Callable[[Tensor], Tensor]
                        ) -> Callable[[MCMCState], MCMCState]:
    """An MCMCState -> MCMCState step for the flagship model family,
    through :func:`fused_vae_proposal`.  Raises
    :class:`UnsupportedModelError` for other models.

    On a sharded state (``parallel.shard_chain_state``) every rank draws
    the Philox key and the accept uniforms of all the global chains from
    the replicated generator and takes its chains' share, the kernel
    drawing each chain's normals by its global index: a sharded run
    equals the one-device run bit for bit."""
    enc_w, enc_act, enc_in, d_z = _extract_mlp(vae.encoder, "encoder")
    dec_w, dec_act, dec_in, d_x = _extract_mlp(vae.decoder, "decoder")
    _require(dec_in == d_z and enc_in == d_x,
             "encoder/decoder dims forming an autoencoder")
    _require(d_z == 1, "a 1-D latent (constant-spline prior)")
    tables_fn, base_params = _extract_prior(vae.prior)

    @torch.no_grad()
    def step(state: MCMCState) -> MCMCState:
        gen, x1, shard = state.generator, state.configs, state.shard
        # Two full 32-bit key words per step: a ~64-bit seed space.
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gen,
                             dtype=torch.int32, device=x1.device)
        tables, range_min = tables_fn()
        spec = _Spec(d_x, d_z, enc_act, dec_act, tables[0].shape[-1],
                     float(range_min))
        x2, fwd, rev, _, _ = fused_vae_proposal(
            x1, seed, enc_w, dec_w, tables, base_params, spec,
            chain0=0 if shard is None else shard.starts[0])
        e2 = log_target_fn(x2)
        log_acc = (e2 - state.energies) + rev - fwd
        n_all = x1.shape[0] if shard is None else shard.totals[0]
        log_u = log_uniform(gen, (n_all,), log_acc.dtype, log_acc.device)
        accept = log_acc >= (log_u if shard is None else shard.local(log_u))
        return apply_mh(state, x2, e2, accept)

    return step

"""Weighted-ensemble (WE) rare-event sampling (port of
``vaemolsim_tpu/we.py``).

Weighted walkers advance by unbiased dynamics, and a split/merge
resampling pass equalizes walker counts across bins of a progress
coordinate (Huber & Kim 1996; Zuckerman & Chong 2017).  With recycling
at a target state, the mean recycled weight per iteration is the
steady-state rate (the Hill relation).

The walkers live in a fixed ``(n_bins * m_per_bin,)`` slot axis (weight 0
= empty slot) and the per-bin resampling is one vectorized systematic
pass, so an iteration has fixed shapes and no host read: :func:`run_we`
runs the iterations through :func:`scan_collect`, replayed as a captured
CUDA graph on the card.  Walkers are a tensor or a tuple of tensors
(positions and velocities, say) whose leading axis is the slot axis;
``propagate_fn(walkers, generator)``, ``bin_fn(walkers)`` and
``recycle_fn(walkers)`` receive them whole.  A propagator that runs a
Langevin segment uses ``md``'s shared runner (``md._BAOAB``), whose
constants are made once per device: ``md.baoab`` copies its step and
masses from the host on every call, which a capture refuses.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from vaemolsim_tpu_torch.utils.scan import _leaves, _rebuild, scan_collect

Tensor = torch.Tensor

__all__ = ["WEState", "we_init", "make_we_step", "run_we"]


class WEState(NamedTuple):
    """Fixed-slot walker population: ``x`` walker state (leading slot axis
    ``S = n_bins * m_per_bin``); ``w`` (S,) weights summing to 1 (0 =
    empty slot); ``flux`` the accumulated recycled weight; ``n_iters``
    completed iterations (int32).  The JAX package's key is the
    generator handed to :func:`run_we`."""

    x: Any
    w: Tensor
    flux: Tensor
    n_iters: Tensor

    @property
    def rate(self) -> Tensor:
        """Hill-relation rate: mean recycled weight per iteration."""
        return self.flux / torch.clamp(self.n_iters.to(self.w.dtype),
                                       min=1.0)


def _map(fn, *trees):
    """``fn`` over the tensors of same-structured walker states."""
    cols = zip(*(_leaves(t) for t in trees))
    return _rebuild(trees[0], iter([fn(*c) for c in cols]))


def we_init(x0: Any, n_bins: int, m_per_bin: int,
            weights: Optional[Tensor] = None) -> WEState:
    """Start from ``k <= n_bins * m_per_bin`` seed walkers (leading axis
    ``k``): they fill the first slots with uniform (or the given,
    normalized) weights; the other slots are empty copies of the first
    seed.  The first resampling spreads them over the bins."""
    first = _leaves(x0)[0]
    k = first.shape[0]
    S = n_bins * m_per_bin
    if k > S:
        raise ValueError(f"{k} seeds > {S} slots")
    if weights is None:
        w0 = torch.full((k,), 1.0 / k, dtype=first.dtype,
                        device=first.device)
    else:
        w0 = torch.as_tensor(weights, device=first.device)
        w0 = w0 / w0.sum()

    def pad(a):
        return torch.cat([a, a[:1].expand((S - k,) + a.shape[1:])], 0)

    x = _map(pad, x0)
    w = torch.cat([w0, torch.zeros(S - k, dtype=w0.dtype,
                                   device=w0.device)])
    return WEState(x=x, w=w, flux=torch.zeros((), dtype=w0.dtype,
                                              device=w0.device),
                   n_iters=torch.zeros((), dtype=torch.int32,
                                       device=w0.device))


def _xla_cumsum(a: Tensor, block: int = 16) -> Tensor:
    """Inclusive prefix sum over the last axis in XLA's order on the CPU:
    left to right within blocks of 16, plus the prefix of the block
    totals, taken the same way recursively.  ``torch.cumsum`` rounds
    otherwise, and a different rounding selects a different walker at a
    bin boundary."""
    n = a.shape[-1]
    if n <= block:
        sums = [a[..., 0]]
        for k in range(1, n):
            sums.append(sums[-1] + a[..., k])
        return torch.stack(sums, -1)
    nb = -(-n // block)
    pad = torch.nn.functional.pad(a, (0, nb * block - n))
    rows = pad.reshape(a.shape[:-1] + (nb, block))
    p = _xla_cumsum(rows, block)
    totals = _xla_cumsum(p[..., -1], block)
    carry = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (p + carry[..., None]).reshape(pad.shape)[..., :n]


def _systematic_resample(x: Any, w: Tensor, bins: Tensor, n_bins: int,
                         m_per_bin: int, u0: Tensor) -> Tuple[Any, Tensor]:
    """Per-bin systematic resampling over the flat slot axis: every bin
    with total weight ``W_b > 0`` keeps ``m_per_bin`` walkers chosen with
    multiplicity proportional to weight, each of weight ``W_b /
    m_per_bin``.  ``u0`` (n_bins, 1): the offsets, uniform in [1e-6,
    1)."""
    S = w.shape[0]
    onehot = bins[None, :] == torch.arange(n_bins, device=w.device)[:, None]
    w_in = torch.where(onehot, w[None, :], 0.0)
    csum = _xla_cumsum(w_in)
    # The bin total is the cumsum's own last entry: pts * W_b <= W_b then
    # holds exactly, so a point never selects a slot of another bin.
    W_b = csum[:, -1]
    # XLA compiles a division by the constant m_per_bin into a product
    # with its float32 reciprocal: the same rounding here.
    inv_m = 1.0 / m_per_bin
    pts = (torch.arange(m_per_bin, device=w.device)[None, :] + u0) * inv_m
    target = pts * W_b[:, None]
    idx = (csum[:, None, :] < target[:, :, None]).sum(-1)
    flat = torch.clamp(idx, 0, S - 1).reshape(-1)
    new_x = _map(lambda a: a.index_select(0, flat), x)
    new_w = torch.where(W_b[:, None] > 0.0, W_b[:, None] * inv_m,
                        0.0).expand(n_bins, m_per_bin)
    return new_x, new_w.reshape(-1)


def _draw_u0(generator: torch.Generator, n_bins: int, like: Tensor
             ) -> Tensor:
    """The resampling offsets, uniform in [1e-6, 1), (n_bins, 1)."""
    u = torch.rand((n_bins, 1), generator=generator, dtype=like.dtype,
                   device=like.device)
    return 1e-6 + (1.0 - 1e-6) * u


def make_we_step(propagate_fn: Callable[[Any, torch.Generator], Any],
                 bin_fn: Callable[[Any], Tensor], *,
                 n_bins: int, m_per_bin: int,
                 target_bin: Optional[int] = None,
                 recycle_fn: Optional[Callable[[Any], Any]] = None
                 ) -> Callable[[WEState, torch.Generator], WEState]:
    """One WE iteration, ``step(state, generator)``: propagate, recycle
    at ``target_bin`` (the arrivals' weight goes into ``flux`` and they
    re-enter at ``recycle_fn(x)`` with their weight), then split/merge.

    ``bin_fn(x)`` maps walkers to bins in ``[0, n_bins)``.
    ``step.move(state, u0, generator)`` makes the iteration on given
    resampling offsets (``generator`` then only feeds the propagator):
    what tests hand the JAX package's draws to."""
    if target_bin is not None and recycle_fn is None:
        raise ValueError("recycling a target requires recycle_fn "
                         "(where does the probability re-enter?)")

    def move(state: WEState, u0: Tensor,
             generator: Optional[torch.Generator] = None) -> WEState:
        x = propagate_fn(state.x, generator)
        return resample(state, x, u0)

    def resample(state: WEState, x: Any, u0: Tensor) -> WEState:
        bins = bin_fn(x).to(torch.int32)
        flux = state.flux
        if target_bin is not None:
            hit = bins == target_bin
            flux = flux + torch.where(hit, state.w, 0.0).sum()
            x = _map(lambda new, old: torch.where(
                hit.reshape((-1,) + (1,) * (old.dim() - 1)), new, old),
                recycle_fn(x), x)
            bins = torch.where(hit, bin_fn(x).to(torch.int32), bins)
        new_x, new_w = _systematic_resample(x, state.w, bins, n_bins,
                                            m_per_bin, u0)
        return WEState(x=new_x, w=new_w, flux=flux,
                       n_iters=state.n_iters + 1)

    def step(state: WEState, generator: torch.Generator) -> WEState:
        x = propagate_fn(state.x, generator)
        return resample(state, x, _draw_u0(generator, n_bins, state.w))

    step.move = move
    return step


def run_we(step_fn: Callable[[WEState, torch.Generator], WEState],
           state: WEState, generator: torch.Generator, n_iters: int, *,
           collect_every: int = 0
           ) -> Tuple[WEState, Optional[Tuple[Any, Tensor]]]:
    """``n_iters`` WE iterations drawing from ``generator``; with
    ``collect_every = k`` also ``(xs, ws)`` snapshots every k-th
    iteration.  On the card each iteration is one captured graph,
    replayed: an iteration is already a segment of steps, and a longer
    chunk's warm-up and capture would run it eagerly many times."""
    return scan_collect(lambda s: step_fn(s, generator), state, n_iters,
                        collect_every=collect_every,
                        snapshot_fn=lambda s: (s.x, s.w), chunk=1,
                        generators=(generator,))

"""Transition path sampling (port of ``vaemolsim_tpu/mcmc/tps.py``).

Monte Carlo in the space of reactive trajectories (Bolhuis, Chandler,
Dellago & Geissler 2002): fixed-length Langevin paths that start in A
and end in B, moved by shooting.

- ``mode="one_way"``: pick a frame j, regenerate the future from ``z_j``
  with fresh noise, or (a fair coin) the past with flipped velocities;
  accept on the endpoint indicator ``h_B`` (forward) or ``h_A``
  (backward).
- ``mode="two_way"``: a Maxwell velocity redraw at j, both directions
  integrated and spliced; accept on ``h_A h_B``.

A path is a fixed ``(n_frames, n_atoms, dim)`` tensor of positions and
velocities, and every shooting move integrates exactly ``n_frames - 1``
BAOAB steps whatever j and the direction (the splice is a gather with
computed indices), so the walkers batch and a whole sweep has fixed
shapes: :func:`run_tps` replays captured sweeps on the card.  The
shooting runs go through ``md``'s shared runner (``md._BAOAB``), the
operations of ``md.baoab`` in its order under :func:`scan_collect`.  A
step draws its moves with ``step.draw(state, generator)`` and makes them
with ``step.move(state, draws)``, which is what tests hand the JAX
package's draws to.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from vaemolsim_tpu_torch import md
from vaemolsim_tpu_torch.md import _BAOAB
from vaemolsim_tpu_torch.utils.scan import chunk_size, scan_collect

Tensor = torch.Tensor

__all__ = ["TPSState", "tps_init", "make_tps_step", "run_tps",
           "reactive_windows", "first_hitting_committor"]


class TPSState(NamedTuple):
    """W walkers, each one reactive path: positions ``path`` (W, n_frames,
    n_atoms, dim), velocities ``vel``, and int32 shooting counters."""

    path: Tensor
    vel: Tensor
    n_acc: Tensor       # (W,) int32
    n_trials: Tensor    # (W,) int32

    @property
    def acceptance_rate(self) -> Tensor:
        return self.n_acc / torch.clamp(self.n_trials, min=1)


def tps_init(path: Tensor, *, vel: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None, kt: float = 1.0,
             masses=1.0) -> TPSState:
    """Wrap seed paths (W, n_frames, n_atoms, dim), each reactive under the
    caller's ``in_a`` / ``in_b``.  Seed velocities: ``vel``, or
    Maxwell-Boltzmann placeholders from ``generator`` (not consistent
    with the positions: burn in until every frame was regenerated)."""
    if path.dim() != 4:
        raise ValueError(
            "tps_init expects (walkers, n_frames, n_atoms, dim), got "
            f"shape {tuple(path.shape)}")
    if vel is None:
        if generator is None:
            raise ValueError("pass seed velocities or a generator to draw "
                             "Maxwell-Boltzmann placeholders")
        vel = torch.sqrt(kt / md._masses_arr(masses, path)) * md._normal(
            generator, path)
    zeros = torch.zeros(path.shape[0], dtype=torch.int32,
                        device=path.device)
    return TPSState(path=path, vel=vel, n_acc=zeros, n_trials=zeros)


def make_tps_step(potential: Callable[[Tensor], Tensor], *,
                  in_a: Callable[[Tensor], Tensor],
                  in_b: Callable[[Tensor], Tensor],
                  dt: float, kt: float, friction: float = 1.0,
                  masses=1.0, mode: str = "one_way"
                  ) -> Callable[[TPSState, torch.Generator], TPSState]:
    """One shooting sweep over all walkers: ``step(state, generator)``.

    ``in_a(x)`` / ``in_b(x)``: basin indicators over (..., n_atoms, dim)
    -> (...,) bool, written without host reads (a sweep is captured on
    the card).  ``potential``, ``dt``, ``kt``, ``friction``, ``masses``
    follow ``md.baoab``.  ``step.draw(state, generator)`` gives the
    sweep's draws (one-way: ``j``, ``forward``, ``noise``; two-way:
    ``j``, ``z_v``, ``noise_f``, ``noise_b``), ``step.move(state,
    draws)`` makes the sweep on them."""
    if mode not in ("one_way", "two_way"):
        raise ValueError(f"unknown mode {mode!r}")
    dyn = _BAOAB(potential, dt=dt, kt=kt, friction=friction, masses=masses)

    def run(x0, v0, noise):
        tx, tv = dyn.run(x0, v0, noise.shape[0], noise, collect_v=True)
        return tx.movedim(0, 1), tv.movedim(0, 1)

    def gather(a, idx):
        """a[w, idx[w]] for each walker: (W, F, ...)."""
        return a[torch.arange(a.shape[0], device=a.device)[:, None], idx]

    def accept(state, new_x, new_v, ok):
        keep = ok.reshape((-1,) + (1,) * (state.path.dim() - 1))
        return TPSState(
            path=torch.where(keep, new_x, state.path),
            vel=torch.where(keep, new_v, state.vel),
            n_acc=state.n_acc + ok.to(torch.int32),
            n_trials=state.n_trials + 1)

    def draw(state: TPSState, generator: torch.Generator) -> dict:
        path = state.path
        w, t = path.shape[0], path.shape[1] - 1
        kw = dict(generator=generator, device=path.device)
        noise_shape = (t, w) + tuple(path.shape[2:])
        j = torch.randint(1, t, (w,), **kw)
        if mode == "one_way":
            return dict(j=j, forward=torch.rand((w,), **kw) < 0.5,
                        noise=torch.randn(noise_shape, dtype=path.dtype,
                                          **kw))
        return dict(j=j, z_v=torch.randn((w,) + tuple(path.shape[2:]),
                                         dtype=path.dtype, **kw),
                    noise_f=torch.randn(noise_shape, dtype=path.dtype, **kw),
                    noise_b=torch.randn(noise_shape, dtype=path.dtype, **kw))

    def move_one_way(state: TPSState, d: dict) -> TPSState:
        path, vel = state.path, state.vel
        n_frames = path.shape[1]
        j, forward = d["j"], d["forward"]
        rows = torch.arange(path.shape[0], device=path.device)
        xj, vj = path[rows, j], vel[rows, j]
        sign0 = torch.where(forward, 1.0, -1.0)[:, None, None]
        tx, tv = run(xj, sign0 * vj, d["noise"])            # (W, t, n, d)
        # Splice: keep the untouched side, gather the fresh segment
        # (time-reversed with flipped velocities for backward shots).
        i = torch.arange(n_frames, device=path.device)[None]
        jj = j[:, None]
        fwd_idx = torch.where(i <= jj, i, n_frames + i - jj - 1)
        bwd_idx = torch.where(i >= jj, i, n_frames + jj - i - 1)
        idx = torch.where(forward[:, None], fwd_idx, bwd_idx)
        new_x = gather(torch.cat([path, tx], 1), idx)
        new_v = gather(torch.cat([vel, tv], 1), idx)
        flip = (~forward[:, None]) & (i < jj)
        new_v = torch.where(flip[..., None, None], -new_v, new_v)
        ok = torch.where(forward, in_b(new_x[:, -1]), in_a(new_x[:, 0]))
        return accept(state, new_x, new_v, ok)

    def move_two_way(state: TPSState, d: dict) -> TPSState:
        path = state.path
        n_frames = path.shape[1]
        t = n_frames - 1
        j = d["j"]
        xj = path[torch.arange(path.shape[0], device=path.device), j]
        m = dyn.consts(xj)[0]
        v = torch.sqrt(dyn.kt / m) * d["z_v"]
        fx, fv = run(xj, v, d["noise_f"])
        bx, bv = run(xj, -v, d["noise_b"])
        sx = torch.cat([bx, xj[:, None], fx], 1)
        sv = torch.cat([-bv, v[:, None], fv], 1)
        i = torch.arange(n_frames, device=path.device)[None]
        jj = j[:, None]
        idx = torch.where(i < jj, jj - i - 1, t + i - jj)
        new_x, new_v = gather(sx, idx), gather(sv, idx)
        ok = in_a(new_x[:, 0]) & in_b(new_x[:, -1])
        return accept(state, new_x, new_v, ok)

    move = move_one_way if mode == "one_way" else move_two_way

    def step(state: TPSState, generator: torch.Generator) -> TPSState:
        return move(state, draw(state, generator))

    step.draw, step.move = draw, move
    return step


def run_tps(step_fn: Callable[[TPSState, torch.Generator], TPSState],
            state: TPSState, generator: torch.Generator, n_steps: int, *,
            collect_every: int = 0
            ) -> Tuple[TPSState, Optional[Tensor]]:
    """``n_steps`` shooting sweeps (on the card, each sweep one captured
    graph, replayed); with ``collect_every`` also the position ensemble
    (n_steps // collect_every, W, n_frames, n_atoms, dim)."""
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")
    return scan_collect(
        lambda s: step_fn(s, generator), state, n_steps,
        collect_every=collect_every, snapshot_fn=lambda s: s.path,
        chunk=chunk_size(n_steps, collect_every,
                         step_cost=state.path.shape[1] - 1),
        generators=(generator,))


def reactive_windows(traj: Tensor, *, n_frames: int,
                     in_a: Callable[[Tensor], Tensor],
                     in_b: Callable[[Tensor], Tensor],
                     max_windows: int) -> Tuple[Tensor, Tensor]:
    """Every length-``n_frames`` window of a long trajectory (T, n_atoms,
    dim) that starts in A and ends in B, the fixed-length reactive path
    measure TPS samples: ``(windows (max_windows, n_frames, ...), valid
    (max_windows,))``, the first ``max_windows`` reactive starts, padded
    with repeats of the first (masked out by ``valid``)."""
    t_total = traj.shape[0]
    n_starts = t_total - n_frames + 1
    if n_starts <= 0:
        raise ValueError("trajectory shorter than one window")
    start_ok = in_a(traj[:n_starts]) & in_b(traj[n_frames - 1:])
    ar = torch.arange(n_starts, device=traj.device)
    order = torch.argsort(torch.where(start_ok, ar, n_starts + ar),
                          stable=True)
    idx = order[:max_windows]
    valid = start_ok[idx]
    safe = torch.where(valid, idx, idx[0])
    offsets = torch.arange(n_frames, device=traj.device)
    return traj[safe[:, None] + offsets[None, :]], valid


def first_hitting_committor(potential: Callable[[Tensor], Tensor],
                            x0: Tensor, *,
                            in_a: Callable[[Tensor], Tensor],
                            in_b: Callable[[Tensor], Tensor],
                            generator: Optional[torch.Generator] = None,
                            n_shots: int, max_steps: int,
                            dt: float, kt: float, friction: float = 1.0,
                            masses=1.0,
                            noise: Optional[Tuple[Tensor, Tensor]] = None
                            ) -> Tuple[Tensor, Tensor]:
    """Monte Carlo committor ``q(x) = P(reach B before A | x)``: from each
    configuration in ``x0`` (B, n_atoms, dim), ``n_shots`` BAOAB runs of
    up to ``max_steps`` steps with fresh Maxwell velocities, each labelled
    by the basin it hits first.  Returns ``(q (B,), frac_unresolved
    (B,))``: unresolved shots leave ``q``'s denominator, and ``q`` is NaN
    where none resolved.  Draws from ``generator``, or ``noise = (velocity
    normals (B*S, n, d), step normals (max_steps, B*S, n, d))``.  The
    labels come from one collected block (max_steps, B*S, n, d)."""
    b = x0.shape[0]
    x_rep = x0.repeat_interleave(n_shots, 0)             # (B*S, n, d)
    dyn = _BAOAB(potential, dt=dt, kt=kt, friction=friction, masses=masses)
    m = dyn.consts(x_rep)[0]
    if noise is None:
        z_v, steps = md._normal(generator, x_rep), generator
    else:
        z_v, steps = noise
    v0 = torch.sqrt(kt / m) * z_v
    traj = dyn.run(x_rep, v0, max_steps, steps, collect_v=False)
    t_idx = torch.arange(max_steps, device=x0.device)[:, None]
    big = max_steps + 1
    first_a = torch.where(in_a(traj), t_idx, big).amin(0)
    first_b = torch.where(in_b(traj), t_idx, big).amin(0)
    resolved = (first_a < big) | (first_b < big)
    hit_b = ((first_b < first_a) & resolved).reshape(b, n_shots)
    n_res = resolved.reshape(b, n_shots).sum(1)
    q = hit_b.sum(1) / torch.clamp(n_res, min=1)
    q = torch.where(n_res > 0, q, torch.nan)
    return q, 1.0 - n_res / n_shots

"""Forward flux sampling (direct FFS): rare-event rates from
interface-to-interface shooting (port of ``vaemolsim_tpu/mcmc/ffs.py``).

The Allen-Frenkel-ten Wolde method factorizes the A -> B rate as
``k_AB = Phi_0 * prod_i P(lambda_{i+1} | lambda_i)``: ``Phi_0`` is the
flux of effective positive crossings of the first interface out of basin
A (:func:`basin_flux`), and each factor the share of trajectories
launched from stored crossings of ``lambda_i`` that reach the next
interface before falling back into A (:func:`ffs_stage`).

Both stages are batched Langevin runs of fixed length through ``md``'s
shared BAOAB runner and :func:`scan_collect` (replayed as captured CUDA
graphs on the card): the flux stage scatters crossing phase points into
a ring of ``n_store`` slots (plus one spare row that takes the writes of
the replicas that did not cross, sliced off), and the shooting stage
freezes each trial at its first boundary hit.  The interface ladder is a
host loop (:func:`run_ffs`), which stops a dead ladder at an exact rate
of 0.  The draws come from a generator, or are handed in (``noise=``,
``pick=``): what tests hand the JAX package's draws to.  ``unroll`` is
accepted and ignored.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from vaemolsim_tpu_torch.md import MDState, _BAOAB
from vaemolsim_tpu_torch.utils.scan import scan_collect

Tensor = torch.Tensor

__all__ = ["FluxResult", "StageResult", "FFSResult", "basin_flux",
           "ffs_stage", "run_ffs"]


class FluxResult(NamedTuple):
    """Effective positive flux through ``lambda_0`` and the stored
    crossing phase points (``stored`` marks the slots filled)."""
    flux: Tensor           # crossings per unit time, all replicas pooled
    n_crossings: Tensor    # int32 counted crossings
    x: Tensor              # (n_store, n_atoms, dim) crossing positions
    v: Tensor              # (n_store, n_atoms, dim) crossing velocities
    stored: Tensor         # (n_store,) bool


class StageResult(NamedTuple):
    """One interface-to-interface shooting stage."""
    p: Tensor              # P(next | here); unresolved trials fail
    n_success: Tensor      # int32
    n_unresolved: Tensor   # int32 trials absorbed by neither boundary
    x: Tensor              # (n_trials, n, d) final positions
    v: Tensor
    success: Tensor        # (n_trials,) bool


class FFSResult(NamedTuple):
    rate: Tensor           # k_AB per unit time per replica
    flux: Tensor           # Phi_0
    p_stages: Tensor       # (n_stages,) conditional probabilities
    n_success: Tensor      # (n_stages,) int32
    n_unresolved: Tensor   # (n_stages,) int32


class _FluxCarry(NamedTuple):
    s: MDState
    i: Tensor              # (1,) long: the step, a row of given noise
    armed: Tensor
    count: Tensor          # () int32
    sx: Tensor             # (n_store + 1, n, d): the ring and a spare row
    sv: Tensor
    stored: Tensor         # (n_store + 1,) bool


class _ShotCarry(NamedTuple):
    s: MDState
    i: Tensor
    status: Tensor         # int8: 0 running, 1 reached up, 2 fell down


def _noise_source(generator, noise):
    if noise is not None:
        return noise
    if generator is None:
        raise ValueError("pass a generator or the step normals (noise=)")
    return generator


def basin_flux(potential: Callable[[Tensor], Tensor],
               lambda_fn: Callable[[Tensor], Tensor],
               x0: Tensor, v0: Tensor,
               generator: Optional[torch.Generator] = None, *,
               lambda0: float, dt: float, n_steps: int, kT: float,
               friction: float = 1.0, masses=1.0, n_store: int = 256,
               lambda_a: Optional[float] = None, unroll: int = 4,
               noise: Optional[Tensor] = None) -> FluxResult:
    """Effective positive flux through ``lambda0`` from basin-A dynamics,
    storing crossing phase points as stage-0 seeds.

    ``x0, v0``: ``(R, n_atoms, dim)`` replicas equilibrated in A.  A
    crossing counts when ``lambda`` steps from below ``lambda0`` to at or
    above it while the replica is armed; it then disarms until it
    revisits ``lambda < lambda_a`` (default ``lambda0``).  Crossings
    overwrite ``n_store`` slots cyclically (the latest are kept).
    ``flux = n_crossings / (R * n_steps * dt)``.  The step normals come
    from ``generator`` or are the rows of ``noise`` (n_steps, R, n, d)."""
    lam_a = lambda0 if lambda_a is None else lambda_a
    dyn = _BAOAB(potential, dt=dt, kt=kT, friction=friction, masses=masses)
    src = _noise_source(generator, noise)
    r = x0.shape[0]

    def body(c: _FluxCarry) -> _FluxCarry:
        lam_prev = lambda_fn(c.s.x)
        s = dyn.step(c.s, dyn.normals(src, c.i, c.s.v))
        lam = lambda_fn(s.x)
        crossed = c.armed & (lam_prev < lambda0) & (lam >= lambda0)
        armed = torch.where(crossed, False, c.armed | (lam < lam_a))
        # Replica j's slot is (count + its rank among this step's
        # crossers) mod n_store; the others write the spare row.
        rank = torch.cumsum(crossed.to(torch.int32), 0,
                            dtype=torch.int32) - 1
        idx = torch.where(crossed, torch.remainder(c.count + rank, n_store),
                          n_store).long()
        return _FluxCarry(
            s=s, i=c.i + 1, armed=armed,
            count=c.count + crossed.sum(dtype=torch.int32),
            sx=c.sx.index_copy(0, idx, s.x),
            sv=c.sv.index_copy(0, idx, s.v),
            stored=c.stored.index_fill(0, idx, True))

    kw = dict(dtype=x0.dtype, device=x0.device)
    slots = torch.zeros((n_store + 1,) + tuple(x0.shape[1:]), **kw)
    start = _FluxCarry(
        s=dyn.start(x0, v0),
        i=torch.zeros(1, dtype=torch.long, device=x0.device),
        armed=lambda_fn(x0) < lam_a,
        count=torch.zeros((), dtype=torch.int32, device=x0.device),
        sx=slots, sv=slots.clone(),
        stored=torch.zeros(n_store + 1, dtype=torch.bool, device=x0.device))
    end, _ = _scan(body, start, n_steps, src)
    return FluxResult(flux=end.count / (r * n_steps * dt),
                      n_crossings=end.count, x=end.sx[:n_store],
                      v=end.sv[:n_store], stored=end.stored[:n_store])


def _scan(body, start, n_steps, src):
    return scan_collect(
        body, start, n_steps,
        generators=(src,) if isinstance(src, torch.Generator) else ())


def _absorbing_baoab(potential, lambda_fn, x0, v0, src, *, lam_up,
                     lam_down, dt, max_steps, kT, friction, masses):
    """Batched BAOAB where each walker freezes at its first boundary hit:
    final ``(x, v, status)``, status 0 = running, 1 = reached
    ``lam_up``, 2 = fell to or below ``lam_down``."""
    dyn = _BAOAB(potential, dt=dt, kt=kT, friction=friction, masses=masses)

    def body(c: _ShotCarry) -> _ShotCarry:
        s = dyn.step(c.s, dyn.normals(src, c.i, c.s.v))
        lam = lambda_fn(s.x)
        hit = torch.where(lam >= lam_up, 1,
                          torch.where(lam <= lam_down, 2, 0)).to(torch.int8)
        status = torch.where(c.status == 0, hit, c.status)
        frozen = (c.status != 0)[..., None, None]
        s = MDState(*(torch.where(frozen, old, new)
                      for old, new in zip(c.s, s)))
        return _ShotCarry(s=s, i=c.i + 1, status=status)

    # Seeds sit at the launch interface (>= lam_down): they start running.
    start = _ShotCarry(
        s=dyn.start(x0, v0),
        i=torch.zeros(1, dtype=torch.long, device=x0.device),
        status=torch.zeros(x0.shape[0], dtype=torch.int8, device=x0.device))
    end, _ = _scan(body, start, max_steps, src)
    return end.s.x, end.s.v, end.status


def ffs_stage(potential: Callable[[Tensor], Tensor],
              lambda_fn: Callable[[Tensor], Tensor],
              x_seed: Tensor, v_seed: Tensor, seed_mask: Tensor,
              generator: Optional[torch.Generator] = None, *,
              lambda_next: float, lambda_fail: float, dt: float,
              max_steps: int, kT: float, friction: float = 1.0,
              masses=1.0, n_trials: int = 256, unroll: int = 4,
              pick: Optional[Tensor] = None,
              noise: Optional[Tensor] = None) -> StageResult:
    """Fire ``n_trials`` trajectories from seeds resampled with replacement
    from the ``seed_mask`` slots (one categorical draw, or the indices
    ``pick``) until each reaches ``lambda_next`` (success) or falls to
    ``lambda_fail`` (failure); stored velocities are kept.

    ``p`` counts unresolved trials (neither boundary within
    ``max_steps``) as failures.  An all-False ``seed_mask`` gives ``p =
    NaN`` and ``success`` all False.  The step normals come from
    ``generator`` or are the rows of ``noise`` (max_steps, n_trials, n,
    d)."""
    seed_mask = torch.as_tensor(seed_mask, device=x_seed.device)
    has_seed = seed_mask.any()
    if pick is None:
        if generator is None:
            raise ValueError("pass a generator or the seed indices (pick=)")
        # Uniform over the stored slots; over all slots where none is
        # stored (the result is then masked out).
        probs = torch.where(has_seed, seed_mask.float(), 1.0)
        pick = torch.multinomial(probs, n_trials, replacement=True,
                                 generator=generator)
    pick = pick.to(x_seed.device).long()
    x0 = x_seed.index_select(0, pick)
    v0 = v_seed.index_select(0, pick)
    x, v, status = _absorbing_baoab(
        potential, lambda_fn, x0, v0, _noise_source(generator, noise),
        lam_up=lambda_next, lam_down=lambda_fail, dt=dt,
        max_steps=max_steps, kT=kT, friction=friction, masses=masses)
    success = (status == 1) & has_seed
    n_success = success.sum(dtype=torch.int32)
    n_unresolved = (status == 0).sum(dtype=torch.int32)
    p = torch.where(has_seed, n_success / n_trials, torch.nan)
    return StageResult(p=p, n_success=n_success, n_unresolved=n_unresolved,
                       x=x, v=v, success=success)


def run_ffs(potential: Callable[[Tensor], Tensor],
            lambda_fn: Callable[[Tensor], Tensor],
            x0: Tensor, v0: Tensor, generator: torch.Generator, *,
            interfaces: Sequence[float], dt: float, kT: float,
            flux_steps: int, max_steps: int, friction: float = 1.0,
            masses=1.0, n_trials: int = 256, n_store: int = 256,
            lambda_a: Optional[float] = None,
            unroll: int = 4) -> FFSResult:
    """Direct FFS: the flux stage and the whole interface ladder.

    ``interfaces``: increasing ``[lambda_0, ..., lambda_n]``, ``lambda_n``
    the B boundary; ``x0, v0`` replicas equilibrated in A.  Trials that
    fall below ``lambda_a`` (default ``lambda_0``) fail.  A stage with no
    success ends the ladder: the remaining stages are skipped and the
    rate is exactly 0 (``p_stages`` shows where the ladder died)."""
    interfaces = [float(s) for s in interfaces]
    if sorted(interfaces) != interfaces or len(interfaces) < 2:
        raise ValueError("interfaces must be an increasing ladder of "
                         f"at least 2 values, got {interfaces}")
    lam_a = interfaces[0] if lambda_a is None else float(lambda_a)
    kw = dict(dt=dt, kT=kT, friction=friction, masses=masses)
    fr = basin_flux(potential, lambda_fn, x0, v0, generator,
                    lambda0=interfaces[0], n_steps=flux_steps,
                    n_store=n_store, lambda_a=lam_a, **kw)
    xs, vs, mask = fr.x, fr.v, fr.stored
    ps, succs, unres = [], [], []
    alive = bool(mask.any())
    for nxt in interfaces[1:]:
        if not alive:
            ps.append(0.0)
            succs.append(0)
            unres.append(0)
            continue
        res = ffs_stage(potential, lambda_fn, xs, vs, mask, generator,
                        lambda_next=nxt, lambda_fail=lam_a,
                        max_steps=max_steps, n_trials=n_trials, **kw)
        ps.append(float(res.p))
        succs.append(int(res.n_success))
        unres.append(int(res.n_unresolved))
        xs, vs, mask = res.x, res.v, res.success
        alive = succs[-1] > 0
    dev = x0.device
    p_stages = torch.tensor(ps, dtype=torch.float32, device=dev)
    return FFSResult(rate=fr.flux * torch.prod(p_stages), flux=fr.flux,
                     p_stages=p_stages,
                     n_success=torch.tensor(succs, dtype=torch.int32,
                                            device=dev),
                     n_unresolved=torch.tensor(unres, dtype=torch.int32,
                                               device=dev))

"""Brownian (overdamped) dynamics, free-draining and with
Rotne-Prager-Yamakawa hydrodynamic interactions (port of
``vaemolsim_tpu/bd.py``).

- :func:`brownian`: ``dx = (D / kT) F dt + sqrt(2 D dt) dW`` by the
  Leimkuhler-Matthews averaged-noise scheme (the overdamped limit of
  BAOAB: one force and one Gaussian a step, the half-noise carried).
- :func:`brownian_rpy`: ``x' = x + M F dt + sqrt(2 kT dt) chol(M) xi``
  with the RPY mobility (divergence-free, so no drift correction),
  Euler-Maruyama in time.

The mobility is a dense (N, N, 3, 3) block tensor; the drift is one
(3N, 3N) product and the noise one batched Cholesky and product.  Every
draw comes from an explicit ``torch.Generator``; ``noise=`` hands a run
its normals instead.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from vaemolsim_tpu_torch.md import _force_fn

Tensor = torch.Tensor

__all__ = ["BDState", "brownian", "rpy_mobility", "brownian_rpy"]


class BDState(NamedTuple):
    """Positions, the force at them and the carried half-noise."""
    x: Tensor
    force: Tensor
    noise: Tensor


def _diffusion_arr(diffusion, x: Tensor) -> Tensor:
    d = torch.as_tensor(diffusion, dtype=x.dtype, device=x.device)
    return d[:, None] if d.dim() == 1 else d


def _collect(n_steps: int, collect_every: int) -> None:
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")


def brownian(potential: Callable[[Tensor], Tensor], x0: Tensor,
             generator: Optional[torch.Generator], *, dt: float,
             n_steps: int, kT: float, diffusion=1.0, collect_every: int = 0,
             state0: Optional[BDState] = None,
             noise: Optional[Sequence[Tensor]] = None
             ) -> Tuple[BDState, Optional[Tensor]]:
    """Free-draining overdamped dynamics with per-atom diffusion ``D``
    (scalar or (n_atoms,)): ``x_{k+1} = x_k + (D / kT) F(x_k) dt +
    sqrt(2 D dt) (xi_k + xi_{k+1}) / 2``.  Samples ``exp(-U / kT)``; a
    free particle's MSD is ``2 d D t``.  ``state0`` resumes a previous
    segment (its force and carried half-noise).  ``noise``: the first
    half-noise (unless ``state0``) then one normal per step, instead of
    the generator's."""
    _collect(n_steps, collect_every)
    force = _force_fn(potential)
    d = _diffusion_arr(diffusion, x0)
    dtt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    amp = torch.sqrt(2.0 * d * dtt)
    draws = iter(noise) if noise is not None else None

    def normal(like):
        if draws is not None:
            return next(draws)
        return torch.randn(like.shape, generator=generator,
                           dtype=like.dtype, device=like.device)

    if state0 is None:
        _, f0 = force(x0)
        state0 = BDState(x0, f0, normal(x0))
    s = state0
    traj = []
    for k in range(1, n_steps + 1):
        xi = normal(s.x)
        x = s.x + (d / kT) * s.force * dtt + 0.5 * amp * (s.noise + xi)
        _, f = force(x)
        s = BDState(x, f, xi)
        if collect_every and k % collect_every == 0:
            traj.append(s.x)
    return s, (torch.stack(traj) if collect_every else None)


def rpy_mobility(x: Tensor, *, radius: float = 1.0,
                 eta: float = 1.0) -> Tensor:
    """The RPY mobility of ``x`` (..., N, 3) as (..., 3N, 3N), ``mu0 = 1 /
    (6 pi eta a)``: far pairs ``mu0 (3a/4r) [(1 + 2a^2/3r^2) I + (1 -
    2a^2/r^2) e e^T]``, overlapping pairs (r < 2a) ``mu0 [(1 - 9r/32a) I
    + (3r/32a) e e^T]``, self blocks ``mu0 I``."""
    n = x.shape[-2]
    if x.shape[-1] != 3:
        raise ValueError("RPY is a 3-D hydrodynamic tensor; got dim "
                         f"{x.shape[-1]}")
    mu0 = 1.0 / (6.0 * math.pi * eta * radius)
    rij = x[..., :, None, :] - x[..., None, :, :]
    r2 = (rij * rij).sum(-1)
    eye_n = torch.eye(n, dtype=torch.bool, device=x.device)
    r2_safe = torch.where(eye_n, 1.0, r2.clamp_min(1e-24))
    r = torch.sqrt(r2_safe)
    e = rij / r[..., None]
    ee = e[..., :, None] * e[..., None, :]
    i3 = torch.eye(3, dtype=x.dtype, device=x.device)
    a = radius
    far_i = (3.0 * a / (4.0 * r)) * (1.0 + 2.0 * a * a / (3.0 * r2_safe))
    far_e = (3.0 * a / (4.0 * r)) * (1.0 - 2.0 * a * a / r2_safe)
    near = r < 2.0 * a
    ci = torch.where(near, 1.0 - 9.0 * r / (32.0 * a), far_i)
    ce = torch.where(near, 3.0 * r / (32.0 * a), far_e)
    blocks = ci[..., None, None] * i3 + ce[..., None, None] * ee
    blocks = torch.where(eye_n[:, :, None, None], i3, blocks)
    blocks = mu0 * blocks
    return blocks.transpose(-3, -2).reshape(x.shape[:-2] + (3 * n, 3 * n))


def brownian_rpy(potential: Callable[[Tensor], Tensor], x0: Tensor,
                 generator: Optional[torch.Generator], *, dt: float,
                 n_steps: int, kT: float, radius: float = 1.0,
                 eta: float = 1.0, collect_every: int = 0,
                 jitter: float = 1e-7,
                 noise: Optional[Sequence[Tensor]] = None
                 ) -> Tuple[Tensor, Optional[Tensor]]:
    """Overdamped dynamics with RPY hydrodynamics (Ermak & McCammon 1978):
    ``x' = x + M(x) F(x) dt + sqrt(2 kT dt) chol(M(x) + jitter mu0 I)
    xi``.  The Cholesky factor is taken in float32; where it fails (a
    mobility that roundoff makes indefinite) the factor is NaN, as
    ``jnp.linalg.cholesky``'s is, so that walker's positions turn NaN
    rather than the run raising.  Returns ``(x_final, trajectory)``.
    ``noise``: one (..., 3N) normal per step instead of the
    generator's."""
    _collect(n_steps, collect_every)
    n = x0.shape[-2]
    force = _force_fn(potential)
    dtt = torch.tensor(dt, dtype=x0.dtype, device=x0.device)
    mu0 = 1.0 / (6.0 * math.pi * eta * radius)
    eye = torch.eye(3 * n, dtype=x0.dtype, device=x0.device)
    x = x0
    traj = []
    for k in range(n_steps):
        _, f = force(x)
        m = rpy_mobility(x, radius=radius, eta=eta)
        chol, info = torch.linalg.cholesky_ex(m + (jitter * mu0) * eye)
        chol = torch.where((info != 0)[..., None, None], math.nan, chol)
        fv = f.reshape(f.shape[:-2] + (3 * n,))
        xi = (noise[k] if noise is not None else torch.randn(
            fv.shape, generator=generator, dtype=x.dtype, device=x.device))
        drift = torch.einsum("...ij,...j->...i", m, fv) * dtt
        kick = torch.sqrt(2.0 * kT * dtt) * torch.einsum(
            "...ij,...j->...i", chol, xi)
        x = x + (drift + kick).reshape(x.shape)
        if collect_every and (k + 1) % collect_every == 0:
            traj.append(x)
    return x, (torch.stack(traj) if collect_every else None)

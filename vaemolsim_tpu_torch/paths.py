"""Minimum-energy paths: climbing-image NEB and the string method (port of
``vaemolsim_tpu/paths.py``).

A path is a fixed ``(n_images, n_atoms, dim)`` tensor, and each
optimiser step is fused elementwise updates around ONE batched force
call over all images.  The climbing image is picked by a one-hot mask of
the energies' argmax, never by indexing, so no step reads anything back
to the host: both optimisers run through :func:`scan_collect`, which
replays captured chunks of steps on the card.

- :func:`climbing_neb`: nudged elastic band with the upwinded tangent of
  Henkelman & Jonsson (2000) and a climbing image, relaxed by FIRE
  (Bitzek et al. 2006).
- :func:`string_method`: the simplified string method (E, Ren &
  Vanden-Eijnden 2007): steepest descent, then equal-arc-length
  reparametrization by ``jnp.interp``'s rule written with
  ``torch.searchsorted``.
- :func:`harmonic_tst_rate`: the harmonic transition-state rate
  (Vineyard 1957) from normal modes at a minimum and a saddle.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from vaemolsim_tpu_torch.observables import normal_modes
from vaemolsim_tpu_torch.utils.scan import scan_collect

Tensor = torch.Tensor

__all__ = ["MEPResult", "interpolate_path", "climbing_neb",
           "string_method", "harmonic_tst_rate"]


class MEPResult(NamedTuple):
    """``path`` (n_images, n_atoms, dim); ``energies`` (n_images,) at the
    final path; ``f_max`` the largest component of the projected (NEB)
    or perpendicular (string) force, the convergence measure."""
    path: Tensor
    energies: Tensor
    f_max: Tensor

    @property
    def barrier(self) -> Tensor:
        return self.energies.max() - self.energies[0]

    @property
    def saddle(self) -> Tensor:
        return self.path[int(torch.argmax(self.energies))]


def _linspace(start, stop, n: int, like: Tensor) -> Tensor:
    """``jnp.linspace(start, stop, n)`` by its own rule (start (1 - t) +
    stop t, the last point ``stop`` exactly); ``stop`` may be a 0-d
    tensor, read on the device."""
    t = torch.arange(n - 1, dtype=like.dtype, device=like.device) / (n - 1)
    stop = torch.as_tensor(stop, dtype=like.dtype, device=like.device)
    return torch.cat([start * (1 - t) + stop * t, stop.reshape(1)])


def interpolate_path(x_a: Tensor, x_b: Tensor, n_images: int) -> Tensor:
    """Linear path from ``x_a`` to ``x_b`` inclusive: (n_images,
    *x_a.shape)."""
    t = _linspace(0.0, 1.0, n_images, x_a)
    t = t.reshape((n_images,) + (1,) * x_a.dim())
    return x_a[None] * (1.0 - t) + x_b[None] * t


def _energy_forces(potential, path: Tensor):
    xg = path.detach().requires_grad_(True)
    with torch.enable_grad():
        e = potential(xg)
        (g,) = torch.autograd.grad(e.sum(), xg)
    return e.detach(), -g


def _upwind_tangents(path: Tensor, energies: Tensor) -> Tensor:
    """Improved NEB tangent (Henkelman & Jonsson 2000 eq. 8-11) of the
    interior images, unit-normalized: (K-2, n, d)."""
    t_plus = path[2:] - path[1:-1]
    t_minus = path[1:-1] - path[:-2]
    e_prev, e, e_next = energies[:-2], energies[1:-1], energies[2:]
    d_next = torch.abs(e_next - e)
    d_prev = torch.abs(e_prev - e)
    d_max = torch.maximum(d_next, d_prev)[:, None, None]
    d_min = torch.minimum(d_next, d_prev)[:, None, None]
    up = (e_next > e) & (e > e_prev)          # monotone uphill
    down = (e_next < e) & (e < e_prev)        # monotone downhill
    next_higher = (e_next > e_prev)[:, None, None]
    mixed = torch.where(next_higher, t_plus * d_max + t_minus * d_min,
                        t_plus * d_min + t_minus * d_max)
    tau = torch.where(up[:, None, None], t_plus,
                      torch.where(down[:, None, None], t_minus, mixed))
    norm = torch.sqrt((tau * tau).sum((-2, -1), keepdim=True))
    return tau / torch.clamp(norm, min=1e-30)


class _FIREState(NamedTuple):
    path: Tensor
    v: Tensor
    dt: Tensor
    alpha: Tensor
    n_pos: Tensor
    f_max: Tensor


def _check_path(path0: Tensor) -> None:
    if path0.dim() < 3 or path0.shape[0] < 3:
        raise ValueError("path0 must be (n_images >= 3, n_atoms, dim)")


def climbing_neb(potential: Callable[[Tensor], Tensor],
                 path0: Tensor, *,
                 n_steps: int,
                 k_spring: float = 1.0,
                 dt: float = 0.05,
                 climb: bool = True,
                 climb_after: int = 0,
                 dt_max_factor: float = 10.0
                 ) -> MEPResult:
    """Relax a path to the MEP by climbing-image NEB under FIRE.

    Interior images feel the true force perpendicular to the upwinded
    tangent plus the spring force ``k (|t+| - |t-|) tau`` along it; with
    ``climb`` the highest interior image instead feels ``F - 2 (F . tau)
    tau`` once ``climb_after`` steps have passed, and converges to the
    saddle point itself.  Endpoints stay fixed (relax them first).  FIRE
    mixes the velocity toward the force while the power ``F . v`` stays
    positive (``dt`` grows to ``dt_max_factor * dt``) and resets on an
    uphill step."""
    _check_path(path0)
    dtype = path0.dtype
    k = torch.tensor(k_spring, dtype=dtype, device=path0.device)
    dt0 = torch.tensor(dt, dtype=dtype, device=path0.device)
    dt_max = dt_max_factor * dt0
    f_inc, f_dec, alpha0, f_alpha, n_min = 1.1, 0.5, 0.1, 0.99, 5
    n_interior = path0.shape[0] - 2
    slots = torch.arange(n_interior, device=path0.device)

    def neb_forces(path, step):
        e, f_true = _energy_forces(potential, path)
        tau = _upwind_tangents(path, e)
        f_int = f_true[1:-1]
        f_par = (f_int * tau).sum((-2, -1), keepdim=True)
        f_perp = f_int - f_par * tau
        lens_plus = torch.sqrt(((path[2:] - path[1:-1]) ** 2).sum(
            (-2, -1), keepdim=True))
        lens_minus = torch.sqrt(((path[1:-1] - path[:-2]) ** 2).sum(
            (-2, -1), keepdim=True))
        f_neb = f_perp + k * (lens_plus - lens_minus) * tau
        if climb:
            hot = (slots == torch.argmax(e[1:-1])).to(dtype)[:, None, None]
            f_climb = f_int - 2.0 * f_par * tau
            on = (step >= climb_after).to(dtype)
            f_neb = f_neb + on * hot * (f_climb - f_neb)
        return f_neb

    def step_fn(carry):
        s, i = carry
        f = neb_forces(s.path, i)
        power = (f * s.v).sum()
        f_norm = torch.sqrt((f * f).sum())
        v_norm = torch.sqrt((s.v * s.v).sum())
        v_mix = ((1.0 - s.alpha) * s.v
                 + s.alpha * f * v_norm / torch.clamp(f_norm, min=1e-30))
        uphill = power <= 0.0
        n_pos = torch.where(uphill, 0, s.n_pos + 1)
        grow = n_pos > n_min
        dt_new = torch.where(uphill, s.dt * f_dec, torch.where(
            grow, torch.minimum(s.dt * f_inc, dt_max), s.dt))
        alpha = torch.where(uphill, alpha0,
                            torch.where(grow, s.alpha * f_alpha, s.alpha))
        v = torch.where(uphill, torch.zeros_like(v_mix), v_mix)
        v = v + dt_new * f
        interior = s.path[1:-1] + dt_new * v
        path = torch.cat([s.path[:1], interior, s.path[-1:]])
        return (_FIREState(path, v, dt_new, alpha, n_pos,
                           torch.abs(f).max()), i + 1)

    init = _FIREState(
        path=path0, v=torch.zeros_like(path0[1:-1]), dt=dt0,
        alpha=torch.tensor(alpha0, dtype=dtype, device=path0.device),
        n_pos=torch.zeros((), dtype=torch.int32, device=path0.device),
        f_max=torch.tensor(math.inf, dtype=dtype, device=path0.device))
    (out, _), _ = scan_collect(
        step_fn, (init, torch.zeros((), dtype=torch.long,
                                    device=path0.device)), n_steps)
    return MEPResult(path=out.path, energies=potential(out.path).detach(),
                     f_max=out.f_max)


def _interp_columns(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``jnp.interp(x, xp, fp[:, c])`` for every column c of ``fp``
    (len(xp), C): linear inside ``xp``, clamped to the end values
    outside."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    dx0 = torch.abs(dx) <= float(np.spacing(torch.finfo(xp.dtype).eps))
    f = torch.where(dx0[:, None], fp[i - 1], fp[i - 1] + (
        delta / torch.where(dx0, 1.0, dx))[:, None] * df)
    f = torch.where((x < xp[0])[:, None], fp[0], f)
    return torch.where((x > xp[-1])[:, None], fp[-1], f)


def _reparametrize(path: Tensor) -> Tensor:
    """Redistribute images to equal arc length along the piecewise-
    linear path (endpoints fixed)."""
    n = path.shape[0]
    flat = path.reshape(n, -1)
    seg = torch.sqrt(((flat[1:] - flat[:-1]) ** 2).sum(-1))
    s = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0)])
    s_new = _linspace(0.0, s[-1], n, s)
    return _interp_columns(s_new, s, flat).reshape(path.shape)


def string_method(potential: Callable[[Tensor], Tensor],
                  path0: Tensor, *,
                  n_steps: int,
                  step_size: float = 0.01
                  ) -> MEPResult:
    """Simplified string method: interior images take one steepest-
    descent step on the true force, then the string is reparametrized to
    equal arc length.  No climbing image: read the barrier off the
    highest image, or refine with :func:`climbing_neb`."""
    _check_path(path0)
    eta = torch.tensor(step_size, dtype=path0.dtype, device=path0.device)

    def step_fn(path):
        _, f = _energy_forces(potential, path)
        interior = path[1:-1] + eta * f[1:-1]
        return _reparametrize(torch.cat([path[:1], interior, path[-1:]]))

    path, _ = scan_collect(step_fn, path0, n_steps)
    e, f = _energy_forces(potential, path)
    tau = _upwind_tangents(path, e)
    f_int = f[1:-1]
    f_perp = f_int - (f_int * tau).sum((-2, -1), keepdim=True) * tau
    return MEPResult(path=path, energies=e, f_max=torch.abs(f_perp).max())


def harmonic_tst_rate(potential: Callable[[Tensor], Tensor],
                      x_min: Tensor, x_saddle: Tensor, *, kt: float,
                      masses=1.0, zero_tol: float = 1e-4) -> Tensor:
    """Harmonic transition-state-theory escape rate (Vineyard 1957),

        k = [prod_i omega_i(min) / prod_j omega_j(saddle)] / (2 pi)
            * exp(-(E_saddle - E_min) / kT),

    the saddle's product over its real modes, modes with ``|omega| <=
    zero_tol`` left out on both sides.  NaN unless the saddle has exactly
    one imaginary mode, the minimum none, and the zero-mode counts
    match."""
    w_min, _ = normal_modes(potential, x_min, masses=masses)
    w_sad, _ = normal_modes(potential, x_saddle, masses=masses)
    pos_min, pos_sad = w_min > zero_tol, w_sad > zero_tol
    ok = (((w_min < -zero_tol).sum() == 0)
          & ((w_sad < -zero_tol).sum() == 1)
          & (pos_min.sum() == pos_sad.sum() + 1))
    log_prod_min = torch.where(pos_min, torch.log(torch.abs(w_min)),
                               0.0).sum()
    log_prod_sad = torch.where(pos_sad, torch.log(torch.abs(w_sad)),
                               0.0).sum()
    with torch.no_grad():
        de = (potential(x_saddle).reshape(())
              - potential(x_min).reshape(()))
    log_k = (log_prod_min - log_prod_sad - math.log(2.0 * math.pi)
             - de / kt)
    return torch.where(ok, torch.exp(log_k), torch.nan)

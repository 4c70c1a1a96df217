"""Generalized Langevin (colored-noise) thermostats (port of
``vaemolsim_tpu/gle.py``).

Each mass-scaled momentum is coupled to ``n_s`` auxiliary momenta and
the ``(1 + n_s)``-vector follows the linear Ornstein-Uhlenbeck process
``d[p; s] = -A [p; s] dt + B dW`` (Ceriotti, Bussi & Parrinello 2009).
The O-step is exact for any dt: the propagator ``T = expm(-A dt)`` and
the noise factor ``S`` with ``S S^T = C - T C T^T`` are built once in
float64 NumPy (:func:`gle_matrices`), and on the device the step is one
small matrix product over the trailing auxiliary axis plus one Gaussian
draw.  :func:`gle_baoab` arranges B-A-O-A-B as ``md.baoab`` does; with
``A = [[gamma]]`` it is white-noise Langevin.  Every draw comes from an
explicit ``torch.Generator``; ``noise=`` hands a run its normals
instead.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from vaemolsim_tpu_torch.md import _force_fn, _masses_arr

Tensor = torch.Tensor

__all__ = ["GLEState", "gle_matrices", "white_noise_matrix",
           "exp_memory_matrix", "gle_baoab"]


class GLEState(NamedTuple):
    """Positions, velocities, the auxiliary momenta (..., n_atoms, dim,
    n_s) in mass-scaled units, and the force."""
    x: Tensor
    v: Tensor
    s: Tensor
    force: Tensor


def white_noise_matrix(friction: float) -> np.ndarray:
    """``A = [[gamma]]``: the white-noise Langevin limit."""
    return np.array([[float(friction)]])


def exp_memory_matrix(friction: float, tau: float) -> np.ndarray:
    """One auxiliary momentum for the exponential memory kernel ``K(t) =
    (gamma / tau) exp(-t / tau)``: ``A = [[0, sqrt(gamma/tau)],
    [-sqrt(gamma/tau), 1/tau]]``."""
    a = np.sqrt(float(friction) / float(tau))
    return np.array([[0.0, a], [-a, 1.0 / tau]])


def _expm_scaled(m: np.ndarray) -> np.ndarray:
    """float64 matrix exponential by scaling and squaring over a Taylor
    series (scaled to ``||m / 2^s|| <= 0.5`` first)."""
    norm = np.linalg.norm(m, 1)
    s = (max(0, int(np.ceil(np.log2(max(norm, 1e-300)))) + 1)
         if norm > 0.5 else 0)
    a = m / (2.0 ** s)
    t = np.eye(m.shape[0])
    term = np.eye(m.shape[0])
    for k in range(1, 30):
        term = term @ a / k
        t = t + term
    for _ in range(s):
        t = t @ t
    return t


def gle_matrices(a_matrix, dt: float, kT: float,
                 c_matrix=None) -> Tuple[np.ndarray, np.ndarray]:
    """The exact OU pair ``(T, S)`` for time dt, float64: ``T = expm(-A
    dt)``, ``S S^T = C - T C T^T`` with ``C = kT I`` unless
    ``c_matrix``.  Raises for an unstable A or a pair with no stationary
    noise."""
    a = np.asarray(a_matrix, np.float64)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a_matrix must be square, got {a.shape}")
    n = a.shape[0]
    c = (kT * np.eye(n) if c_matrix is None
         else np.asarray(c_matrix, np.float64))
    if c.shape != a.shape:
        raise ValueError(f"c_matrix shape {c.shape} != A shape {a.shape}")
    if np.any(np.real(np.linalg.eigvals(a)) < -1e-12):
        raise ValueError("a_matrix must be stable (eigenvalues with "
                         "non-negative real part)")
    try:
        from scipy.linalg import expm
        t = expm(-a * float(dt))
    except ImportError:
        t = _expm_scaled(-a * float(dt))
    cov = c - t @ c @ t.T
    cov = 0.5 * (cov + cov.T)
    w, v = np.linalg.eigh(cov)
    if w.min() < -1e-8 * max(w.max(), 1e-30):
        raise ValueError(
            "(a_matrix, c_matrix) is not a valid stationary OU pair: "
            "A C + C A^T has negative eigenvalues, so no noise B "
            f"exists (got discrete-cov eigenvalues {w})")
    return t, v @ np.diag(np.sqrt(np.maximum(w, 0.0)))


def gle_baoab(potential: Callable[[Tensor], Tensor], x0: Tensor,
              v0: Tensor, generator: Optional[torch.Generator], *,
              dt: float, n_steps: int, kT: float, a_matrix, c_matrix=None,
              masses=1.0, s0: Optional[Tensor] = None,
              collect_every: int = 0, collect_v: bool = False,
              noise: Optional[Sequence[Tensor]] = None
              ) -> Tuple[GLEState, Optional[Tensor]]:
    """Colored-noise NVT dynamics: B, A, the exact GLE O-step on ``(p /
    sqrt(m), s)``, A, B.  The auxiliary momenta start from their
    stationary Gaussian (``C_ss``) unless ``s0`` is given.  ``noise``:
    the initial auxiliary normals (when the run draws ``s0`` and n_s >
    0) then one (..., n_atoms, dim, 1 + n_s) normal per step, instead of
    the generator's."""
    if collect_every and n_steps % collect_every != 0:
        raise ValueError("n_steps must be a multiple of collect_every")
    a_np = np.asarray(a_matrix, np.float64)
    n_tot = a_np.shape[0]
    n_s = n_tot - 1
    t_np, s_np = gle_matrices(a_np, dt, kT, c_matrix)
    c_np = (kT * np.eye(n_tot) if c_matrix is None
            else np.asarray(c_matrix, np.float64))
    kw = dict(dtype=x0.dtype, device=x0.device)
    t_m = torch.as_tensor(t_np, **kw)
    s_m = torch.as_tensor(s_np, **kw)
    force = _force_fn(potential)
    m = _masses_arr(masses, x0)
    sqrt_m = torch.sqrt(m)
    dtt = torch.tensor(dt, **kw)
    draws = iter(noise) if noise is not None else None

    def normal(shape):
        if draws is not None:
            return next(draws)
        return torch.randn(shape, generator=generator, **kw)

    _, f0 = force(x0)
    if s0 is None:
        if n_s > 0:
            w, vec = np.linalg.eigh(0.5 * (c_np[1:, 1:] + c_np[1:, 1:].T))
            half = torch.as_tensor(
                vec @ np.diag(np.sqrt(np.maximum(w, 0.0))), **kw)
            s0 = torch.einsum("ab,...b->...a", half,
                              normal(x0.shape + (n_s,)))
        else:
            s0 = torch.zeros(x0.shape + (0,), **kw)
    st = GLEState(x0, v0, s0, f0)
    traj = []
    for k in range(1, n_steps + 1):
        v = st.v + 0.5 * dtt * st.force / m
        x = st.x + 0.5 * dtt * v
        vec = torch.cat([(v * sqrt_m)[..., None], st.s], -1)
        xi = normal(vec.shape)
        vec = (torch.einsum("ab,...b->...a", t_m, vec)
               + torch.einsum("ab,...b->...a", s_m, xi))
        v, s = vec[..., 0] / sqrt_m, vec[..., 1:]
        x = x + 0.5 * dtt * v
        _, f = force(x)
        st = GLEState(x, v + 0.5 * dtt * f / m, s, f)
        if collect_every and k % collect_every == 0:
            traj.append((st.x, st.v) if collect_v else st.x)
    if not collect_every:
        return st, None
    if collect_v:
        return st, (torch.stack([t[0] for t in traj]),
                    torch.stack([t[1] for t in traj]))
    return st, torch.stack(traj)

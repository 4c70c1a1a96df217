"""Markov state models: kinetics from simulation trajectories (port of
``vaemolsim_tpu/msm.py``).

Discrete-state kinetic models estimated from the trajectories the MD and
MC engines produce, in the standard MSM methodology (Prinz et al. 2011,
JCP 134, 174105):

- :func:`assign_states` (Voronoi) and :func:`kmeans` (farthest-point
  seeding, then Lloyd sweeps) discretize;
- :func:`count_matrix` counts transitions exactly, as one int64
  ``bincount`` of ``src * n + dst`` over every pooled trajectory;
- :func:`transition_matrix` is the reversible maximum-likelihood
  estimate by the fixed-point iteration on the symmetric flux, a static
  number of sweeps;
- eigenvalues and timescales come from ``eigh`` of the symmetrized
  matrix ``D^{1/2} T D^{-1/2}``; committors and mean first-passage times
  are masked linear solves;
- :func:`tica` solves the time-lagged generalized eigenproblem through
  the whitened symmetric form.

Everything works on tensors on their own device.  Eigenvectors' signs
and their order within degenerate groups are not fixed across libraries:
compare eigenvalues, timescales and projections up to sign.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

Tensor = torch.Tensor

__all__ = ["assign_states", "count_matrix", "transition_matrix",
           "stationary_distribution", "implied_timescales", "committor",
           "mean_first_passage_time", "chapman_kolmogorov", "tica",
           "reactive_flux", "tpt_rate", "kmeans"]


def _one_ulp(dtype) -> float:
    """Spacing just below 1.0 in ``dtype`` (so ``1 - _one_ulp`` is the
    largest representable value strictly less than 1): half of ``eps``
    for a binary float (numpy's ``epsneg``; torch's finfo has none)."""
    return torch.finfo(dtype).eps / 2.0


def _as_mask(idx, n: int, device) -> Tensor:
    """Boolean state mask from either a bool mask or an index array."""
    idx = torch.as_tensor(idx, device=device)
    if idx.dtype == torch.bool:
        return idx
    return torch.zeros(n, dtype=torch.bool, device=device).index_fill(
        0, idx.reshape(-1).long(), True)


def assign_states(x: Tensor, centers: Tensor) -> Tensor:
    """Discretize ``x`` of shape ``(..., d)`` (or ``(...,)`` for 1-D) to
    the nearest of ``n`` ``centers`` (``(n, d)`` or ``(n,)``): Euclidean
    Voronoi assignment.  Returns int32 state indices of shape
    ``(...,)``."""
    centers = torch.as_tensor(centers, device=x.device)
    if centers.dim() == 1:
        centers = centers[:, None]
        x = x[..., None]
    d2 = ((x[..., None, :] - centers) ** 2).sum(-1)
    return d2.argmin(-1).to(torch.int32)


def kmeans(generator: Union[torch.Generator, int, Tensor], x: Tensor,
           k: int, n_iter: int = 50) -> Tuple[Tensor, Tensor]:
    """K-means state centers: farthest-point seeding from a random first
    frame, then ``n_iter`` Lloyd sweeps.

    ``generator`` draws the first frame's index, or is that index itself
    (an int or a 0-d tensor: the JAX package's ``randint`` draw).
    ``x``: features ``(..., d)``, flattened; returns ``(centers (k, d),
    inertia)``.  Empty clusters keep their previous center."""
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    if k < 1 or k > n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    x_sq = (flat * flat).sum(-1)

    def dist2(c):
        # The (n, k) matmul form: the (n, k, d) broadcast is never made.
        return x_sq[:, None] - 2.0 * flat @ c.T + (c * c).sum(-1)[None, :]

    if isinstance(generator, torch.Generator):
        first = torch.randint(0, n, (1,), generator=generator,
                              device=generator.device).to(flat.device)
    else:
        first = torch.as_tensor(generator, device=flat.device).reshape(1)
    centers = flat.index_select(0, first.long()).repeat(k, 1)
    ar = torch.arange(k, device=flat.device)
    for m in range(1, k):
        mask = torch.where(ar < m, 0.0, torch.inf).to(flat.dtype)
        d2 = (dist2(centers) + mask[None]).amin(1)
        nxt = flat[d2.argmax()]
        centers = torch.where((ar == m)[:, None], nxt[None], centers)
    for _ in range(n_iter):
        lbl = dist2(centers).argmin(1)
        oh = torch.nn.functional.one_hot(lbl, k).to(flat.dtype)
        counts = oh.sum(0)
        sums = oh.T @ flat
        centers = torch.where(counts[:, None] > 0,
                              sums / torch.clamp(counts[:, None], min=1.0),
                              centers)
    inertia = torch.clamp(dist2(centers).amin(1), min=0.0).sum()
    return centers, inertia


def count_matrix(dtraj: Tensor, n_states: int, lag: int = 1,
                 sliding: bool = True) -> Tensor:
    """Transition-count matrix ``C[i, j] = #(s_t = i, s_{t+lag} = j)``
    from integer trajectories ``dtraj`` of shape ``(..., T)`` (any leading
    batch of independent trajectories; counts pool), as float32.

    ``sliding=True`` uses every window start; ``False`` strides by
    ``lag`` for independent counts.  The counts are exact: one int64
    ``bincount`` of ``src * n_states + dst``."""
    dtraj = torch.as_tensor(dtraj).long()
    if dtraj.dim() == 1:
        dtraj = dtraj[None]
    T = dtraj.shape[-1]
    if lag < 1 or lag >= T:
        raise ValueError(f"lag must be in [1, T-1], got {lag} for T={T}")
    src = dtraj[..., :-lag]
    dst = dtraj[..., lag:]
    if not sliding:
        src = src[..., ::lag]
        dst = dst[..., ::lag]
    flat = (src * n_states + dst).reshape(-1)
    counts = torch.bincount(flat, minlength=n_states * n_states)
    return counts.reshape(n_states, n_states).to(torch.float32)


def transition_matrix(C: Tensor, reversible: bool = True,
                      n_iter: int = 200, eps: float = 1e-12) -> Tensor:
    """Maximum-likelihood row-stochastic transition matrix from counts.

    ``reversible=False``: plain row normalization.  ``reversible=True``:
    the detailed-balance-constrained MLE by the fixed-point iteration on
    the symmetric flux (Bowman et al. 2009),
    ``x_ij <- (c_ij + c_ji) / (c_i / x_i + c_j / x_j)``, ``n_iter``
    sweeps.  Works in float64 for a float64 ``C``, else in float32."""
    C = torch.as_tensor(C)
    C = C.to(torch.float64 if C.dtype == torch.float64 else torch.float32)
    if not reversible:
        return C / torch.clamp(C.sum(1, keepdim=True), min=eps)
    c_sym = C + C.T
    c_row = C.sum(1)
    pos = c_sym > 0
    x = torch.where(pos, c_sym / 2.0, 0.0)
    for _ in range(n_iter):
        r = c_row / torch.clamp(x.sum(1), min=eps)
        denom = r[:, None] + r[None, :]
        x = torch.where(pos, c_sym / torch.clamp(denom, min=eps), 0.0)
    return x / torch.clamp(x.sum(1, keepdim=True), min=eps)


def stationary_distribution(T: Tensor) -> Tensor:
    """Stationary distribution ``pi T = pi, sum(pi) = 1`` by one linear
    solve of ``(I - T^T + 1 1^T) pi = 1``: exact for any irreducible
    row-stochastic ``T``, whatever its spectral gap."""
    n = T.shape[0]
    eye = torch.eye(n, dtype=T.dtype, device=T.device)
    A = eye - T.T + torch.ones((n, n), dtype=T.dtype, device=T.device)
    return torch.linalg.solve(A, torch.ones(n, dtype=T.dtype,
                                            device=T.device))


def _symmetrized_spectrum(T: Tensor, pi: Optional[Tensor] = None
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """Eigen-decompose a reversible ``T`` through ``S = D^{1/2} T
    D^{-1/2}``: (eigenvalues descending, right eigenvectors of T as
    columns, pi)."""
    if pi is None:
        pi = stationary_distribution(T)
    sqrt_pi = torch.sqrt(torch.clamp(pi, min=1e-30))
    S = sqrt_pi[:, None] * T / sqrt_pi[None, :]
    S = 0.5 * (S + S.T)
    w, V = torch.linalg.eigh(S)
    order = torch.argsort(-w)
    w, V = w[order], V[:, order]
    return w, V / sqrt_pi[:, None], pi


def implied_timescales(T: Tensor, lag: float = 1.0, k: Optional[int] = None,
                       pi: Optional[Tensor] = None) -> Tensor:
    """Implied relaxation timescales ``t_i = -lag / ln lambda_i`` of a
    reversible transition matrix (slowest first, stationary eigenvalue
    excluded); ``k`` limits how many are returned."""
    w, _, _ = _symmetrized_spectrum(T, pi)
    # The upper clip must be representable below 1 in the working dtype:
    # 1 - 1e-12 rounds to 1.0 in float32 and log(1) = 0.
    lam = torch.clamp(w[1:].abs(), 1e-12, 1.0 - _one_ulp(w.dtype))
    ts = -lag / torch.log(lam)
    return ts if k is None else ts[:k]


def committor(T: Tensor, source, sink) -> Tensor:
    """Forward committor ``q_i = P(reach sink before source | start i)``.

    ``source`` / ``sink``: boolean masks or index arrays over states.
    Interior states solve ``q = T q``; the source is pinned at 0 and the
    sink at 1, in one masked linear system."""
    n = T.shape[0]
    src = _as_mask(source, n, T.device)
    snk = _as_mask(sink, n, T.device)
    eye = torch.eye(n, dtype=T.dtype, device=T.device)
    A = torch.where((src | snk)[:, None], eye, eye - T)
    return torch.linalg.solve(A, snk.to(T.dtype))


def mean_first_passage_time(T: Tensor, target, lag: float = 1.0) -> Tensor:
    """MFPT to the ``target`` set from every state (0 on the target):
    ``m = lag + T m`` on the complement, as a masked system."""
    n = T.shape[0]
    tgt = _as_mask(target, n, T.device)
    eye = torch.eye(n, dtype=T.dtype, device=T.device)
    A = torch.where(tgt[:, None], eye, eye - T)
    b = torch.where(tgt, 0.0, lag).to(T.dtype)
    return torch.linalg.solve(A, b)


def reactive_flux(T: Tensor, source, sink, pi: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Transition-path-theory fluxes of the source -> sink reaction
    (Metzner, Schuette & Vanden-Eijnden 2009): ``(gross, net)`` with
    ``f_ij = pi_i (1 - q_i) T_ij q_j`` (i != j) and
    ``f+_ij = max(f_ij - f_ji, 0)``, ``q`` the forward committor."""
    n = T.shape[0]
    if pi is None:
        pi = stationary_distribution(T)
    q = committor(T, source, sink)
    f = (pi * (1.0 - q))[:, None] * T * q[None, :]
    f = f * (1.0 - torch.eye(n, dtype=T.dtype, device=T.device))
    return f, torch.clamp(f - f.T, min=0.0)


def tpt_rate(T: Tensor, source, sink, pi: Optional[Tensor] = None,
             lag: float = 1.0) -> Tensor:
    """TPT rate of the source -> sink reaction: the reactive flux out of
    the source over the reactant population,
    ``k_AB = F / (lag * sum_i pi_i (1 - q_i))``."""
    n = T.shape[0]
    if pi is None:
        pi = stationary_distribution(T)
    src = _as_mask(source, n, T.device)
    f, _ = reactive_flux(T, source, sink, pi)
    total = torch.where(src[:, None], f, 0.0).sum()
    q = committor(T, source, sink)
    reactant = (pi * (1.0 - q)).sum()
    return total / (lag * torch.clamp(reactant, min=1e-30))


def tica(x: Tensor, lag: int, k: Optional[int] = None,
         eps: float = 1e-6) -> Tuple[Tensor, Tensor, Tensor]:
    """Time-lagged independent component analysis (Perez-Hernandez et
    al. 2013): ``C_lag v = lambda C_0 v`` with symmetrized covariances,
    solved through ``C_0^{-1/2} C_lag C_0^{-1/2}`` (``eps`` floors the
    whitening's eigenvalues).

    ``x``: features ``(..., T, d)`` (covariances pool over the batch).
    Returns ``(timescales, components, eigenvalues)``, slowest first; the
    projection vectors are the COLUMNS of ``components`` (project with
    ``(x - mean) @ components``)."""
    if x.dim() == 2:
        x = x[None]
    B = x.reshape(-1, x.shape[-2], x.shape[-1])
    T = B.shape[1]
    if lag < 1 or lag >= T:
        raise ValueError(f"lag must be in [1, T-1], got {lag} for T={T}")
    a = B[:, :-lag].reshape(-1, B.shape[-1])
    b = B[:, lag:].reshape(-1, B.shape[-1])
    mean = 0.5 * (a.mean(0) + b.mean(0))
    a = a - mean
    b = b - mean
    n = a.shape[0]
    c0 = (a.T @ a + b.T @ b) / (2.0 * n)
    ct = (a.T @ b + b.T @ a) / (2.0 * n)
    w0, V0 = torch.linalg.eigh(c0)
    inv_sqrt = V0 @ (V0 / torch.sqrt(torch.clamp(w0, min=eps))[None, :]).T
    s = inv_sqrt @ ct @ inv_sqrt
    s = 0.5 * (s + s.T)
    lam, U = torch.linalg.eigh(s)
    order = torch.argsort(-lam)
    lam = lam[order]
    comps = inv_sqrt @ U[:, order]
    ts = -lag / torch.log(torch.clamp(lam.abs(), 1e-12,
                                      1.0 - _one_ulp(lam.dtype)))
    if k is not None:
        ts, comps, lam = ts[:k], comps[:, :k], lam[:k]
    return ts, comps, lam


def chapman_kolmogorov(dtraj: Tensor, n_states: int, lag: int,
                       factors=(1, 2, 4), reversible: bool = True
                       ) -> Tuple[Tensor, Tensor]:
    """Chapman-Kolmogorov test: for each ``k`` in ``factors``, the model's
    ``T(lag)^k`` against the re-estimated ``T(k lag)``, stacked
    ``(len(factors), n, n)`` each."""
    T1 = transition_matrix(count_matrix(dtraj, n_states, lag),
                           reversible=reversible)
    pred = [torch.linalg.matrix_power(T1, k) for k in factors]
    est = [transition_matrix(count_matrix(dtraj, n_states, lag * k),
                             reversible=reversible) for k in factors]
    return torch.stack(pred), torch.stack(est)

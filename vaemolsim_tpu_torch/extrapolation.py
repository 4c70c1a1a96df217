"""Thermodynamic extrapolation: observables at unsampled temperatures
from the fluctuations at one state point (port of
``vaemolsim_tpu/extrapolation.py``).

With samples at ``beta0``, ``<A>(beta) = <A e^{-d U}> / <e^{-d U}>``
with ``d = beta - beta0``; its Taylor coefficients in ``d`` come from the
joint central moments ``<A dU^k>`` and ``<dU^k>`` by one series
division, at any order.  The moments are one product of the
(order + 1, n_samples) power matrix of centred energies with the sample
matrix, batched over any trailing observables.  :func:`beta_reweight`
is the exact perturbation estimate the extrapolation is held against.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

Tensor = torch.Tensor

__all__ = ["beta_extrapolation_coefficients", "beta_extrapolate",
           "beta_reweight"]


def _series_ratio(num: Tensor, den: Tensor) -> Tensor:
    """Coefficients of ``num(x) / den(x)`` to the input order.  num: (K+1,
    ...), den: (K+1,) with ``den[0]`` nonzero."""
    out = []
    for k in range(num.shape[0]):
        acc = num[k]
        for j in range(k):
            acc = acc - out[j] * den[k - j]
        out.append(acc / den[0])
    return torch.stack(out)


def beta_extrapolation_coefficients(a: Tensor, u: Tensor, order: int = 2
                                    ) -> Tensor:
    """Taylor coefficients ``c_k`` of ``<A>(beta0 + d) = sum_k c_k d^k``
    from samples at ``beta0``: ``a`` (n_samples, ...) observables sharing
    the potential energies ``u`` (n_samples,).  Returns (order + 1,
    ...): ``c_0`` the mean, ``c_1 = -Cov(A, U)``, and so on."""
    if order < 0:
        raise ValueError(f"order must be >= 0, got {order}")
    a = torch.as_tensor(a)
    u = torch.as_tensor(u)
    if u.dim() != 1 or a.shape[0] != u.shape[0]:
        raise ValueError("a and u must share the leading sample axis; "
                         f"got {tuple(a.shape)} vs {tuple(u.shape)}")
    n = u.shape[0]
    du = u - u.mean()
    ones = torch.ones((1, n), dtype=u.dtype, device=u.device)
    pw = (torch.cumprod(torch.cat([ones, du[None].expand(order, n)]), 0)
          if order > 0 else ones)
    fact = torch.tensor([(-1.0) ** k / math.factorial(k)
                         for k in range(order + 1)], dtype=u.dtype,
                        device=u.device)
    den = fact * pw.mean(1)
    flat = a.reshape(n, -1)
    num = fact[:, None] * (pw @ flat) / n
    return _series_ratio(num, den).reshape((order + 1,) + a.shape[1:])


def beta_extrapolate(a: Tensor, u: Tensor, beta0: float, betas,
                     order: int = 2) -> Tensor:
    """``<A>`` extrapolated from samples at ``beta0`` to each target in
    ``betas``: (len(betas), ...), or ``a.shape[1:]`` for a scalar
    target."""
    u = torch.as_tensor(u)
    scalar = torch.as_tensor(betas).dim() == 0
    b = torch.atleast_1d(torch.as_tensor(betas, dtype=u.dtype,
                                         device=u.device))
    c = beta_extrapolation_coefficients(a, u, order)
    d = b - beta0
    powers = d[:, None] ** torch.arange(c.shape[0], device=u.device)
    out = torch.tensordot(powers, c, dims=([1], [0]))
    return out[0] if scalar else out


def beta_reweight(a: Tensor, u: Tensor, beta0: float, betas
                  ) -> Tuple[Tensor, Tensor]:
    """Exact reweighting to each target beta, ``<A>_beta = <A w> / <w>``
    with ``w = e^{-(beta - beta0) U}`` (log-sum-exp stabilised).  Returns
    ``(estimates, ess)``, the effective sample size per target."""
    a = torch.as_tensor(a)
    u = torch.as_tensor(u)
    scalar = torch.as_tensor(betas).dim() == 0
    b = torch.atleast_1d(torch.as_tensor(betas, dtype=u.dtype,
                                         device=u.device))
    logw = -(b[:, None] - beta0) * u[None, :]
    w = torch.exp(logw - torch.logsumexp(logw, 1, keepdim=True))
    est = (w @ a.reshape(a.shape[0], -1)).reshape((b.shape[0],)
                                                  + a.shape[1:])
    ess = 1.0 / (w * w).sum(1)
    if scalar:
        return est[0], ess[0]
    return est, ess

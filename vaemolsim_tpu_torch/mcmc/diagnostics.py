"""MC chain diagnostics over batched chains: autocorrelation, effective
sample size, split R-hat, blocking error and statistical inefficiency
(port of ``vaemolsim_tpu/mcmc/diagnostics.py``).

Inputs are ``(T, n_chains, ...)`` trajectories, time first, as
``run_mcmc(..., collect_every=k)`` returns them (a transposed
``(n_chains, T)`` input makes R-hat vacuous).  Any array-like is taken
(numpy arrays too); results are tensors on the input's device.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

__all__ = ["autocorrelation", "effective_sample_size",
           "potential_scale_reduction", "block_averaging_error",
           "statistical_inefficiency"]


def autocorrelation(x, max_lag: int = 100) -> Tensor:
    """Normalized autocorrelation over axis 0 by FFT: (T, ...) ->
    (min(max_lag, T-1) + 1, ...), rho[0] = 1."""
    x = torch.as_tensor(x)
    T = x.shape[0]
    max_lag = min(max_lag, T - 1)
    x = x - x.mean(0, keepdim=True)
    n_fft = 1 << (2 * T - 1).bit_length()
    f = torch.fft.rfft(x, n=n_fft, dim=0)
    acov = torch.fft.irfft(f * torch.conj(f), n=n_fft, dim=0)[:max_lag + 1]
    return acov / torch.clamp_min(acov[:1], 1e-30)


def effective_sample_size(x, max_lag: int = 100) -> Tensor:
    """ESS per chain by Geyer's initial positive sequence: (T, ...) ->
    (...); NaN for a chain of zero variance (it carries no
    information)."""
    x = torch.as_tensor(x)
    T = x.shape[0]
    rho = autocorrelation(x, max_lag=min(max_lag, T - 1))
    pair_count = (rho.shape[0] - 1) // 2
    pairs = rho[1:1 + 2 * pair_count]
    pair_sums = pairs[0::2] + pairs[1::2]
    keep = torch.cumprod((pair_sums > 0.0).to(rho.dtype), 0)
    tau = 1.0 + 2.0 * (pair_sums * keep).sum(0)
    ess = T / torch.clamp_min(tau, 1.0 / T)
    var = x.var(0, correction=0)
    return torch.where(var > 0.0, ess, torch.full_like(ess, float("nan")))


def potential_scale_reduction(x) -> Tensor:
    """Gelman-Rubin split R-hat: (T, n_chains, ...) -> (...).  Stuck
    chains do not read as converged: identical constants give NaN,
    distinct constants +inf."""
    x = torch.as_tensor(x)
    T = x.shape[0] - (x.shape[0] % 2)
    half = T // 2
    splits = torch.cat([x[:half], x[half:T]], 1)
    chain_means = splits.mean(0)
    chain_vars = splits.var(0, correction=1)
    W = chain_vars.mean(0)
    B = half * chain_means.var(0, correction=1)
    var_hat = (half - 1) / half * W + B / half
    rhat = torch.sqrt(var_hat / torch.clamp_min(W, 1e-30))
    nan = torch.full_like(rhat, float("nan"))
    inf = torch.full_like(rhat, float("inf"))
    return torch.where(W <= 1e-30, torch.where(B <= 1e-30, nan, inf), rhat)


def block_averaging_error(x, n_levels: int = None) -> Tensor:
    """Flyvbjerg-Petersen blocking: the naive standard error of the mean,
    ``sqrt(var / (n - 1))``, at each level of pairwise block averaging,
    level 0 the raw series: (T, ...) -> (n_levels + 1, ...).  The
    estimates rise with the level and plateau at the true error once
    blocks outlast the correlation time."""
    x = torch.as_tensor(x)
    T = x.shape[0]
    max_levels = max(int(T).bit_length() - 5, 1)
    n_levels = max_levels if n_levels is None else min(n_levels, max_levels)
    out = []
    for _ in range(n_levels + 1):
        n = x.shape[0]
        out.append(torch.sqrt(x.var(0, correction=1) / max(n - 1, 1)))
        m = (n // 2) * 2
        x = 0.5 * (x[0:m:2] + x[1:m:2])
    return torch.stack(out)


def statistical_inefficiency(x, max_lag: int = 1000) -> Tensor:
    """``g = T / ESS = 1 + 2 tau_int``: (T, ...) -> (...)."""
    x = torch.as_tensor(x)
    return x.shape[0] / effective_sample_size(x, max_lag=max_lag)

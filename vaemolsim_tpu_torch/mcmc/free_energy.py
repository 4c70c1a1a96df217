"""Free-energy estimation: EXP, BAR, MBAR, AIS, thermodynamic
integration and targeted (learned-map) FEP (port of
``vaemolsim_tpu/mcmc/free_energy.py``).

Conventions, in reduced log-density units as the engine's
(``energy_func`` is a LOG target density).  For unnormalized log
densities ``log p~_a = log p_a + ln Z_a``:

- the dimensionless free-energy difference ``dF(a->b) = -ln(Z_b / Z_a)``;
- the work of the a->b perturbation at samples x ~ p_a,
  ``w = log p~_a(x) - log p~_b(x)`` (:func:`work_values`),

so EXP reads ``dF = -ln <exp(-w)>_a`` and AIS's ``log_z`` estimates
``ln(Z_target / Z_init)``.  Inputs may be tensors or numpy arrays;
results are tensors in the inputs' dtype (float32 as in the JAX
package, which promotes nowhere).  AIS reuses the moves' one trial core.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from vaemolsim_tpu_torch.mcmc.moves import _scaled_trial

Tensor = torch.Tensor

__all__ = ["work_values", "exp_free_energy", "bar_free_energy", "ais",
           "AISResult", "MBARResult", "mbar_free_energy",
           "mbar_from_samples", "mbar_perturbed_free_energy",
           "mbar_expectation", "ti_free_energy", "gauss_legendre_lambdas",
           "targeted_work_values", "targeted_bar", "tfep_loss"]


def work_values(log_prob_from: Callable[[Tensor], Tensor],
                log_prob_to: Callable[[Tensor], Tensor],
                samples: Tensor) -> Tensor:
    """Reduced work ``w = log p~_from(x) - log p~_to(x)`` at ``samples``
    drawn from the *from* state."""
    return log_prob_from(samples) - log_prob_to(samples)


def _log_mean_exp(a: Tensor) -> Tensor:
    return torch.logsumexp(a, 0) - math.log(a.shape[0])


def exp_free_energy(work) -> Tuple[Tensor, Tensor]:
    """Zwanzig exponential averaging, ``dF = -ln <exp(-w)>``, with the
    delta-method standard error computed in log space.  Returns
    ``(delta_f, stderr)``."""
    work = torch.as_tensor(work).reshape(-1)
    n = work.shape[0]
    log_mean = _log_mean_exp(-work)
    log_mean_sq = _log_mean_exp(-2.0 * work)
    ratio = torch.exp(torch.clamp_max(log_mean_sq - 2.0 * log_mean, 60.0))
    stderr = torch.sqrt(torch.clamp_min(ratio - 1.0, 0.0) / n)
    return -log_mean, stderr


def bar_free_energy(work_forward, work_reverse,
                    iters: int = 100) -> Tuple[Tensor, Tensor]:
    """Bennett acceptance ratio from bidirectional work: solves

        sum_i sigmoid(-(M + w_F_i - dF)) = sum_j sigmoid(-(-M + w_R_j + dF)),

    ``M = ln(n_F / n_R)``, by ``iters`` bisections of a bracket padded by
    50 around the two one-sided EXP estimates (the residual is monotone
    in dF).  Returns ``(delta_f, stderr)``, Bennett's asymptotic error."""
    w_f = torch.as_tensor(work_forward).reshape(-1)
    w_r = torch.as_tensor(work_reverse).reshape(-1).to(w_f)
    n_f, n_r = w_f.shape[0], w_r.shape[0]
    M = torch.log(torch.tensor(n_f / n_r, dtype=w_f.dtype,
                               device=w_f.device))
    zero = torch.zeros((), dtype=w_f.dtype, device=w_f.device)

    def residual(df):
        lhs = torch.logsumexp(-torch.logaddexp(zero, M + w_f - df), 0)
        rhs = torch.logsumexp(-torch.logaddexp(zero, -M + w_r + df), 0)
        return lhs - rhs

    ef, _ = exp_free_energy(w_f)
    er, _ = exp_free_energy(w_r)
    lo = torch.minimum(ef, -er) - 50.0
    hi = torch.maximum(ef, -er) + 50.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        go_up = residual(mid) < 0.0
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    delta_f = 0.5 * (lo + hi)

    f_f = torch.sigmoid(-(M + w_f - delta_f))
    f_r = torch.sigmoid(-(-M + w_r + delta_f))

    def leg_var(f, n):
        m1, m2 = f.mean(), (f ** 2).mean()
        return (m2 / torch.clamp_min(m1 ** 2, 1e-38) - 1.0) / n

    stderr = torch.sqrt(torch.clamp_min(leg_var(f_f, n_f)
                                        + leg_var(f_r, n_r), 0.0))
    return delta_f, stderr


class MBARResult(NamedTuple):
    """Output of :func:`mbar_free_energy`: ``free_energies`` (K,) in the
    gauge ``free_energies[0] == 0``; ``stderrs`` (K,) of ``dF(0->k)``;
    ``theta`` (K, K) their asymptotic covariance; ``log_denominator``
    (N,) the per-sample ``ln sum_k N_k exp(f_k + log p~_k(x_n))`` in the
    output gauge; ``counts`` (K,); ``log_probs`` (K, N) the input."""

    free_energies: Tensor
    stderrs: Tensor
    theta: Tensor
    log_denominator: Tensor
    counts: Tensor
    log_probs: Tensor


def _mbar_theta(weights: Tensor, counts: Tensor) -> Tensor:
    """Asymptotic covariance of the MBAR free energies from the (N, K)
    weights (Shirts & Chodera 2008, appendix D; pymbar's ``svd-ew``):
    with ``W^T W = V S^2 V^T``,
    ``Theta = V S (I - S V^T diag(N) V S)^+ S V^T``.  The
    pseudo-inverse drops singular values at most ``10 K eps`` times the
    largest, JAX's default cut (the inner matrix is singular by
    construction, so the cut decides the result)."""
    a = weights.T @ weights
    lam, v = torch.linalg.eigh(a)
    s = torch.sqrt(torch.clamp_min(lam, 0.0))
    inner = (torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
             - s[:, None] * (v.T @ (counts[:, None] * v)) * s[None, :])
    rtol = 10.0 * a.shape[0] * torch.finfo(a.dtype).eps
    return ((v * s[None, :])
            @ torch.linalg.pinv(inner, rtol=rtol, hermitian=True)
            @ (s[:, None] * v.T))


def mbar_free_energy(log_probs, counts, *, sc_iters: int = 200,
                     newton_iters: int = 30) -> MBARResult:
    """Multistate Bennett acceptance ratio (Shirts & Chodera 2008).

    ``log_probs``: (K, N) UNNORMALIZED log densities of every state at
    every pooled sample; ``counts``: (K,) samples each state contributed
    (concrete integers; zero counts are allowed and become perturbation
    estimates).  ``sc_iters`` self-consistent sweeps, then
    ``newton_iters`` Newton steps (norm-clipped to 10) on the convex MBAR
    objective over the gauge-reduced free energies; its gradient and
    Hessian are written out (``sum_n W_n - N``, ``sum_n diag(W_n) - W_n
    W_n^T``, W the per-sample softmax over states).  Uncertainties are
    the asymptotic covariance (pymbar's)."""
    L = torch.as_tensor(log_probs)
    if L.dim() != 2:
        raise ValueError(f"log_probs must be (K, N); got shape "
                         f"{tuple(L.shape)}")
    counts_np = np.asarray(counts)
    K, N = L.shape
    if counts_np.shape != (K,):
        raise ValueError(f"counts must be ({K},); got {counts_np.shape}")
    if int(counts_np.sum()) != N:
        raise ValueError(f"counts sum to {int(counts_np.sum())} but "
                         f"log_probs has {N} pooled samples")
    sampled = np.flatnonzero(counts_np > 0)
    if sampled.size == 0:
        raise ValueError("at least one state must have samples")
    dev, dt = L.device, L.dtype
    Ls = L[torch.as_tensor(sampled, device=dev)]
    Ns = torch.as_tensor(counts_np[sampled], dtype=dt, device=dev)
    logNs = torch.log(Ns)

    def log_denom(fs):
        return torch.logsumexp(logNs[:, None] + fs[:, None] + Ls, 0)

    fs = torch.zeros(sampled.size, dtype=dt, device=dev)
    for _ in range(sc_iters):
        fs = -torch.logsumexp(Ls - log_denom(fs)[None, :], 1)
        fs = fs - fs[0]

    if newton_iters and sampled.size > 1:
        eye = torch.eye(sampled.size - 1, dtype=dt, device=dev)
        zero = torch.zeros((1,), dtype=dt, device=dev)
        f_free = fs[1:] - fs[0]
        for _ in range(newton_iters):
            full = torch.cat([zero, f_free])
            W = torch.softmax(logNs[:, None] + full[:, None] + Ls, 0)[1:]
            g = W.sum(1) - Ns[1:]
            h = torch.diag(W.sum(1)) - W @ W.T + 1e-8 * eye
            step = torch.linalg.solve(h, g)
            norm = torch.linalg.norm(step)
            step = step * torch.clamp_max(
                10.0 / torch.clamp_min(norm, 1e-30), 1.0)
            f_free = f_free - step
        fs = torch.cat([zero, f_free])

    ld = log_denom(fs)
    f_all = -torch.logsumexp(L - ld[None, :], 1)
    f_out = f_all - f_all[0]
    ld_out = ld - f_all[0]
    counts_t = torch.as_tensor(counts_np, dtype=dt, device=dev)
    weights = torch.exp(f_out[None, :] + L.T - ld_out[:, None])
    theta = _mbar_theta(weights, counts_t)
    var = torch.clamp_min(torch.diag(theta) + theta[0, 0]
                          - 2.0 * theta[0, :], 0.0)
    return MBARResult(f_out, torch.sqrt(var), theta, ld_out, counts_t, L)


def mbar_from_samples(log_prob_fns, samples, **kwargs) -> MBARResult:
    """MBAR from K log-density callables and K per-state sample arrays
    ``(n_k, dof...)``: each callable is evaluated on the pooled samples."""
    counts = [int(s.shape[0]) for s in samples]
    pooled = torch.cat([torch.as_tensor(s) for s in samples], 0)
    L = torch.stack([fn(pooled) for fn in log_prob_fns])
    return mbar_free_energy(L, counts, **kwargs)


def mbar_perturbed_free_energy(result: MBARResult,
                               log_prob_new) -> Tuple[Tensor, Tensor]:
    """``dF(0->new)`` of an UNSAMPLED state by MBAR reweighting, its
    error from the covariance of the states augmented by the new one
    with zero counts."""
    lnew = torch.as_tensor(log_prob_new).to(result.log_denominator)
    ld = result.log_denominator
    f_new = -torch.logsumexp(lnew - ld, 0)
    w_new = torch.exp(f_new + lnew - ld)
    weights = torch.exp(result.free_energies[None, :] + result.log_probs.T
                        - ld[:, None])
    w_aug = torch.cat([weights, w_new[:, None]], 1)
    counts_aug = torch.cat([result.counts, result.counts.new_zeros(1)])
    theta = _mbar_theta(w_aug, counts_aug)
    var = torch.clamp_min(theta[-1, -1] + theta[0, 0] - 2.0 * theta[0, -1],
                          0.0)
    return f_new, torch.sqrt(var)


def mbar_expectation(result: MBARResult, values,
                     state=0) -> Tuple[Tensor, Tensor]:
    """``<A>_state`` by MBAR reweighting of the pooled samples:
    ``values`` (N,) the observable; ``state`` a sampled state's index or
    an (N,) unnormalized log density of a (possibly unsampled) state.
    The error is the importance-sampling delta method's (weight variance
    only)."""
    values = torch.as_tensor(values).to(result.log_denominator)
    ld = result.log_denominator
    is_index = isinstance(state, (int, np.integer)) or (
        hasattr(state, "ndim") and state.ndim == 0
        and not torch.is_floating_point(torch.as_tensor(state)))
    if is_index:
        s = int(state)
        logw = result.free_energies[s] + result.log_probs[s] - ld
    else:
        lnew = torch.as_tensor(state).to(ld)
        if lnew.shape != ld.shape:
            raise ValueError(
                f"state must be an integer index or a per-pooled-sample "
                f"log-density array of shape {tuple(ld.shape)}; got "
                f"{tuple(lnew.shape)}")
        logw = -torch.logsumexp(lnew - ld, 0) + lnew - ld
    w = torch.exp(logw - torch.logsumexp(logw, 0))
    mean = (w * values).sum()
    return mean, torch.sqrt(((w * (values - mean)) ** 2).sum())


class AISResult(NamedTuple):
    """Output of :func:`ais`: ``log_z`` the estimate of
    ``ln(Z_target / Z_init)``; ``log_weights`` (n_chains,); ``samples``
    the final chain states; ``ess`` of the normalized weights;
    ``acceptance`` the mean MH acceptance over all sweeps."""

    log_z: Tensor
    log_weights: Tensor
    samples: Tensor
    ess: Tensor
    acceptance: Tensor


def _systematic_resample(log_norm_w: Tensor,
                         generator: torch.Generator) -> Tensor:
    """Systematic resampling: ancestor indices from one uniform draw."""
    n = log_norm_w.shape[0]
    cdf = torch.cumsum(torch.exp(log_norm_w), 0)
    cdf = cdf / cdf[-1]
    u0 = torch.rand((), generator=generator, dtype=cdf.dtype,
                    device=cdf.device)
    u = (u0 + torch.arange(n, dtype=cdf.dtype, device=cdf.device)) / n
    return torch.searchsorted(cdf, u).clamp(0, n - 1)


@torch.no_grad()
def ais(log_prob_init: Callable[[Tensor], Tensor],
        log_prob_target: Callable[[Tensor], Tensor], x0: Tensor,
        generator: torch.Generator, *, betas=None, n_stages: int = 64,
        kind: str = "random_walk", scale: float = 0.1, n_leapfrog: int = 10,
        sweeps_per_stage: int = 1,
        resample_threshold: Optional[float] = None) -> AISResult:
    """Annealed importance sampling (Neal 2001) from exact samples ``x0``
    of a normalized initial density to an unnormalized target, along
    ``log pi_b = (1 - b) log_prob_init + b log_prob_target`` over
    ``betas`` (default linear with ``n_stages`` stages).  Each stage adds
    the weight increment at the current state, optionally resamples
    (systematically, when the weights' ESS falls below
    ``resample_threshold * n_chains``, one host read a stage), then runs
    ``sweeps_per_stage`` local-move trials (``kind``: random_walk, mala,
    hmc) targeting ``pi_b``."""
    x = torch.as_tensor(x0)
    if betas is None:
        betas = torch.linspace(0.0, 1.0, n_stages + 1, dtype=x.dtype,
                               device=x.device)
    betas = torch.as_tensor(betas, dtype=x.dtype, device=x.device)
    n_chains = x.shape[0]
    logw = torch.zeros(n_chains, dtype=x.dtype, device=x.device)
    log_z_acc = torch.zeros((), dtype=x.dtype, device=x.device)
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for k in range(1, betas.shape[0]):
        b, db = betas[k], betas[k] - betas[k - 1]
        logw = logw + db * (log_prob_target(x) - log_prob_init(x))
        if resample_threshold is not None:
            log_norm = logw - torch.logsumexp(logw, 0)
            ess = torch.exp(-torch.logsumexp(2.0 * log_norm, 0))
            if float(ess) < resample_threshold * n_chains:
                x = x[_systematic_resample(log_norm, generator)]
                log_z_acc = log_z_acc + _log_mean_exp(logw)
                logw = torch.zeros_like(logw)

        def lt(y, b=b):
            return (1.0 - b) * log_prob_init(y) + b * log_prob_target(y)

        e = lt(x)
        for _ in range(sweeps_per_stage):
            x, e, accept = _scaled_trial(kind, lt, x, e, scale, generator,
                                         n_leapfrog)
            acc = acc + accept.float().mean() / sweeps_per_stage
    log_norm = logw - torch.logsumexp(logw, 0)
    return AISResult(log_z=log_z_acc + _log_mean_exp(logw), log_weights=logw,
                     samples=x,
                     ess=torch.exp(-torch.logsumexp(2.0 * log_norm, 0)),
                     acceptance=acc / (betas.shape[0] - 1))


def gauss_legendre_lambdas(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes and weights on [0, 1] (weights sum to 1), the
    lambda schedule for :func:`ti_free_energy`; host-side numpy."""
    x, w = np.polynomial.legendre.leggauss(int(n))
    return (0.5 * (x + 1.0)).astype(np.float64), (0.5 * w).astype(np.float64)


def ti_free_energy(dudl, lambdas=None, *, weights=None,
                   statistical_inefficiency=1.0) -> Tuple[Tensor, Tensor]:
    """Thermodynamic integration ``dF = int_0^1 <dU/dlam> dlam`` from
    ``dudl`` (K, n_samples...) of the reduced alchemical derivative at K
    states, by quadrature ``weights`` (K,) or the composite trapezoid on
    a sorted ``lambdas`` grid (exactly one).  The error propagates each
    state's SEM, ``sqrt(sum_k w_k^2 g_k var_k / n_k)``, with the
    statistical inefficiency ``g`` (scalar or (K,))."""
    dudl = torch.as_tensor(dudl)
    k = dudl.shape[0]
    flat = dudl.reshape(k, -1)
    n = flat.shape[1]
    if (weights is None) == (lambdas is None):
        raise ValueError("pass exactly one of weights= or lambdas=")
    opts = dict(dtype=flat.dtype, device=flat.device)
    if weights is not None:
        w = torch.as_tensor(weights, **opts)
    else:
        lam = torch.as_tensor(lambdas, **opts)
        if tuple(lam.shape) != (k,):
            raise ValueError(f"lambdas must be ({k},); got "
                             f"{tuple(lam.shape)}")
        d = torch.diff(lam)
        z = torch.zeros(1, **opts)
        w = 0.5 * (torch.cat([d, z]) + torch.cat([z, d]))
    if tuple(w.shape) != (k,):
        raise ValueError(f"weights must be ({k},); got {tuple(w.shape)}")
    means = flat.mean(1)
    var = flat.var(1, correction=0)
    g = torch.as_tensor(statistical_inefficiency, **opts).expand(k)
    return (w * means).sum(), torch.sqrt((w * w * g * var / n).sum())


def _resolve_map(bijector, map_and_log_det, inverse):
    if (bijector is None) == (map_and_log_det is None):
        raise ValueError(
            "pass exactly one of bijector= or map_and_log_det=")
    if map_and_log_det is not None:
        if inverse:
            raise ValueError(
                "inverse=True only applies to bijector=; pass the "
                "reverse-direction callable as map_and_log_det= instead")
        return map_and_log_det
    return (bijector.inverse_and_log_det if inverse
            else bijector.forward_and_log_det)


def targeted_work_values(log_prob_from: Callable[[Tensor], Tensor],
                         log_prob_to: Callable[[Tensor], Tensor],
                         samples: Tensor, *, bijector=None,
                         map_and_log_det: Optional[Callable] = None,
                         inverse: bool = False) -> Tensor:
    """Flow-mapped work (Wirnsberger et al., J. Chem. Phys. 153, 144112
    (2020)): ``w_T = log p~_from(x) - log p~_to(M(x)) - log|det J_M(x)|``
    for x ~ p_from.  The map is ``bijector=`` (a flow's
    ``as_bijector()``; ``inverse=True`` for its inverse direction) or
    ``map_and_log_det=`` (``x -> (y, log|det J|)``), exactly one."""
    fwd = _resolve_map(bijector, map_and_log_det, inverse)
    mapped, ldj = fwd(samples)
    lp = log_prob_from(samples)
    if tuple(ldj.shape) != tuple(lp.shape):
        raise ValueError(
            f"log-det shape {tuple(ldj.shape)} does not match log-prob "
            f"shape {tuple(lp.shape)}; wrap scalar bijectors in "
            "ops.bijectors.Block so the log-det reduces over event dims")
    return lp - log_prob_to(mapped) - ldj


def targeted_bar(log_prob_a: Callable[[Tensor], Tensor],
                 log_prob_b: Callable[[Tensor], Tensor],
                 samples_a: Tensor, samples_b: Tensor, *, bijector=None,
                 map_and_log_det: Optional[Callable] = None,
                 inverse_map_and_log_det: Optional[Callable] = None,
                 iters: int = 100) -> Tuple[Tensor, Tensor]:
    """BAR on mapped work from both ends: ``samples_a`` through M,
    ``samples_b`` through M^-1 (both from ``bijector=``, or the two
    callables).  Returns ``(delta_f(a->b), stderr)``."""
    if bijector is not None:
        if map_and_log_det is not None or inverse_map_and_log_det is not None:
            raise ValueError("pass bijector= or the callable pair, not both")
        fwd, inv = bijector.forward_and_log_det, bijector.inverse_and_log_det
    else:
        if map_and_log_det is None or inverse_map_and_log_det is None:
            raise ValueError(
                "without bijector=, pass both map_and_log_det= and "
                "inverse_map_and_log_det=")
        fwd, inv = map_and_log_det, inverse_map_and_log_det
    w_f = targeted_work_values(log_prob_a, log_prob_b, samples_a,
                               map_and_log_det=fwd)
    w_r = targeted_work_values(log_prob_b, log_prob_a, samples_b,
                               map_and_log_det=inv)
    return bar_free_energy(w_f, w_r, iters=iters)


def tfep_loss(log_prob_from: Callable[[Tensor], Tensor],
              log_prob_to: Callable[[Tensor], Tensor], samples: Tensor, *,
              bijector=None,
              map_and_log_det: Optional[Callable] = None) -> Tensor:
    """The targeted map's training objective, the mean mapped work
    ``<w_T>_from = KL(M#p_from || p_to) + dF >= dF``; differentiable with
    respect to the map's parameters (samples are fixed data)."""
    return targeted_work_values(
        log_prob_from, log_prob_to, samples, bijector=bijector,
        map_and_log_det=map_and_log_det).mean()

"""Differentiable trajectory reweighting (DiffTRe): top-down training of
potential parameters on ensemble observables (port of
``vaemolsim_tpu/difftre.py``).

Thaler & Zavadlav, Nat. Commun. 12, 6884 (2021): to fit ``U_theta`` so
that ensemble averages ``<O>_theta`` match targets, reweight a reference
trajectory sampled at the current parameters ``theta_hat`` instead of
differentiating through the integrator:

    <O>_theta = sum_i w_i(theta) O(theta, x_i),
    w_i ~ exp(-beta (U_theta(x_i) - U_theta_hat(x_i))).

At ``theta = theta_hat`` the weights are uniform, and differentiating
through them gives the full statistical-mechanics gradient
``<dO/dtheta> - beta Cov(O, dU/dtheta)``.  Training alternates reweighted
gradient steps with a fresh trajectory whenever the effective sample size
decays.

Parameters are a tensor or a dict, tuple or list of tensors; observables,
targets and weights are dicts, tuples or lists of the same structure
(dict entries in sorted key order, as JAX flattens them).  The inner
phase is a Python loop of optimizer steps with one host read of the ESS
a step; the sampler is whatever the caller provides (``md._BAOAB``'s
replayed runner, ``md.baoab``, ``mcmc.run_mcmc``) and frames stay on its
device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["reweighted_observables", "difftre_loss", "difftre_fit",
           "static_observable", "DiffTReResult"]


def _tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (anything but a dict, list or
    tuple), with the matching leaves of ``rest``; dicts in sorted key
    order."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        out = [_tree_map(fn, c, *(r[i] for r in rest))
               for i, c in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return fn(tree, *rest)


def _tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in _tree_leaves(c)]
    return [tree]


def _tree_unflatten(tree, leaves):
    """``tree``'s structure with its leaves replaced, in
    :func:`_tree_leaves` order, by ``leaves``."""
    it = iter(leaves)
    return _tree_map(lambda _: next(it), tree)


def _f32_value(a: float) -> float:
    """``a`` rounded to float32, as JAX compares a Python scalar with a
    float32 array."""
    return float(torch.tensor(a, dtype=torch.float32))


def _trainable(params, optimizer: Optional[Callable],
               learning_rate: float):
    """Trainable float32 copies of ``params``' leaves, the optimizer over
    them (``optimizer(leaves)``, by default Adam at ``learning_rate``),
    and ``params``' structure around them."""
    leaves = [torch.as_tensor(p).detach().clone().requires_grad_(True)
              for p in _tree_leaves(params)]
    opt = (optimizer or (lambda ps: torch.optim.Adam(
        ps, lr=learning_rate)))(leaves)
    return leaves, opt, _tree_unflatten(params, leaves)


def _detached(params, leaves):
    """``params``' structure around detached ``leaves``."""
    return _tree_unflatten(params, [p.detach() for p in leaves])


def static_observable(fn: Callable) -> Callable:
    """Mark a parameter-independent observable ``fn(frames) -> (n, ...)``
    (RDF bins, structure factors, order parameters): :func:`difftre_fit`
    evaluates it once per trajectory and feeds the cached per-frame values
    to every inner step.  The returned callable keeps the ``(params,
    frames)`` signature, so it composes with
    :func:`reweighted_observables` directly."""

    def wrapped(params, frames):
        return fn(frames)

    wrapped._difftre_static = True
    return wrapped


def _normalized_log_weights(potential: Callable, params: Any,
                            frames: Tensor, u_ref: Tensor,
                            beta: float) -> Tensor:
    u = potential(params, frames)
    logw = -beta * (u - u_ref)
    return logw - torch.logsumexp(logw, 0)


def reweighted_observables(potential: Callable, params: Any,
                           frames: Tensor, u_ref: Tensor, beta: float,
                           observable_fns: Any) -> Tuple[Any, Tensor]:
    """Reweighted ensemble estimates ``<O>_params`` from reference frames,
    differentiable in ``params`` through both the weights and any explicit
    parameter dependence of the observables.

    ``potential(params, frames) -> (n,)`` batched energies; ``u_ref``: the
    frames' energies under the parameters that generated them (uniform
    weights and ``ess = n`` at ``params == params_ref``);
    ``observable_fns``: a tree of callables ``obs(params, frames) -> (n,
    ...)``.  Returns ``(estimates, ess)``: the estimates in the tree's
    structure and the effective sample size ``1 / sum_i w_i^2``."""
    w = torch.exp(_normalized_log_weights(potential, params, frames, u_ref,
                                          beta))
    ess = 1.0 / (w * w).sum()

    def one(fn):
        return torch.tensordot(w, fn(params, frames), dims=([0], [0]))

    return _tree_map(one, observable_fns), ess


def difftre_loss(potential: Callable, params: Any, frames: Tensor,
                 u_ref: Tensor, beta: float, observable_fns: Any,
                 targets: Any, weights: Any = None
                 ) -> Tuple[Tensor, Tuple[Any, Tensor]]:
    """Weighted mean-squared mismatch of the reweighted estimates to their
    targets, ``sum_k w_k mean((<O_k>_params - target_k)^2)`` (mean over
    the components of vector observables).  Returns ``(loss, (estimates,
    ess))``."""
    est, ess = reweighted_observables(potential, params, frames, u_ref,
                                      beta, observable_fns)
    if weights is None:
        weights = _tree_map(lambda _: 1.0, observable_fns)

    def one(e, t, w):
        t = torch.as_tensor(t, dtype=e.dtype, device=e.device)
        return w * ((e - t) ** 2).mean()

    loss = torch.zeros((), dtype=ess.dtype, device=ess.device)
    for term in _tree_leaves(_tree_map(one, est, targets, weights)):
        loss = loss + term
    return loss, (est, ess)


class DiffTReResult(NamedTuple):
    """``params``: the trained parameters, in the structure given.
    ``history``: per outer round, ``loss`` (at the start of the inner
    phase, with fresh uniform weights: the unbiased estimate),
    ``ess_end`` (the effective sample size of the inner phase's last
    step), ``inner_steps`` (gradient steps taken before the ESS floor or
    the cap) and ``estimates`` (the fresh trajectory's estimates)."""

    params: Any
    history: Dict[str, Any]


def difftre_fit(potential: Callable, params: Any, *,
                sample_fn: Callable, observable_fns: Any, targets: Any,
                beta: float, generator: torch.Generator,
                n_outer: int = 10, inner_steps: int = 30,
                ess_frac: float = 0.5,
                optimizer: Optional[Callable] = None,
                learning_rate: float = 1e-2,
                weights: Any = None,
                sample_state: Any = None) -> DiffTReResult:
    """The full DiffTRe loop.

    Each outer round regenerates the reference trajectory at the current
    parameters by ``sample_fn(params, generator, sample_state) -> (frames,
    sample_state)`` (frames ``(n, ...)``; thread MD / MC state through
    ``sample_state`` to warm-start, or return None).  ``sample_fn`` gets
    detached parameters: sampling is outside the gradient.  The inner
    phase takes ``optimizer`` steps on :func:`difftre_loss`: each step
    computes the loss, gradient and ESS at the current parameters and
    applies the update; the phase ends after ``inner_steps`` steps or
    after the first step whose ESS was below ``ess_frac * n`` (the weights
    have concentrated and a fresh trajectory is due).

    ``optimizer``: a factory ``params -> torch.optim.Optimizer`` (as
    ``train.fit`` takes), built once per fit so that its moments persist
    across rounds; by default Adam at ``learning_rate``."""
    leaves, opt, live = _trainable(params, optimizer, learning_rate)

    # Static (parameter-independent) observables are evaluated once per
    # trajectory; the inner steps read their cached per-frame values.
    obs_leaves = _tree_leaves(observable_fns)
    static = [bool(getattr(f, "_difftre_static", False))
              for f in obs_leaves]

    def effective_obs(static_vals):
        it = iter(static_vals)
        return _tree_unflatten(observable_fns, [
            (lambda p, f, v=next(it): v) if s else f
            for f, s in zip(obs_leaves, static)])

    history: Dict[str, Any] = {"loss": [], "ess_end": [],
                               "inner_steps": [], "estimates": []}
    for _ in range(n_outer):
        fixed = _detached(params, leaves)
        frames, sample_state = sample_fn(fixed, generator, sample_state)
        n = frames.shape[0]
        floor = _f32_value(ess_frac * n)
        with torch.no_grad():
            u_ref = potential(fixed, frames)
            static_vals = [f(fixed, frames)
                           for f, s in zip(obs_leaves, static) if s]
        obs = effective_obs(static_vals)
        loss0, (est0, _) = difftre_loss(potential, fixed, frames, u_ref,
                                        beta, obs, targets, weights)
        steps, ess = 0, float(n)
        while steps < inner_steps and ess >= floor:
            opt.zero_grad(set_to_none=True)
            loss, (_, ess_t) = difftre_loss(potential, live, frames, u_ref,
                                            beta, obs, targets, weights)
            loss.backward()
            ess = float(ess_t.detach())
            opt.step()
            steps += 1
        history["loss"].append(float(loss0))
        history["ess_end"].append(ess)
        history["inner_steps"].append(steps)
        history["estimates"].append(_tree_map(lambda a: a.detach(), est0))
    return DiffTReResult(params=_detached(params, leaves), history=history)

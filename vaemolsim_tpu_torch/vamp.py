"""VAMPnets: learned kinetic featurization by VAMP-score maximization
(port of ``vaemolsim_tpu/vamp.py``).

A neural lobe ``chi(x)`` is trained to maximize the VAMP-2 score of
transition pairs (Wu & Noe 2020; Mardt et al. 2018), the deep extension
of ``msm.tica``: with a softmax head its outputs are fuzzy metastable
memberships.

- The VAMP-2 score ``1 + || C00^{-1/2} C0t Ctt^{-1/2} ||_F^2`` is a trace
  of matmuls: the differentiated graph holds covariance matmuls and two
  ``eigh`` of (k, k) matrices, no SVD.
- The covariance inverse square roots are TRIMMED pseudo-inverses:
  eigen-directions below ``eps * max(w)`` are projected out, not clamped
  (mean-free softmax features are exactly rank-deficient), with a
  ``where``-guarded rsqrt whose gradient stays finite at the null
  direction.
- The lobe is the port's ``nn.core.MLP``, a loop of ``Dense`` layers,
  as in the JAX package.

Typical flow::

    net = VAMPNet.create(generator, in_dim=d, k=3)
    net, hist = train.fit(net, lambda m, b, g: m.loss(*b), (x0, xt),
                          generator=generator, ...)
    ts = vamp_timescales(net.singular_values(x0, xt), lag_time)
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.nn.core import MLP

Tensor = torch.Tensor

__all__ = ["vamp_score", "koopman_singular_values", "vamp_timescales",
           "VAMPNet", "lagged_pairs"]


def _mean_free(a: Tensor) -> Tensor:
    return a - a.mean(0, keepdim=True)


def _inv_sqrt_psd(c: Tensor, eps: float) -> Tensor:
    """Pseudo-inverse square root of a PSD matrix by ``eigh``: directions
    with eigenvalue at or below ``eps * max(w)`` get weight zero (the
    JAX package's trimmed estimator, deeptime's 'trunc' mode)."""
    w, v = torch.linalg.eigh(c)
    keep = w > eps * w.max()
    w_safe = torch.where(keep, w, torch.ones_like(w))
    inv = torch.where(keep, torch.rsqrt(w_safe), torch.zeros_like(w))
    return (v * inv) @ v.T


def _whitened_koopman(chi0: Tensor, chit: Tensor, eps: float) -> Tensor:
    """``K_w = C00^{-1/2} C0t Ctt^{-1/2}`` from mean-free features."""
    if chi0.dim() != 2 or chi0.shape != chit.shape:
        raise ValueError(
            f"chi0/chit must be matching (n_pairs, k); got "
            f"{tuple(chi0.shape)} vs {tuple(chit.shape)}")
    n = chi0.shape[0]
    a = _mean_free(chi0)
    b = _mean_free(chit)
    c00 = a.T @ a / n
    c0t = a.T @ b / n
    ctt = b.T @ b / n
    return _inv_sqrt_psd(c00, eps) @ c0t @ _inv_sqrt_psd(ctt, eps)


def vamp_score(chi0: Tensor, chit: Tensor, *, method: str = "vamp2",
               eps: float = 1e-4) -> Tensor:
    """VAMP score of featurized transition pairs ``(n_pairs, k)`` each,
    differentiable, to be maximized.  ``"vamp2"``: ``1 + sum sigma_i^2``
    (a Frobenius norm, no SVD); ``"vamp1"``: ``1 + sum sigma_i``.
    ``eps``: the relative eigenvalue cut of the covariance
    pseudo-inverses."""
    kw = _whitened_koopman(chi0, chit, eps)
    if method == "vamp2":
        return 1.0 + (kw * kw).sum()
    if method == "vamp1":
        return 1.0 + torch.linalg.svdvals(kw).sum()
    raise ValueError(f"unknown VAMP method: {method!r}")


def koopman_singular_values(chi0: Tensor, chit: Tensor, *,
                            eps: float = 1e-4) -> Tensor:
    """Singular values of the whitened Koopman matrix, descending."""
    return torch.linalg.svdvals(_whitened_koopman(chi0, chit, eps))


def vamp_timescales(singular_values: Tensor, lag_time: float) -> Tensor:
    """Implied timescales ``-lag / ln sigma_i``; ``sigma >= 1`` maps to
    +inf."""
    s = torch.clamp(torch.as_tensor(singular_values), min=0.0)
    ts = -lag_time / torch.log(torch.clamp(s, 1e-12, 1.0 - 1e-12))
    return torch.where(s >= 1.0, torch.inf, ts)


class VAMPNet(nn.Module):
    """A feature lobe trained by VAMP-2 maximization: one MLP applied to
    both ends of a pair.  ``softmax=True`` makes the k outputs fuzzy state
    memberships; ``False`` gives unconstrained collective variables."""

    def __init__(self, lobe: MLP, softmax: bool = True, eps: float = 1e-4):
        super().__init__()
        self.lobe = lobe
        self.softmax = bool(softmax)
        self.eps = float(eps)

    @classmethod
    def create(cls, generator: torch.Generator, in_dim: int, k: int, *,
               hidden_dims: Sequence[int] = (64, 64),
               activation: str = "gelu", softmax: bool = True,
               eps: float = 1e-4, device=None) -> "VAMPNet":
        """A lobe ``in_dim -> hidden_dims -> k`` drawn from ``generator``,
        on ``device`` (the card by default)."""
        return cls(MLP.create(generator, in_dim, list(hidden_dims), k,
                              activation=activation,
                              device=default_device(device)),
                   softmax=softmax, eps=eps)

    def forward(self, x: Tensor) -> Tensor:
        """Features / state memberships, ``(..., in_dim) -> (..., k)``."""
        y = self.lobe(x)
        return torch.softmax(y, -1) if self.softmax else y

    def loss(self, x0: Tensor, xt: Tensor) -> Tensor:
        """Negative VAMP-2 score of the batch of pairs (minimize)."""
        return -vamp_score(self(x0), self(xt), method="vamp2", eps=self.eps)

    def singular_values(self, x0: Tensor, xt: Tensor) -> Tensor:
        return koopman_singular_values(self(x0), self(xt), eps=self.eps)

    def koopman_matrix(self, x0: Tensor, xt: Tensor) -> Tensor:
        """The Koopman matrix in the trimmed whitened mean-free feature
        basis, ``C00^{-1/2} C0t C00^{-1/2}``: its eigenvalue magnitudes
        estimate the nontrivial transfer-operator eigenvalues."""
        a = _mean_free(self(x0))
        b = _mean_free(self(xt))
        n = a.shape[0]
        w = _inv_sqrt_psd(a.T @ a / n, self.eps)
        return w @ (a.T @ b / n) @ w


def lagged_pairs(x: Tensor, lag: int) -> Tuple[Tensor, Tensor]:
    """Trajectories ``(..., T, d)`` as transition-pair ends ``(n_pairs,
    d)`` at ``lag`` frames, pooled over the batch."""
    if x.dim() == 2:
        x = x[None]
    b = x.reshape(-1, x.shape[-2], x.shape[-1])
    T = b.shape[1]
    if lag < 1 or lag >= T:
        raise ValueError(f"lag must be in [1, T-1], got {lag} for T={T}")
    return (b[:, :-lag].reshape(-1, b.shape[-1]),
            b[:, lag:].reshape(-1, b.shape[-1]))

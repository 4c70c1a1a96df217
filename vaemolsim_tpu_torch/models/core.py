"""Model compositions: mapping to distribution, flow model and VAE (port
of ``vaemolsim_tpu/models/core.py``).

MappingToDistribution, FlowModel, the VAE with its forward pass,
``elbo_loss``, ``iwae_loss``, ``hvae_elbo_loss`` and ``sample``, and the
dual-ELBO VAE (``VAEDualELBO``, ``dual_elbo_loss``).

``hvae_elbo_loss`` differentiates through the gradients of its leapfrog
steps: each is taken with ``create_graph=True`` through the decoder and
the prior, whose kernel routes recompute their plain versions in grad
mode then (``_build._PlainGrad``), so the loss's gradient holds their
second derivatives.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vaemolsim_tpu_torch import losses as loss_lib
from vaemolsim_tpu_torch.config import default_device
from vaemolsim_tpu_torch.dists.layers import StaticFlowedDistribution
from vaemolsim_tpu_torch.nn.mappings import FCDeepNN
from vaemolsim_tpu_torch.ops import distributions as dl

Tensor = torch.Tensor

__all__ = ["MappingToDistribution", "FlowModel", "VAE", "VAEOutput",
           "VAEDualELBO", "DualVAEOutput"]


def _call_dist_layer(layer, raw, conditional_input, train):
    """Call a dist layer, passing the conditional input only when the
    layer is conditional."""
    if getattr(layer, "conditional", False):
        return layer(raw, conditional_input=conditional_input, train=train)
    return layer(raw, train=train)


def _unweighted(reg, value: Tensor) -> Tensor:
    """A regularizer's value before its weight (0 at weight 0)."""
    w = getattr(reg, "weight", 1.0)
    return value / w if w != 0 else torch.zeros_like(value)


def _resolve_prior_dist(prior, shape_sample, train):
    """A prior is a distribution or a dist layer (called with the sample,
    for its shape only)."""
    if isinstance(prior, dl.Distribution):
        return prior
    return _call_dist_layer(prior, shape_sample, None, train)


class MappingToDistribution(nn.Module):
    """Mapping network feeding a distribution layer: the encoder/decoder
    building block.  ``create`` sizes an FCDeepNN from the layer's
    ``params_size()`` when no mapping is given."""

    def __init__(self, mapping: Any, dist: Any, name: str = "map_to_dist"):
        super().__init__()
        self.mapping = mapping
        self.dist = dist
        self.name = name

    @classmethod
    def create(cls, generator: torch.Generator, dist: Any,
               input_shape: Union[int, Sequence[int]], mapping: Any = None,
               mapping_kwargs: Optional[dict] = None,
               name: str = "map_to_dist", device=None
               ) -> "MappingToDistribution":
        device = default_device(device)
        if mapping is None:
            if not hasattr(dist, "params_size"):
                raise TypeError(
                    f"{type(dist).__name__} has no params_size(), so a "
                    "mapping cannot be auto-sized; pass mapping=")
            mapping = FCDeepNN.create(generator, input_shape,
                                      dist.params_size(), device=device,
                                      **(mapping_kwargs or {}))
        return cls(mapping, dist, name)

    @property
    def conditional(self) -> bool:
        return getattr(self.dist, "conditional", False)

    def forward(self, inputs: Tensor, train: bool = False):
        params = self.mapping(inputs, train=train)
        return _call_dist_layer(self.dist, params, inputs, train)




class FlowModel(nn.Module):
    """Optional mapping + flowed distribution: the density-estimation
    model.  With a :class:`StaticFlowedDistribution` (a fixed base) no
    mapping is used and the inputs only matter as conditional context
    and batch shape.  ``predict`` samples the output distribution."""

    def __init__(self, flowed_dist: Any, mapping: Any = None):
        super().__init__()
        self.flowed_dist = flowed_dist
        self.mapping = mapping

    @classmethod
    def create(cls, generator: torch.Generator, flowed_dist: Any,
               input_shape: Optional[Union[int, Sequence[int]]] = None,
               mapping: Any = None, mapping_kwargs: Optional[dict] = None,
               device=None) -> "FlowModel":
        device = default_device(device)
        if mapping is None and not isinstance(flowed_dist,
                                              StaticFlowedDistribution):
            if input_shape is None:
                raise ValueError("input_shape required to auto-build the "
                                 "mapping for a non-static flowed dist")
            mapping = FCDeepNN.create(generator, input_shape,
                                      flowed_dist.params_size(),
                                      device=device,
                                      **(mapping_kwargs or {}))
        return cls(flowed_dist, mapping)

    def forward(self, inputs: Tensor, train: bool = False):
        params = (self.mapping(inputs, train=train)
                  if self.mapping is not None else inputs)
        return _call_dist_layer(self.flowed_dist, params, inputs, train)

    def log_prob(self, inputs: Tensor, targets: Optional[Tensor] = None,
                 train: bool = False) -> Tensor:
        """Density of ``targets`` (by default the inputs: maximum-likelihood
        training of an unconditional flow)."""
        dist = self(inputs, train=train)
        return dist.log_prob(inputs if targets is None else targets)

    def predict(self, inputs: Tensor, generator: torch.Generator,
                train: bool = False) -> Tensor:
        """One sample per input row (a static flowed distribution has no
        batch axis of its own)."""
        dist = self(inputs, train=train)
        if tuple(dist.batch_shape) == () and inputs.dim() > 1:
            return dist.sample(generator, (inputs.shape[0],))
        return dist.sample(generator)


@dataclass
class VAEOutput:
    """Forward-pass output: the encoder's distribution and sample, the
    prior and decoder distributions, and the regularizer's value."""

    encode_dist: Any
    encode_sample: Tensor
    prior_dist: Any
    decode_dist: Any
    regularizer_loss: Tensor
    kl_div: Tensor  # the regularizer before its weight


class VAE(nn.Module):
    """Standard VAE: encode, sample, build the prior (from the sample, for
    shape only), regularize, decode.  ``regularizer`` is one of the
    ``losses`` regularizers (KL by default); the reconstruction loss is
    applied by :meth:`elbo_loss` or the training loop."""

    def __init__(self, encoder: Any, decoder: Any, prior: Any,
                 regularizer: Any = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.prior = prior
        self.regularizer = (loss_lib.KLDivergenceEstimate()
                            if regularizer is None else regularizer)

    def _prior_dist(self, shape_sample: Tensor, train: bool):
        return _resolve_prior_dist(self.prior, shape_sample, train)

    def forward(self, inputs: Tensor, generator: torch.Generator,
                train: bool = False) -> VAEOutput:
        encode_dist = self.encoder(inputs, train=train)
        z = encode_dist.sample(generator)
        prior_dist = self._prior_dist(z, train)
        reg_loss = self.regularizer(encode_dist, prior_dist, samples=z,
                                    generator=generator)
        return VAEOutput(encode_dist, z, prior_dist,
                         self.decoder(z, train=train), reg_loss,
                         _unweighted(self.regularizer, reg_loss))

    def elbo_loss(self, inputs: Tensor, generator: torch.Generator,
                  train: bool = True) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Negative ELBO = reconstruction NLL + regularizer, with the
        metrics (loss, recon_nll, kl_div, regularizer_loss)."""
        out = self(inputs, generator, train=train)
        recon = -out.decode_dist.log_prob(inputs).mean()
        total = recon + out.regularizer_loss
        return total, {"loss": total, "recon_nll": recon,
                       "kl_div": out.kl_div,
                       "regularizer_loss": out.regularizer_loss}

    def iwae_loss(self, inputs: Tensor, generator: torch.Generator,
                  n_samples: int = 8, train: bool = True) -> Tensor:
        """Importance-weighted negative bound (Burda et al. 2016) with
        ``n_samples`` posterior draws, taken as one leading batch axis:
        the encoder runs once, the prior and decoder on all draws."""
        encode_dist = self.encoder(inputs, train=train)
        z = encode_dist.sample(generator, (n_samples,))  # (K, batch, d_z)
        prior_dist = self._prior_dist(z, train)
        log_w = (self.decoder(z, train=train).log_prob(inputs)
                 + prior_dist.log_prob(z) - encode_dist.log_prob(z))
        bound = torch.logsumexp(log_w, 0) - math.log(n_samples)
        return -bound.mean()

    def hvae_elbo_loss(self, inputs: Tensor, generator: torch.Generator,
                       n_leapfrog: int = 5, step_size=0.1,
                       train: bool = True) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Hamiltonian VAE negative bound (Caterini, Doucet & Sejdinovic
        2018): the encoder's sample z0 and a momentum rho0 ~ N(0, I)
        take ``n_leapfrog`` deterministic leapfrog steps of ``step_size``
        (a scalar or per-dimension) on log p(x, z) = log p(x|z) +
        log p(z), and the bound is

            log p(x, z_K) + log N(rho_K) - log q(z0|x) - log N(rho0),

        the one-sample ELBO at ``n_leapfrog=0``.  Gradients flow through
        the trajectory (see the module docstring)."""
        encode_dist = self.encoder(inputs, train=train)
        z0 = encode_dist.sample(generator)
        rho0 = torch.randn(z0.shape, generator=generator, dtype=z0.dtype,
                           device=z0.device)
        return self._hvae_loss(inputs, encode_dist, z0, rho0, n_leapfrog,
                               step_size, train)

    def _hvae_loss(self, inputs: Tensor, encode_dist, z0: Tensor,
                   rho0: Tensor, n_leapfrog: int, step_size, train: bool,
                   trajectory: Optional[list] = None
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """The HVAE bound's loss and metrics from the draws z0 and rho0;
        the inner gradients are taken under ``enable_grad``, and keep
        their graph only where the caller tracks gradients.  Each
        position the leapfrog visits, z0 first, is appended to
        ``trajectory`` when one is given."""
        keep_graph = torch.is_grad_enabled()
        prior_dist = self._prior_dist(z0, train)
        eps = torch.as_tensor(step_size, dtype=z0.dtype, device=z0.device)

        def neg_u(z):  # log p(x, z) per batch element
            return (self.decoder(z, train=train).log_prob(inputs)
                    + prior_dist.log_prob(z))

        def grad_neg_u(z):
            with torch.enable_grad():
                if not z.requires_grad:
                    z = z.detach().requires_grad_(True)
                e = neg_u(z)
                (g,) = torch.autograd.grad(e.sum(), z,
                                           create_graph=keep_graph)
            if not keep_graph:
                e, g = e.detach(), g.detach()
            return e, g

        lp_joint, g = grad_neg_u(z0)
        z, rho = z0, rho0 + 0.5 * eps * g
        if trajectory is not None:
            trajectory.append(z0)
        for _ in range(n_leapfrog):
            z = z + eps * rho
            if trajectory is not None:
                trajectory.append(z)
            lp_joint, g = grad_neg_u(z)
            rho = rho + eps * g
        rho = rho - 0.5 * eps * g
        if n_leapfrog == 0:
            rho = rho0  # the two half kicks cancel exactly

        def kinetic(p):
            return 0.5 * (p.to(lp_joint.dtype) ** 2).sum(-1)

        bound = (lp_joint - kinetic(rho) - encode_dist.log_prob(z0)
                 + kinetic(rho0))
        loss = -bound.mean()
        recon = -self.decoder(z, train=train).log_prob(inputs).mean()
        return loss, {"loss": loss, "recon_nll": recon, "hvae_bound": -loss}

    def sample(self, generator: torch.Generator,
               batch_shape: Tuple[int, ...] = (), train: bool = False,
               device=None) -> Tensor:
        """Sample the prior, then the decoder (the prior layer's input is
        a ones probe used only for its shape)."""
        device = device or next(self.parameters()).device
        probe = torch.ones(tuple(batch_shape) + (1,), device=device)
        z = self._prior_dist(probe, train).sample(generator,
                                                  tuple(batch_shape))
        return self.decoder(z, train=train).sample(generator)


@dataclass
class DualVAEOutput:
    """The dual pass's output: both decoder distributions, the three
    draws (encoder, prior, reverse decoder) and both regularizers, with
    and without their weights."""

    decode_dist_forward: Any
    decode_dist_reverse: Any
    encode_sample: Tensor
    prior_sample: Tensor
    decode_sample: Tensor
    regularizer_loss_forward: Tensor
    regularizer_loss_reverse: Tensor
    kl_div_forward: Tensor
    kl_div_reverse: Tensor


class VAEDualELBO(nn.Module):
    """VAE trained by a forward and a reverse ELBO pass: forward x -> z
    -> x with ``regularizer_forward`` (KL by default), reverse z -> x ->
    z from the prior with ``regularizer_reverse`` (reverse KL by
    default).  Pair the reverse decoder with
    ``losses.PotentialEnergyLogProbLoss`` (``dual_elbo_loss``)."""

    def __init__(self, encoder: Any, decoder: Any, prior: Any,
                 regularizer_forward: Any = None,
                 regularizer_reverse: Any = None):
        super().__init__()
        self.encoder = encoder
        self.decoder = decoder
        self.prior = prior
        self.regularizer_forward = (loss_lib.KLDivergenceEstimate()
                                    if regularizer_forward is None
                                    else regularizer_forward)
        self.regularizer_reverse = (loss_lib.ReverseKLDivergenceEstimate()
                                    if regularizer_reverse is None
                                    else regularizer_reverse)

    def _prior_dist(self, shape_sample: Tensor, train: bool):
        return _resolve_prior_dist(self.prior, shape_sample, train)

    def forward(self, inputs: Tensor, generator: torch.Generator,
                train: bool = False) -> DualVAEOutput:
        def draw(role, dist):
            # A static prior has no batch axis: one latent per input row.
            if (role == "prior" and tuple(dist.batch_shape) == ()
                    and inputs.dim() > 1):
                return dist.sample(generator, (inputs.shape[0],))
            return dist.sample(generator)

        return self._dual_pass(inputs, train, draw)

    def _dual_pass(self, inputs: Tensor, train: bool,
                   draw: Callable[[str, Any], Tensor]) -> DualVAEOutput:
        """Both passes, with ``draw(role, dist)`` giving the sample of
        each stochastic node ("encode", "prior", "decode") in order."""
        encode_dist_f = self.encoder(inputs, train=train)
        z = draw("encode", encode_dist_f)
        prior_dist = self._prior_dist(z, train)
        decode_dist_f = self.decoder(z, train=train)
        reg_f = self.regularizer_forward(encode_dist_f, prior_dist,
                                         samples=z)
        z_r = draw("prior", prior_dist)
        decode_dist_r = self.decoder(z_r, train=train)
        x_r = draw("decode", decode_dist_r)
        encode_dist_r = self.encoder(x_r, train=train)
        reg_r = self.regularizer_reverse(encode_dist_r, prior_dist,
                                         samples=z_r)
        return DualVAEOutput(
            decode_dist_f, decode_dist_r, z, z_r, x_r, reg_f, reg_r,
            _unweighted(self.regularizer_forward, reg_f),
            _unweighted(self.regularizer_reverse, reg_r))

    def dual_elbo_loss(self, inputs: Tensor, generator: torch.Generator,
                       potential_fn: Callable[[Tensor], Tensor],
                       train: bool = True
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
        """Forward reconstruction NLL + the reverse pass's potential
        energy loss + both regularizers, with the metrics."""
        return self._dual_loss(inputs, self(inputs, generator, train=train),
                               potential_fn)

    @staticmethod
    def _dual_loss(inputs: Tensor, out: DualVAEOutput, potential_fn
                   ) -> Tuple[Tensor, Dict[str, Tensor]]:
        recon_f = -out.decode_dist_forward.log_prob(inputs).mean()
        rev = loss_lib.PotentialEnergyLogProbLoss(potential_fn)(
            out.decode_dist_reverse, samples=out.decode_sample)
        total = (recon_f + rev + out.regularizer_loss_forward
                 + out.regularizer_loss_reverse)
        return total, {"loss": total, "recon_nll_forward": recon_f,
                       "reverse_energy_loss": rev,
                       "kl_div_forward": out.kl_div_forward,
                       "kl_div_reverse": out.kl_div_reverse}

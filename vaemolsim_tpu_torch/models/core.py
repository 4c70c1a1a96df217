"""Model compositions: mapping to distribution, flow model and VAE (port
of ``vaemolsim_tpu/models/core.py``).

Ported so far: MappingToDistribution, FlowModel, and the VAE with its
forward pass, ``elbo_loss``, ``iwae_loss`` and ``sample``.
``hvae_elbo_loss`` differentiates through per-step gradients, which the
kernels' plain-recompute backward does not support yet; it waits, with
VAEDualELBO (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vaemolsim_tpu_torch import losses as loss_lib
from vaemolsim_tpu_torch.dists.layers import StaticFlowedDistribution
from vaemolsim_tpu_torch.nn.mappings import FCDeepNN
from vaemolsim_tpu_torch.ops import distributions as dl

Tensor = torch.Tensor

__all__ = ["MappingToDistribution", "FlowModel", "VAE", "VAEOutput"]


def _call_dist_layer(layer, raw, conditional_input, train):
    """Call a dist layer, passing the conditional input only when the
    layer is conditional."""
    if getattr(layer, "conditional", False):
        return layer(raw, conditional_input=conditional_input, train=train)
    return layer(raw, train=train)


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
        weight = getattr(self.regularizer, "weight", 1.0)
        kl_div = (reg_loss / weight if weight != 0
                  else torch.zeros_like(reg_loss))
        return VAEOutput(encode_dist, z, prior_dist,
                         self.decoder(z, train=train), reg_loss, kl_div)

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

"""Model compositions: mapping to distribution, and the VAE (port of
``vaemolsim_tpu/models/core.py``).

Ported so far: MappingToDistribution and the VAE's forward pass,
``_prior_dist`` and ``sample``.  The training losses (``elbo_loss``,
``iwae_loss``, ``hvae_elbo_loss``) come with the training slice; until
then the VAE carries its regularizer as a ``config.RegularizerConfig``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from vaemolsim_tpu_torch.nn.mappings import FCDeepNN
from vaemolsim_tpu_torch.ops import distributions as dl

Tensor = torch.Tensor

__all__ = ["MappingToDistribution", "VAE", "VAEOutput"]


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
    shape only), regularize, decode.  ``regularizer`` is a
    ``config.RegularizerConfig`` (kinds none, kl, log_prob, reverse_kl)."""

    def __init__(self, encoder: Any, decoder: Any, prior: Any,
                 regularizer: Any = None):
        super().__init__()
        from vaemolsim_tpu_torch.config import RegularizerConfig
        self.encoder = encoder
        self.decoder = decoder
        self.prior = prior
        self.regularizer = regularizer or RegularizerConfig()

    def _prior_dist(self, shape_sample: Tensor, train: bool):
        return _resolve_prior_dist(self.prior, shape_sample, train)

    def _regularize(self, enc, prior, z) -> Tensor:
        """weight * the regularizer, estimated at the encoder's samples
        (the JAX VAE passes its sample, so ``sample_dist`` never draws)."""
        reg = self.regularizer
        if reg.kind == "none":
            return torch.zeros((), device=z.device)
        if reg.kind == "kl":
            val = enc.log_prob(z) - prior.log_prob(z)
        elif reg.kind == "reverse_kl":
            val = prior.log_prob(z) - enc.log_prob(z)
        elif reg.kind == "log_prob":
            val = -prior.log_prob(z)
        else:
            raise ValueError(f"Unknown regularizer kind {reg.kind!r}")
        return reg.weight * val.mean()

    def forward(self, inputs: Tensor, generator: torch.Generator,
                train: bool = False) -> VAEOutput:
        encode_dist = self.encoder(inputs, train=train)
        z = encode_dist.sample(generator)
        prior_dist = self._prior_dist(z, train)
        reg = self._regularize(encode_dist, prior_dist, z)
        w = self.regularizer.weight
        kl_div = reg / w if w != 0 else torch.zeros_like(reg)
        return VAEOutput(encode_dist, z, prior_dist,
                         self.decoder(z, train=train), reg, kl_div)

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

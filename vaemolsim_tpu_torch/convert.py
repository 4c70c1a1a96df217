"""Carry a JAX-package model into the port: :func:`from_jax`.

Reads the JAX objects' fields by name and their arrays through
``np.asarray``, so it needs no import of jax.  Covers everything the
flagship VAE holds: FCDeepNN, Dense, MADE, MaskedSplineConditioner,
MAFLayer, RQSSplineMAF (and SplineConditioner), Normal, Independent, IndependentBlockwise,
StaticFlowedDistribution, FlowedDistribution, MappingToDistribution,
the VAE and its regularizer.  Weights are copied exactly (the Dense
layout is the same ``(in, out)`` in both packages).
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

__all__ = ["from_jax"]


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def _dense(o, device):
    from vaemolsim_tpu_torch.nn.core import Dense
    return Dense(_t(o.kernel, device), _t(o.bias, device), o.activation)


def _fcdeepnn(o, device):
    from vaemolsim_tpu_torch.nn.mappings import FCDeepNN
    if o.batch_norm:
        raise NotImplementedError("FCDeepNN with batch norm is not ported")
    return FCDeepNN([_dense(l, device) for l in o.layers],
                    _dense(o.head, device), o.event_ndims,
                    tuple(o.target_shape), tuple(o.periodic_mask))


def _made(o, device):
    from vaemolsim_tpu_torch.nn.core import MADE
    return MADE([_t(k, device) for k in o.kernels],
                [_t(b, device) for b in o.biases],
                None if o.cond_kernels is None
                else [_t(c, device) for c in o.cond_kernels],
                o.params_per_dim, o.event_size, o.activation,
                tuple(o.input_order_static))


def _masked_conditioner(o, device):
    from vaemolsim_tpu_torch.flows import MaskedSplineConditioner
    return MaskedSplineConditioner(
        _made(o.w_net, device), _made(o.h_net, device),
        _made(o.s_net, device), o.bin_min, o.bin_max, o.num_bins,
        o.circular)


def _spline_conditioner(o, device):
    from vaemolsim_tpu_torch.flows import SplineConditioner
    return SplineConditioner(*(_dense(d, device) for d in (
        o.trunk, o.w_head, o.h_head, o.s_head)), o.data_dim, o.bin_min,
        o.bin_max, o.num_bins, o.circular)


def _maf_layer(o, device):
    from vaemolsim_tpu_torch.flows import MAFLayer
    return MAFLayer(_masked_conditioner(o.conditioner, device))


def _rqs_maf(o, device):
    from vaemolsim_tpu_torch.flows import RQSSplineMAF
    if o.bn_params or o.before_flow_transform is not None \
            or o.after_flow_transform is not None:
        raise NotImplementedError("RQSSplineMAF with batch norm or "
                                  "before/after transforms is not ported")
    return RQSSplineMAF([_maf_layer(b, device) for b in o.blocks],
                        data_dim=o.data_dim, conditional=o.conditional,
                        order_seed=o.order_seed)


def _normal(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Normal(_t(o.loc, device), _t(o.scale, device))


def _independent(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Independent(from_jax(o.base, device),
                         o.reinterpreted_batch_ndims)


def _blockwise_layer(o, device):
    from vaemolsim_tpu_torch.dists import IndependentBlockwise
    return IndependentBlockwise(tuple(o.families))


def _static_flowed(o, device):
    from vaemolsim_tpu_torch.dists import StaticFlowedDistribution
    return StaticFlowedDistribution(from_jax(o.flow, device),
                                    from_jax(o.base, device))


def _flowed(o, device):
    from vaemolsim_tpu_torch.dists import FlowedDistribution
    return FlowedDistribution(from_jax(o.flow, device),
                              from_jax(o.base_layer, device))


def _mapping_to_dist(o, device):
    from vaemolsim_tpu_torch.models import MappingToDistribution
    return MappingToDistribution(from_jax(o.mapping, device),
                                 from_jax(o.dist, device), o.name)


def _regularizer(kind):
    def conv(o, device):
        from vaemolsim_tpu_torch.config import RegularizerConfig
        return RegularizerConfig(kind=kind, weight=float(o.weight),
                                 sample_dist=o.sample_dist)
    return conv


def _vae(o, device):
    from vaemolsim_tpu_torch.models import VAE
    return VAE(from_jax(o.encoder, device), from_jax(o.decoder, device),
               from_jax(o.prior, device), from_jax(o.regularizer, device))


_CONVERTERS: Dict[str, Callable[[Any, Any], Any]] = {
    "Dense": _dense,
    "FCDeepNN": _fcdeepnn,
    "MADE": _made,
    "MaskedSplineConditioner": _masked_conditioner,
    "SplineConditioner": _spline_conditioner,
    "MAFLayer": _maf_layer,
    "RQSSplineMAF": _rqs_maf,
    "Normal": _normal,
    "Independent": _independent,
    "IndependentBlockwise": _blockwise_layer,
    "StaticFlowedDistribution": _static_flowed,
    "FlowedDistribution": _flowed,
    "MappingToDistribution": _mapping_to_dist,
    "VAE": _vae,
    "NonRegularizer": _regularizer("none"),
    "KLDivergenceEstimate": _regularizer("kl"),
    "LogProbRegularizer": _regularizer("log_prob"),
    "ReverseKLDivergenceEstimate": _regularizer("reverse_kl"),
}


def from_jax(obj: Any, device="cpu") -> Any:
    """The port's counterpart of a JAX-package object, with its weights,
    on ``device``."""
    name = type(obj).__name__
    try:
        conv = _CONVERTERS[name]
    except KeyError:
        raise TypeError(f"from_jax: no port of {name} yet; supported: "
                        f"{sorted(_CONVERTERS)}") from None
    return conv(obj, torch.device(device))

"""Carry a JAX-package model into the port: :func:`from_jax`.

Reads the JAX objects' fields by name and their arrays through
``np.asarray``, so it needs no import of jax.  Covers everything the
flagship VAE, a flow model and the backmapping model hold: FCDeepNN
(with its batch norms), Dense, LayerNorm, BatchNorm, MADE,
MaskedSplineConditioner, MAFLayer, RQSSplineMAF, SplineConditioner,
CouplingLayer, RQSSplineRealNVP (each flow with its batch-norm
bijectors and before/after transforms), the bijectors (Identity, Shift,
Scale, Sigmoid, Tanh, Softplus, SoftClip, Block, Inverse, Chain,
BatchNormBijector), Normal, Uniform, Deterministic, VonMises, Beta,
Gamma, Independent, Categorical, MixtureSameFamily,
IndependentBlockwise (any ported family), AutoregressiveBlockwise,
IndependentVonMises, IndependentDeterministic,
StaticFlowedDistribution, FlowedDistribution, MappingToDistribution,
FlowModel, the VAE and VAEDualELBO, the seven loss classes, the CG maps,
DistanceSelection, the attention nets, VectorAttention, AttentionBlock,
ParticleEmbedding, LocalParticleDescriptors and BackmappingOnly,
VectorAttentionTwoStage, SchNetInteraction, SchNetEmbedding,
SchNetPotential, JointBackmapping, VelocityField, FlowMatching and
FlowMatchingLayer; and
the molecular MD state: a ``CellNeighborList`` (either JAX build,
evaluated by the port's cell-list energy) and an ``MDState``.  Batch-norm
running moments become buffers.  Weights and arrays are copied
exactly, with their dtypes (the Dense layout is the same ``(in, out)``
in both packages).  Objects land on the CUDA card unless a device is
given.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from vaemolsim_tpu_torch.config import default_device

__all__ = ["from_jax"]


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def _dense(o, device):
    from vaemolsim_tpu_torch.nn.core import Dense
    return Dense(_t(o.kernel, device), _t(o.bias, device), o.activation)


def _layer_norm(o, device):
    from vaemolsim_tpu_torch.nn.core import LayerNorm
    return LayerNorm(_t(o.scale, device), _t(o.offset, device), o.eps)


def _batch_norm(o, device):
    from vaemolsim_tpu_torch.nn.core import BatchNorm
    return BatchNorm(_t(o.mean, device), _t(o.var, device),
                     _t(o.scale, device), _t(o.offset, device), o.momentum,
                     o.eps)


def _fcdeepnn(o, device):
    from vaemolsim_tpu_torch.nn.mappings import FCDeepNN
    return FCDeepNN([_dense(l, device) for l in o.layers],
                    _dense(o.head, device), o.event_ndims,
                    tuple(o.target_shape), tuple(o.periodic_mask),
                    [_batch_norm(b, device) for b in o.bns]
                    if o.batch_norm else ())


def _velocity_field(o, device):
    from vaemolsim_tpu_torch.flows.flow_matching import VelocityField
    return VelocityField(_fcdeepnn(o.net, device), o.event_dim, o.n_freqs,
                         o.cond_dim)


def _flow_matching(o, device):
    from vaemolsim_tpu_torch.flows.flow_matching import FlowMatching
    return FlowMatching(_velocity_field(o.velocity, device), o.sigma_min)


def _flow_matching_layer(o, device):
    from vaemolsim_tpu_torch.flows.flow_matching import FlowMatchingLayer
    return FlowMatchingLayer(_flow_matching(o.model, device), o.cond_dim,
                             o.n_steps)


def _cg_map(o, device):
    from vaemolsim_tpu_torch.nn import mappings
    return getattr(mappings, type(o).__name__)(_t(o.agg, device))


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


def _optional(o, device):
    return None if o is None else from_jax(o, device)


def _rqs_maf(o, device):
    from vaemolsim_tpu_torch.flows import RQSSplineMAF
    return RQSSplineMAF([_maf_layer(b, device) for b in o.blocks],
                        _optional(o.before_flow_transform, device),
                        _optional(o.after_flow_transform, device),
                        data_dim=o.data_dim, conditional=o.conditional,
                        order_seed=o.order_seed,
                        bn_params=[_bn_bijector(b, device)
                                   for b in o.bn_params])


def _coupling_layer(o, device):
    from vaemolsim_tpu_torch.flows import CouplingLayer
    return CouplingLayer(_spline_conditioner(o.conditioner, device),
                         int(o.num_masked))


def _rqs_realnvp(o, device):
    from vaemolsim_tpu_torch.flows import RQSSplineRealNVP
    return RQSSplineRealNVP([_coupling_layer(b, device) for b in o.blocks],
                            _optional(o.before_flow_transform, device),
                            _optional(o.after_flow_transform, device),
                            data_dim=o.data_dim,
                            bn_params=[_bn_bijector(b, device)
                                       for b in o.bn_params])


def _bn_bijector(o, device):
    from vaemolsim_tpu_torch.ops.bijectors import BatchNormBijector
    return BatchNormBijector(_t(o.mean, device), _t(o.var, device),
                             _t(o.log_gamma, device), _t(o.beta, device),
                             o.eps, o.use_batch_stats, o.momentum)


def _stateless_bijector(o, device):
    from vaemolsim_tpu_torch.ops import bijectors as bj
    return getattr(bj, type(o).__name__)()


def _shift(o, device):
    from vaemolsim_tpu_torch.ops.bijectors import Shift
    return Shift(_t(o.shift, device))


def _scale(o, device):
    from vaemolsim_tpu_torch.ops.bijectors import Scale
    return Scale(_t(o.scale, device))


def _soft_clip(o, device):
    from vaemolsim_tpu_torch.ops.bijectors import SoftClip
    return SoftClip(o.low, o.high, o.hinge_softness)


def _block(o, device):
    from vaemolsim_tpu_torch.ops.bijectors import Block
    return Block(from_jax(o.inner, device), o.ndims)


def _inverse(o, device):
    from vaemolsim_tpu_torch.ops.bijectors import Inverse
    return Inverse(from_jax(o.inner, device))


def _chain(o, device):
    from vaemolsim_tpu_torch.ops.bijectors import Chain
    return Chain([from_jax(b, device) for b in o.bijectors])


def _categorical(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Categorical(_t(o.logits, device))


def _mixture(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.MixtureSameFamily(_t(o.mixing_logits, device),
                               from_jax(o.components, device))


def _normal(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Normal(_t(o.loc, device), _t(o.scale, device))


def _von_mises(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.VonMises(_t(o.loc, device), _t(o.concentration, device))


def _uniform(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Uniform(_t(o.low, device), _t(o.high, device))


def _deterministic(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Deterministic(_t(o.loc, device), o.atol)


def _beta(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Beta(_t(o.concentration1, device), _t(o.concentration0, device))


def _gamma(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Gamma(_t(o.concentration, device), _t(o.rate, device))


def _independent(o, device):
    from vaemolsim_tpu_torch.ops import distributions as d
    return d.Independent(from_jax(o.base, device),
                         o.reinterpreted_batch_ndims)


def _blockwise_layer(o, device):
    from vaemolsim_tpu_torch.dists import IndependentBlockwise
    return IndependentBlockwise(tuple(o.families))


def _autoregressive_blockwise(o, device):
    from vaemolsim_tpu_torch.dists import AutoregressiveBlockwise
    return AutoregressiveBlockwise(_made(o.made, device),
                                   _blockwise_layer(o.blockwise, device))


def _event_dim_layer(o, device):
    from vaemolsim_tpu_torch import dists
    return getattr(dists, type(o).__name__)(o.event_dim)


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


def _flow_model(o, device):
    from vaemolsim_tpu_torch.models import FlowModel
    return FlowModel(from_jax(o.flowed_dist, device),
                     None if o.mapping is None
                     else from_jax(o.mapping, device))


def _regularizer(o, device):
    from vaemolsim_tpu_torch import losses
    return getattr(losses, type(o).__name__)(weight=float(o.weight),
                                             sample_dist=o.sample_dist)


def _log_prob_loss(o, device):
    from vaemolsim_tpu_torch.losses import LogProbLoss
    return LogProbLoss()


def _potential_loss(o, device):
    """The potential function is carried as it is: it must accept torch
    tensors (as a plain arithmetic expression does)."""
    from vaemolsim_tpu_torch.losses import PotentialEnergyLogProbLoss
    return PotentialEnergyLogProbLoss(o.potential_fn)


def _vae(o, device):
    from vaemolsim_tpu_torch.models import VAE
    return VAE(from_jax(o.encoder, device), from_jax(o.decoder, device),
               from_jax(o.prior, device), from_jax(o.regularizer, device))


def _vae_dual(o, device):
    from vaemolsim_tpu_torch.models import VAEDualELBO
    return VAEDualELBO(from_jax(o.encoder, device),
                       from_jax(o.decoder, device), from_jax(o.prior, device),
                       from_jax(o.regularizer_forward, device),
                       from_jax(o.regularizer_reverse, device))


def _distance_selection(o, device):
    from vaemolsim_tpu_torch.nn.mappings import DistanceSelection
    return DistanceSelection.create(
        o.cutoff, o.max_included,
        None if o.box_lengths is None else np.array(o.box_lengths),
        device=device)


def _score_net(o, device):
    from vaemolsim_tpu_torch.nn.attention import _ScoreNet
    return _ScoreNet(_dense(o.d1, device), _dense(o.d2, device))


def _value_net(o, device):
    from vaemolsim_tpu_torch.nn.attention import _ValueNet
    return _ValueNet(_dense(o.d1, device), _layer_norm(o.ln, device),
                     _dense(o.d2, device), o.activation)


def _vector_attention(o, device):
    from vaemolsim_tpu_torch.nn.attention import VectorAttention
    return VectorAttention(_score_net(o.score_net, device),
                           _value_net(o.value_net, device), o.reduce)


def _attention_block(o, device):
    from vaemolsim_tpu_torch.nn.attention import AttentionBlock
    return AttentionBlock(from_jax(o.attn, device), _dense(o.post_d1, device),
                          _layer_norm(o.post_ln, device),
                          _dense(o.post_d2, device), o.activation)


def _particle_embedding(o, device):
    from vaemolsim_tpu_torch.nn.attention import ParticleEmbedding
    return ParticleEmbedding(_dense(o.info_net, device),
                             [_attention_block(b, device) for b in o.blocks],
                             from_jax(o.final_attn, device), o.mask_zero)


def _local_descriptors(o, device):
    from vaemolsim_tpu_torch.nn.attention import LocalParticleDescriptors
    return LocalParticleDescriptors(_distance_selection(o.select, device),
                                    from_jax(o.embed, device))


def _cell_neighbor_list(o, device):
    from vaemolsim_tpu_torch.potentials import CellNeighborList
    return CellNeighborList(*(torch.as_tensor(np.array(a), device=device)
                              for a in o))


def _md_state(o, device):
    from vaemolsim_tpu_torch.md import MDState
    return MDState(*(_t(a, device) for a in o))


def _backmapping(o, device):
    from vaemolsim_tpu_torch.models import BackmappingOnly
    return BackmappingOnly(_local_descriptors(o.mask_and_embed, device),
                           from_jax(o.decoder, device))


def _two_stage(o, device):
    from vaemolsim_tpu_torch.nn.attention import VectorAttentionTwoStage
    return VectorAttentionTwoStage(_value_net(o.value_net, device),
                                   _dense(o.merge, device),
                                   _dense(o.join, device),
                                   _score_net(o.score_net, device), o.reduce)


def _schnet_interaction(o, device):
    from vaemolsim_tpu_torch.nn.schnet import SchNetInteraction
    return SchNetInteraction(*(_dense(getattr(o, f), device) for f in
                               ("atom_in", "filter1", "filter2", "out1",
                                "out2")))


def _schnet_embedding(o, device):
    from vaemolsim_tpu_torch.nn.schnet import SchNetEmbedding
    return SchNetEmbedding(
        _dense(o.info_net, device), _dense(o.center_net, device),
        [_schnet_interaction(b, device) for b in o.blocks],
        _dense(o.out1, device), _dense(o.out2, device), o.n_rbf, o.cutoff,
        o.mask_zero, o.pool)


def _schnet_potential(o, device):
    from vaemolsim_tpu_torch.nn.schnet import SchNetPotential
    return SchNetPotential(
        _dense(o.species_net, device),
        [_schnet_interaction(b, device) for b in o.blocks],
        _dense(o.out1, device), _dense(o.out2, device),
        _t(o.e_scale, device), _t(o.e_ref, device), o.n_rbf, o.cutoff)


def _joint_backmapping(o, device):
    from vaemolsim_tpu_torch.dists.joint import JointBackmapping
    return JointBackmapping(_local_descriptors(o.cg_embed, device),
                            _dense(o.residue_encoder, device),
                            from_jax(o.mapping, device),
                            from_jax(o.decoder_dist, device),
                            o.dofs_per_residue)


_CONVERTERS: Dict[str, Callable[[Any, Any], Any]] = {
    "Dense": _dense,
    "LayerNorm": _layer_norm,
    "BatchNorm": _batch_norm,
    "FCDeepNN": _fcdeepnn,
    "CGCentroid": _cg_map,
    "CGCenterOfMass": _cg_map,
    "MADE": _made,
    "MaskedSplineConditioner": _masked_conditioner,
    "SplineConditioner": _spline_conditioner,
    "MAFLayer": _maf_layer,
    "RQSSplineMAF": _rqs_maf,
    "CouplingLayer": _coupling_layer,
    "RQSSplineRealNVP": _rqs_realnvp,
    "BatchNormBijector": _bn_bijector,
    "Identity": _stateless_bijector,
    "Sigmoid": _stateless_bijector,
    "Tanh": _stateless_bijector,
    "Softplus": _stateless_bijector,
    "Shift": _shift,
    "Scale": _scale,
    "SoftClip": _soft_clip,
    "Block": _block,
    "Inverse": _inverse,
    "Chain": _chain,
    "Categorical": _categorical,
    "MixtureSameFamily": _mixture,
    "Normal": _normal,
    "VonMises": _von_mises,
    "Uniform": _uniform,
    "Deterministic": _deterministic,
    "Beta": _beta,
    "Gamma": _gamma,
    "Independent": _independent,
    "IndependentBlockwise": _blockwise_layer,
    "AutoregressiveBlockwise": _autoregressive_blockwise,
    "IndependentVonMises": _event_dim_layer,
    "IndependentDeterministic": _event_dim_layer,
    "StaticFlowedDistribution": _static_flowed,
    "FlowedDistribution": _flowed,
    "MappingToDistribution": _mapping_to_dist,
    "FlowModel": _flow_model,
    "VelocityField": _velocity_field,
    "FlowMatching": _flow_matching,
    "FlowMatchingLayer": _flow_matching_layer,
    "VAE": _vae,
    "VAEDualELBO": _vae_dual,
    "DistanceSelection": _distance_selection,
    "_ScoreNet": _score_net,
    "_ValueNet": _value_net,
    "VectorAttention": _vector_attention,
    "AttentionBlock": _attention_block,
    "ParticleEmbedding": _particle_embedding,
    "LocalParticleDescriptors": _local_descriptors,
    "BackmappingOnly": _backmapping,
    "VectorAttentionTwoStage": _two_stage,
    "SchNetInteraction": _schnet_interaction,
    "SchNetEmbedding": _schnet_embedding,
    "SchNetPotential": _schnet_potential,
    "JointBackmapping": _joint_backmapping,
    "CellNeighborList": _cell_neighbor_list,
    "MDState": _md_state,
    "LogProbLoss": _log_prob_loss,
    "PotentialEnergyLogProbLoss": _potential_loss,
    "NonRegularizer": _regularizer,
    "KLDivergenceEstimate": _regularizer,
    "LogProbRegularizer": _regularizer,
    "ReverseKLDivergenceEstimate": _regularizer,
}


def from_jax(obj: Any, device=None) -> Any:
    """The port's counterpart of a JAX-package object, with its weights,
    on ``device``: by default the CUDA card (raises where there is none;
    pass ``"cpu"`` for the CPU)."""
    name = type(obj).__name__
    try:
        conv = _CONVERTERS[name]
    except KeyError:
        raise TypeError(f"from_jax: no port of {name} yet; supported: "
                        f"{sorted(_CONVERTERS)}") from None
    return conv(obj, default_device(device))

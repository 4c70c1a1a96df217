"""Typed configuration dataclasses (port of ``vaemolsim_tpu/config.py``).

The dataclasses mirror the JAX package's field for field, read and
write the same tagged JSON (``save_json`` / ``load_json``), and
``build()`` the port's objects on a given device, drawing every weight
from one ``torch.Generator`` seeded by the experiment's ``seed``.
``ExperimentConfig.build()`` builds on the CUDA card unless it is given
a device; without a card it raises rather than quietly build on the CPU
(pass ``"cpu"`` for that).  A JSON
written by ``vaemolsim_tpu.config.save_json`` builds the same
architecture here (not the same weights: the random streams differ; use
``convert.from_jax`` to carry weights across).

Every config class of the JAX package: the flagship experiment, flow
models (MAF and RealNVP, with or without batch norm), every dist-layer
kind, the dual-ELBO VAE, the backmapping model (``BackmappingConfig``,
with ``DistanceSelectionConfig`` and ``ParticleEmbeddingConfig``), the
FCDeepNN ``MappingConfig`` and the optimizer.
"""

from __future__ import annotations

import dataclasses
import json
import math
import typing
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

__all__ = ["RQSParams", "RealNVPConfig", "MAFConfig", "MappingConfig",
           "DistLayerConfig",
           "FlowedDistConfig", "RegularizerConfig", "MappingToDistConfig",
           "FlowModelConfig",
           "VAEConfig", "DistanceSelectionConfig", "ParticleEmbeddingConfig",
           "BackmappingConfig", "MCMCConfig", "OptimizerConfig",
           "ExperimentConfig", "default_device", "from_dict", "to_dict",
           "to_tagged_dict", "save_json", "load_json",
           "flagship_experiment_config", "backmapping_experiment_config"]

_TAG = "__config__"


def default_device(device=None) -> torch.device:
    """``device`` itself when given; otherwise the CUDA card, and an error
    where there is none (never a quiet fall back to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port builds on the card unless told "
            "otherwise; pass device='cpu' to build on the CPU")
    return torch.device("cuda")


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def to_tagged_dict(cfg) -> Any:
    """Recursive dict with a ``__config__`` class tag at every dataclass
    level; tuples become lists (JSON-safe)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        out: Dict[str, Any] = {_TAG: type(cfg).__name__}
        for f in dataclasses.fields(cfg):
            out[f.name] = to_tagged_dict(getattr(cfg, f.name))
        return out
    if isinstance(cfg, (list, tuple)):
        return [to_tagged_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_tagged_dict(v) for k, v in cfg.items()}
    return cfg


def _tuple_in_annotation(ann) -> bool:
    """Whether a JSON list is a tuple under this annotation (directly, or
    as the tuple member of an Optional/Union that admits no list)."""
    if typing.get_origin(ann) is tuple:
        return True
    if typing.get_origin(ann) is not typing.Union:
        return False
    args = typing.get_args(ann)
    return (any(typing.get_origin(a) is tuple for a in args)
            and not any(a is list or typing.get_origin(a) is list
                        for a in args))


def _dataclass_in_annotation(ann, keys):
    """The config class an annotation names, through Optional/Union; for
    an untagged dict under a Union, the one member whose fields cover
    its keys."""
    if dataclasses.is_dataclass(ann):
        return ann
    cands = [a for a in typing.get_args(ann) if dataclasses.is_dataclass(a)]
    if len(cands) > 1:
        cands = [c for c in cands
                 if set(keys) <= {f.name for f in dataclasses.fields(c)}]
    if len(cands) > 1:
        raise ValueError(f"untagged dict with keys {sorted(keys)} is "
                         f"ambiguous between {[c.__name__ for c in cands]}")
    return cands[0] if cands else None


def from_dict(cls, d: Dict[str, Any]):
    """Rebuild a config from a dict; a ``__config__`` tag takes precedence
    over ``cls`` (which may then be None)."""
    if _TAG in d:
        name = d[_TAG]
        if name not in _CONFIG_REGISTRY:
            raise ValueError(f"config class {name!r} is not ported to "
                             "vaemolsim_tpu_torch yet")
        cls = _CONFIG_REGISTRY[name]
    if cls is None:
        raise ValueError(f"from_dict needs a target class or a "
                         f"'{_TAG}'-tagged dict")
    hints = typing.get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names - {_TAG}
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if isinstance(v, dict):
            nested = (None if _TAG in v
                      else _dataclass_in_annotation(hints.get(f.name), v))
            if _TAG in v or nested is not None:
                v = from_dict(nested, v)
        if isinstance(v, list) and _tuple_in_annotation(hints.get(f.name)):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def save_json(cfg, path: str) -> None:
    with open(path, "w") as fh:
        json.dump(to_tagged_dict(cfg), fh, indent=2)


def load_json(path: str):
    """Load a tagged-JSON config written by either package's save_json."""
    with open(path) as fh:
        return from_dict(None, json.load(fh))


def _shape(s):
    return tuple(s) if isinstance(s, list) else s


@dataclass
class RQSParams:
    """Spline conditioner knobs."""

    bin_range: Tuple[float, float] = (-10.0, 10.0)
    num_bins: int = 32
    hidden_dim: int = 200
    kernel_initializer: str = "truncated_normal"
    conditional: bool = False
    conditional_event_shape: Optional[int] = None
    circular: bool = False

    def asdict(self, coupling: bool = False) -> Dict[str, Any]:
        """kwargs for MaskedSplineConditioner.create, or with
        ``coupling=True`` for SplineConditioner.create (RealNVP), which
        has no conditional machinery."""
        d = dataclasses.asdict(self)
        d["bin_range"] = list(self.bin_range)
        if coupling:
            if self.conditional:
                raise ValueError("RealNVP coupling flows are never "
                                 "conditional")
            d.pop("conditional")
            d.pop("conditional_event_shape")
        elif not self.conditional:
            d.pop("conditional_event_shape")
        return d


@dataclass
class RealNVPConfig:
    data_dim: int = 1
    num_blocks: int = 4
    batch_norm: bool = False
    rqs: RQSParams = field(default_factory=RQSParams)

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch.flows import RQSSplineRealNVP
        return RQSSplineRealNVP.create(
            generator, self.data_dim, self.num_blocks,
            rqs_params=self.rqs.asdict(coupling=True),
            batch_norm=self.batch_norm, device=device)


@dataclass
class MAFConfig:
    data_dim: int = 1
    num_blocks: int = 2
    order_seed: Optional[int] = None
    batch_norm: bool = False
    rqs: RQSParams = field(default_factory=RQSParams)

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch.flows import RQSSplineMAF
        return RQSSplineMAF.create(generator, self.data_dim, self.num_blocks,
                                   order_seed=self.order_seed,
                                   rqs_params=self.rqs.asdict(),
                                   batch_norm=self.batch_norm, device=device)


@dataclass
class MappingConfig:
    """FCDeepNN knobs."""

    input_shape: Union[int, Tuple[int, ...]] = 1
    target_shape: Union[int, Tuple[int, ...]] = 1
    hidden_dim: Union[int, List[int]] = 200
    periodic_dofs: Union[bool, List[bool]] = False
    batch_norm: bool = False
    activation: str = "relu"

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch.nn import FCDeepNN
        return FCDeepNN.create(generator, _shape(self.input_shape),
                               _shape(self.target_shape),
                               hidden_dim=self.hidden_dim,
                               periodic_dofs=self.periodic_dofs,
                               batch_norm=self.batch_norm,
                               activation=self.activation, device=device)


@dataclass
class DistanceSelectionConfig:
    """The nearest ``max_included`` particles within ``cutoff``."""

    cutoff: float = 3.0
    max_included: int = 50
    box_lengths: Optional[List[float]] = None

    def build(self, device=None):
        from vaemolsim_tpu_torch.nn import DistanceSelection
        return DistanceSelection.create(self.cutoff, self.max_included,
                                        self.box_lengths, device=device)


@dataclass
class ParticleEmbeddingConfig:
    """The CG-environment embedding: ``kind="attention"`` (the
    geometric-algebra attention, ``attention="fused"`` or
    ``"two_stage"``) or ``kind="schnet"`` (continuous-filter
    convolutions; ``hidden_dim`` is then the per-atom feature width and
    ``rbf_cutoff`` should match the selection's cutoff)."""

    info_dim: int = 1
    embedding_dim: int = 20
    hidden_dim: int = 40
    num_blocks: int = 2
    mask_zero: bool = True
    attention: str = "fused"
    kind: str = "attention"
    n_rbf: int = 16
    rbf_cutoff: float = 3.0
    pool: str = "mean"

    def build(self, generator: torch.Generator, device=None):
        if self.kind == "schnet":
            from vaemolsim_tpu_torch.nn import SchNetEmbedding
            return SchNetEmbedding.create(
                generator, self.info_dim, self.embedding_dim,
                features=self.hidden_dim, num_blocks=self.num_blocks,
                n_rbf=self.n_rbf, cutoff=self.rbf_cutoff,
                mask_zero=self.mask_zero, pool=self.pool, device=device)
        if self.kind != "attention":
            raise ValueError(
                f"kind must be 'attention' or 'schnet', got {self.kind!r}")
        from vaemolsim_tpu_torch.nn import ParticleEmbedding
        return ParticleEmbedding.create(
            generator, self.info_dim, self.embedding_dim, self.hidden_dim,
            self.num_blocks, self.mask_zero, attention=self.attention,
            device=device)


@dataclass
class MCMCConfig:
    """MC run knobs."""

    n_chains: int = 10_000
    n_steps: int = 100
    collect_every: int = 0
    random_seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0


@dataclass
class DistLayerConfig:
    """A distribution layer, ``kind`` one of "independent_blockwise",
    "autoregressive_blockwise" (the only one with a conditional input),
    "independent_von_mises" and "independent_deterministic"."""

    kind: str = "independent_blockwise"
    num_dofs: int = 1
    families: Union[str, List[str]] = "normal"
    conditional: bool = False
    conditional_event_shape: Optional[int] = None
    auto_net_params: Optional[Dict[str, Any]] = None

    def build(self, generator: Optional[torch.Generator] = None,
              device=None):
        from vaemolsim_tpu_torch import dists
        if self.conditional and self.kind != "autoregressive_blockwise":
            raise ValueError(
                f"kind={self.kind!r} has no conditional machinery; "
                "conditional=True would be silently ignored (use "
                "autoregressive_blockwise, or a conditional flow)")
        if self.kind == "independent_blockwise":
            return dists.IndependentBlockwise.create(self.num_dofs,
                                                     self.families)
        if self.kind == "autoregressive_blockwise":
            if generator is None:
                raise ValueError("autoregressive_blockwise needs a "
                                 "generator")
            return dists.AutoregressiveBlockwise.create(
                generator, self.num_dofs, self.families,
                conditional=self.conditional,
                conditional_event_shape=self.conditional_event_shape,
                auto_net_params=self.auto_net_params, device=device)
        if self.kind == "independent_von_mises":
            return dists.IndependentVonMises.create(self.num_dofs)
        if self.kind == "independent_deterministic":
            return dists.IndependentDeterministic.create(self.num_dofs)
        raise ValueError(f"Unknown dist layer kind {self.kind!r}")


@dataclass
class FlowedDistConfig:
    """Flow over a base layer, or with ``base=None`` a
    StaticFlowedDistribution over a standard normal of dimension
    ``static_base_dim`` (the flagship prior)."""

    flow: Union[MAFConfig, RealNVPConfig] = field(default_factory=MAFConfig)
    base: Optional[DistLayerConfig] = None
    static_base_dim: Optional[int] = None

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch import dists
        from vaemolsim_tpu_torch.ops import distributions as d

        device = default_device(device)
        flow = self.flow.build(generator, device)
        if self.base is None:
            dim = self.static_base_dim or self.flow.data_dim
            return dists.StaticFlowedDistribution(
                flow, d.Independent(d.Normal(torch.zeros(dim, device=device),
                                             torch.ones(dim, device=device)),
                                    1))
        return dists.FlowedDistribution(flow,
                                        self.base.build(generator, device))


@dataclass
class RegularizerConfig:
    """VAE information regularizer: ``kind`` none | kl | log_prob |
    reverse_kl."""

    kind: str = "kl"
    weight: float = 1.0
    sample_dist: Optional[str] = None  # default per kind

    def build(self):
        from vaemolsim_tpu_torch import losses

        classes = {"none": losses.NonRegularizer,
                   "kl": losses.KLDivergenceEstimate,
                   "log_prob": losses.LogProbRegularizer,
                   "reverse_kl": losses.ReverseKLDivergenceEstimate}
        try:
            cls = classes[self.kind]
        except KeyError:
            raise ValueError(f"Unknown regularizer kind {self.kind!r}; "
                             f"one of {sorted(classes)}") from None
        kw: Dict[str, Any] = {"weight": self.weight}
        if self.sample_dist is not None:
            kw["sample_dist"] = self.sample_dist
        return cls(**kw)


@dataclass
class MappingToDistConfig:
    """Auto-sized FCDeepNN trunk + a dist layer."""

    input_shape: Union[int, List[int]] = 1
    dist: Union[DistLayerConfig, FlowedDistConfig] = field(
        default_factory=DistLayerConfig)
    mapping_kwargs: Optional[Dict[str, Any]] = None
    name: str = "map_to_dist"

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch.models import MappingToDistribution
        dist = self.dist.build(generator, device)
        return MappingToDistribution.create(
            generator, dist, input_shape=_shape(self.input_shape),
            mapping_kwargs=self.mapping_kwargs, name=self.name,
            device=device)


@dataclass
class FlowModelConfig:
    """FlowModel: optional mapping + flowed distribution."""

    flowed_dist: FlowedDistConfig = field(default_factory=FlowedDistConfig)
    input_shape: Optional[Union[int, List[int]]] = None
    mapping_kwargs: Optional[Dict[str, Any]] = None

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch.models import FlowModel
        return FlowModel.create(generator,
                                self.flowed_dist.build(generator, device),
                                input_shape=_shape(self.input_shape),
                                mapping_kwargs=self.mapping_kwargs,
                                device=device)


@dataclass
class VAEConfig:
    """Encoder and decoder configs, a prior (flowed, or standard normal
    when None) and a regularizer."""

    encoder: MappingToDistConfig = field(default_factory=MappingToDistConfig)
    decoder: MappingToDistConfig = field(default_factory=MappingToDistConfig)
    prior: Optional[FlowedDistConfig] = None
    latent_dim: int = 1
    regularizer: RegularizerConfig = field(default_factory=RegularizerConfig)
    dual_elbo: bool = False
    reverse_regularizer: Optional[RegularizerConfig] = None

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch.models import VAE, VAEDualELBO
        from vaemolsim_tpu_torch.ops import distributions as d

        device = default_device(device)
        encoder = self.encoder.build(generator, device)
        decoder = self.decoder.build(generator, device)
        if self.prior is not None:
            prior = self.prior.build(generator, device)
        else:
            prior = d.Independent(
                d.Normal(torch.zeros(self.latent_dim, device=device),
                         torch.ones(self.latent_dim, device=device)), 1)
        if self.dual_elbo:
            rev = (self.reverse_regularizer
                   or RegularizerConfig(kind="reverse_kl")).build()
            return VAEDualELBO(encoder, decoder, prior,
                               self.regularizer.build(), rev)
        return VAE(encoder, decoder, prior, self.regularizer.build())


@dataclass
class BackmappingConfig:
    """BackmappingOnly: DistanceSelection + ParticleEmbedding feeding a
    decoding MappingToDistribution (the backmapping notebook's
    defaults)."""

    selection: DistanceSelectionConfig = field(
        default_factory=lambda: DistanceSelectionConfig(max_included=10))
    embedding: ParticleEmbeddingConfig = field(
        default_factory=ParticleEmbeddingConfig)
    decoder: MappingToDistConfig = field(default_factory=MappingToDistConfig)

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch.models import BackmappingOnly
        from vaemolsim_tpu_torch.nn import LocalParticleDescriptors
        lpd = LocalParticleDescriptors(
            self.selection.build(device),
            self.embedding.build(generator, device))
        return BackmappingOnly(lpd, self.decoder.build(generator, device))


@dataclass
class OptimizerConfig:
    """Optimizer knobs.  ``build()`` returns a factory
    ``params -> torch.optim.Optimizer`` (adam, adamw or sgd with the
    optax defaults the JAX package uses)."""

    name: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0

    def build(self) -> Callable[[Any], torch.optim.Optimizer]:
        if self.weight_decay and self.name != "adamw":
            raise ValueError(
                f"weight_decay={self.weight_decay} is only applied by "
                f"name='adamw'; with {self.name!r} it would be silently "
                "dropped while the saved config claims otherwise")
        lr = self.learning_rate
        if self.name == "adam":
            return lambda params: torch.optim.Adam(params, lr=lr)
        if self.name == "adamw":
            wd = self.weight_decay
            return lambda params: torch.optim.AdamW(params, lr=lr,
                                                    weight_decay=wd)
        if self.name == "sgd":
            return lambda params: torch.optim.SGD(params, lr=lr)
        raise ValueError(f"Unknown optimizer {self.name!r}")


@dataclass
class ExperimentConfig:
    """One JSON = one reproducible experiment: model, optimizer, training
    and MC knobs, and the seed."""

    model: Union[VAEConfig, FlowModelConfig, BackmappingConfig,
                 MappingToDistConfig] = field(default_factory=VAEConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    num_epochs: int = 1
    batch_size: Optional[int] = None
    mcmc: Optional[MCMCConfig] = None

    def build(self, device=None):
        """The model on ``device``: by default the CUDA card (raises where
        there is none; pass ``"cpu"`` to build on the CPU)."""
        device = default_device(device)
        generator = torch.Generator(device=device).manual_seed(self.seed)
        return self.model.build(generator, device)


def flagship_experiment_config() -> ExperimentConfig:
    """The flagship: a VAE with a 2-block RQS-spline MAF prior (32 bins on
    [-5, 5]) over a 1-D standard-normal latent, 200-wide normal
    encoder (2 -> 1) and decoder (1 -> 2), KL regularizer."""
    return ExperimentConfig(
        model=VAEConfig(
            encoder=MappingToDistConfig(
                input_shape=2,
                dist=DistLayerConfig(kind="independent_blockwise",
                                     num_dofs=1, families="normal"),
                mapping_kwargs={"hidden_dim": 200}),
            decoder=MappingToDistConfig(
                input_shape=1,
                dist=DistLayerConfig(kind="independent_blockwise",
                                     num_dofs=2, families="normal"),
                mapping_kwargs={"hidden_dim": 200}),
            prior=FlowedDistConfig(
                flow=MAFConfig(data_dim=1, num_blocks=2,
                               rqs=RQSParams(num_bins=32, hidden_dim=200,
                                             bin_range=(-5.0, 5.0))),
                base=None, static_base_dim=1),
            latent_dim=1,
            regularizer=RegularizerConfig(kind="kl")),
        mcmc=MCMCConfig(n_chains=10_000, n_steps=100))


def backmapping_experiment_config() -> ExperimentConfig:
    """The backmapping notebook's model (``examples/04_backmapping.py``):
    the 10 nearest particles within 3.0 of the CG site, a 2-block
    GA-attention embedding of 2-wide particle info to 20 (hidden 40),
    and a decoder 20 -> 40 -> 9 over three von Mises DOFs pushed through
    a 3-block conditional RQS-spline MAF (20 bins on [-pi, pi], hidden
    40, context: the embedding)."""
    return ExperimentConfig(
        model=BackmappingConfig(
            selection=DistanceSelectionConfig(cutoff=3.0, max_included=10),
            embedding=ParticleEmbeddingConfig(info_dim=2, embedding_dim=20,
                                              hidden_dim=40, num_blocks=2),
            decoder=MappingToDistConfig(
                input_shape=20,
                dist=FlowedDistConfig(
                    flow=MAFConfig(data_dim=3, num_blocks=3, rqs=RQSParams(
                        bin_range=(-math.pi, math.pi), num_bins=20,
                        hidden_dim=40, conditional=True,
                        conditional_event_shape=20)),
                    base=DistLayerConfig(kind="independent_blockwise",
                                         num_dofs=3, families="von_mises")),
                mapping_kwargs={"hidden_dim": 40})),
        batch_size=128)


_CONFIG_REGISTRY: Dict[str, type] = {
    c.__name__: c
    for c in (RQSParams, RealNVPConfig, MAFConfig, MappingConfig, MCMCConfig,
              DistLayerConfig, FlowedDistConfig, RegularizerConfig,
              MappingToDistConfig, FlowModelConfig, VAEConfig,
              DistanceSelectionConfig,
              ParticleEmbeddingConfig, BackmappingConfig, OptimizerConfig,
              ExperimentConfig)
}

"""Typed configuration dataclasses (port of ``vaemolsim_tpu/config.py``).

The dataclasses mirror the JAX package's field for field, read and
write the same tagged JSON (``save_json`` / ``load_json``), and
``build()`` the port's objects on a given device, drawing every weight
from one ``torch.Generator`` seeded by the experiment's ``seed``.  A JSON
written by ``vaemolsim_tpu.config.save_json`` builds the same
architecture here (not the same weights: the random streams differ; use
``convert.from_jax`` to carry weights across).

Ported so far: the configs the flagship experiment uses.  A JSON naming
another config class (RealNVP, backmapping, ...) is refused by name.
"""

from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

__all__ = ["RQSParams", "MAFConfig", "DistLayerConfig", "FlowedDistConfig",
           "RegularizerConfig", "MappingToDistConfig", "VAEConfig",
           "MCMCConfig", "OptimizerConfig", "ExperimentConfig", "from_dict",
           "to_dict", "to_tagged_dict", "save_json", "load_json",
           "flagship_experiment_config"]

_TAG = "__config__"


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

    def asdict(self) -> Dict[str, Any]:
        """kwargs for MaskedSplineConditioner.create."""
        d = dataclasses.asdict(self)
        d["bin_range"] = list(self.bin_range)
        if not self.conditional:
            d.pop("conditional_event_shape")
        return d


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
    """A distribution layer; only ``independent_blockwise`` is ported."""

    kind: str = "independent_blockwise"
    num_dofs: int = 1
    families: Union[str, List[str]] = "normal"
    conditional: bool = False
    conditional_event_shape: Optional[int] = None
    auto_net_params: Optional[Dict[str, Any]] = None

    def build(self, generator: Optional[torch.Generator] = None,
              device=None):
        from vaemolsim_tpu_torch import dists
        if self.conditional:
            raise ValueError(f"kind={self.kind!r} has no conditional "
                             "machinery in the port yet")
        if self.kind != "independent_blockwise":
            raise NotImplementedError(
                f"dist layer kind {self.kind!r} is not ported yet")
        return dists.IndependentBlockwise.create(self.num_dofs, self.families)


@dataclass
class FlowedDistConfig:
    """Flow over a base layer, or with ``base=None`` a
    StaticFlowedDistribution over a standard normal of dimension
    ``static_base_dim`` (the flagship prior)."""

    flow: MAFConfig = field(default_factory=MAFConfig)
    base: Optional[DistLayerConfig] = None
    static_base_dim: Optional[int] = None

    def build(self, generator: torch.Generator, device=None):
        from vaemolsim_tpu_torch import dists
        from vaemolsim_tpu_torch.ops import distributions as d

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
    reverse_kl.  Carried by the VAE as this config (the loss classes
    come with the training slice)."""

    kind: str = "kl"
    weight: float = 1.0
    sample_dist: Optional[str] = None

    def build(self):
        if self.kind not in ("none", "kl", "log_prob", "reverse_kl"):
            raise ValueError(f"Unknown regularizer kind {self.kind!r}")
        return self


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
        from vaemolsim_tpu_torch.models import VAE
        from vaemolsim_tpu_torch.ops import distributions as d

        if self.dual_elbo:
            raise NotImplementedError("VAEDualELBO is not ported yet")
        encoder = self.encoder.build(generator, device)
        decoder = self.decoder.build(generator, device)
        if self.prior is not None:
            prior = self.prior.build(generator, device)
        else:
            prior = d.Independent(
                d.Normal(torch.zeros(self.latent_dim, device=device),
                         torch.ones(self.latent_dim, device=device)), 1)
        return VAE(encoder, decoder, prior, self.regularizer.build())


@dataclass
class OptimizerConfig:
    """Optimizer knobs, carried so experiment JSON round-trips; building
    an optimizer comes with the training slice."""

    name: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0


@dataclass
class ExperimentConfig:
    """One JSON = one reproducible experiment: model, optimizer, training
    and MC knobs, and the seed."""

    model: Union[VAEConfig, MappingToDistConfig] = field(
        default_factory=VAEConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    seed: int = 0
    num_epochs: int = 1
    batch_size: Optional[int] = None
    mcmc: Optional[MCMCConfig] = None

    def build(self, device="cpu"):
        device = torch.device(device)
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


_CONFIG_REGISTRY: Dict[str, type] = {
    c.__name__: c
    for c in (RQSParams, MAFConfig, MCMCConfig, DistLayerConfig,
              FlowedDistConfig, RegularizerConfig, MappingToDistConfig,
              VAEConfig, OptimizerConfig, ExperimentConfig)
}

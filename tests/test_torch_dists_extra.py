"""The port's distributions and distribution layers of slice 9 against
the JAX package, on the CPU: Beta and Gamma (log-densities, moments,
reparameterised gradients), the beta, gamma and von Mises mixture
families, IndependentVonMises, IndependentDeterministic,
AutoregressiveBlockwise (its log-density and the fixed point of its
sampler), a static flow over a non-normal base, and every dist-layer
kind of the config.

Inputs come from numpy seeds and reach both packages as the same arrays;
JAX objects are carried across by ``from_jax(..., "cpu")``.  Float32:
log-densities to 1e-5 (absolute and relative), gradients to 1e-4.
Sample statistics are held to the number of standard errors stated at
each check.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import config as jconfig
from vaemolsim_tpu import dists as jdists
from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineMAF as JMAF
from vaemolsim_tpu.models import MappingToDistribution as JM2D
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch import dists as tdists
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.models import MappingToDistribution
from vaemolsim_tpu_torch.ops import distributions as td

torch.set_num_threads(1)

VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def close(got, want, tol=VAL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


# ---------------------------------------------------------------------------
# Beta and Gamma
# ---------------------------------------------------------------------------


def test_beta_and_gamma_log_prob_match_jax_including_the_edges():
    """Interior points and x = 0 (and 1 for Beta) at unit concentrations,
    where xlogy keeps the density finite."""
    rng = np.random.default_rng(1)
    a = rng.uniform(0.3, 4.0, 6).astype(np.float32)
    b = rng.uniform(0.3, 4.0, 6).astype(np.float32)
    a[:2] = 1.0
    b[2:4] = 1.0
    x = rng.uniform(0.01, 0.99, (7, 6)).astype(np.float32)
    x[0, :] = 0.0
    x[1, :] = 1.0
    pairs = [(td.Beta(t(a), t(b)), jd.Beta(j(a), j(b)), x),
             (td.Gamma(t(a), t(b)), jd.Gamma(j(a), j(b)), 3.0 * x[[0, 2,
                                                                    3]])]
    for tdist, jdist, pts in pairs:
        got = tdist.log_prob(t(pts))
        want = np.asarray(jdist.log_prob(j(pts)))
        finite = np.isfinite(want)
        assert finite[0, :2].all()  # a = 1 at x = 0: finite
        np.testing.assert_array_equal(np.isfinite(got.numpy()), finite)
        close(got.numpy()[finite], want[finite])
        carried = from_jax(jdist, "cpu")
        close(carried.log_prob(t(pts)).numpy()[finite], want[finite])


@pytest.mark.parametrize("family", ["beta", "gamma"])
def test_beta_and_gamma_sample_moments_and_reparameterized_gradients(family):
    """200k draws: mean and variance within 5 standard errors, and the
    gradient of the sample mean with respect to each parameter (a Monte
    Carlo estimate) within 5% of the analytic derivative of the mean plus
    5 standard errors of the sample mean (Gamma: d(a/r)/da = 1/r,
    d(a/r)/dr = -a/r^2; Beta: d(a/(a+b))/da = b/(a+b)^2, d/db =
    -a/(a+b)^2)."""
    n = 200_000
    gen = torch.Generator().manual_seed(7)
    p1 = torch.tensor([0.7, 3.0], requires_grad=True)
    p2 = torch.tensor([2.0, 1.5], requires_grad=True)
    dist = (td.Beta(p1, p2) if family == "beta" else td.Gamma(p1, p2))
    x = dist.sample(gen, (n,))
    assert x.shape == (n, 2) and bool(torch.isfinite(x).all())
    a, b = p1.detach().double(), p2.detach().double()
    if family == "beta":
        mean, var = a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1))
        d_mean = (b / (a + b) ** 2, -a / (a + b) ** 2)
        assert bool(((x > 0) & (x < 1)).all())
    else:
        mean, var = a / b, a / b ** 2
        d_mean = (1.0 / b, -a / b ** 2)
        assert bool((x >= 0).all())
    xd = x.detach().double()
    se = torch.sqrt(var / n)
    assert bool(((xd.mean(0) - mean).abs() < 5 * se).all())
    se_var = torch.sqrt(((xd - xd.mean(0)) ** 4).mean(0) / n)
    assert bool(((xd.var(0) - var).abs() < 5 * se_var).all())
    for k in range(2):
        g1, g2 = torch.autograd.grad(x[:, k].mean(), (p1, p2),
                                     retain_graph=True)
        for g, want in ((g1[k], d_mean[0][k]), (g2[k], d_mean[1][k])):
            assert abs(float(g) - float(want)) < 0.05 * abs(float(want)) \
                + 5 * float(se[k]), (family, k, float(g), float(want))


# ---------------------------------------------------------------------------
# Families and the independent layers
# ---------------------------------------------------------------------------


def test_family_registry_matches_jax():
    """beta, gamma and von Mises mixtures of 2 and 3 components in one
    IndependentBlockwise: params sizes and log-densities."""
    names = [jdists.register_von_mises_mixture(2),
             jdists.register_von_mises_mixture(3)]
    assert names == [tdists.register_von_mises_mixture(2),
                     tdists.register_von_mises_mixture(3)]
    fams = ["beta", names[0], "gamma", names[1], "normal", "von_mises"]
    jl = jdists.IndependentBlockwise.create(len(fams), fams)
    tl = from_jax(jl, "cpu")
    assert tl.params_size() == jl.params_size() == 2 + 8 + 2 + 12 + 2 + 3
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(40, jl.params_size())).astype(np.float32)
    x = rng.uniform(0.05, 0.95, (40, len(fams))).astype(np.float32)
    x[:, 1] = rng.uniform(-np.pi, np.pi, 40)
    x[:, 3] = rng.uniform(-np.pi, np.pi, 40)
    close(tl(t(raw)).log_prob(t(x)), jl(j(raw)).log_prob(j(x)))
    s = tl(t(raw)).sample(torch.Generator().manual_seed(3), (5,))
    assert s.shape == (5, 40, len(fams))
    assert bool((s[..., [1, 3, 5]].abs() <= math.pi + 1e-6).all())


def test_independent_von_mises_and_deterministic_match_jax():
    rng = np.random.default_rng(4)
    raw = rng.normal(size=(30, 9)).astype(np.float32)
    raw[0] = 0.0  # the degenerate atan2 point
    x = rng.uniform(-np.pi, np.pi, (30, 3)).astype(np.float32)
    jvm = jdists.IndependentVonMises.create(3)
    tvm = from_jax(jvm, "cpu")
    assert tvm.params_size() == 9
    close(tvm(t(raw)).log_prob(t(x)), jvm(j(raw)).log_prob(j(x)))
    # Plain softplus, not the blockwise soft clip: large raw values pass.
    big = np.full((1, 9), 50.0, np.float32)
    close(tvm(t(big)).base.concentration, jvm(j(big)).base.concentration)
    jdet = jdists.IndependentDeterministic.create(3)
    tdet = from_jax(jdet, "cpu")
    loc = rng.normal(size=(30, 3)).astype(np.float32)
    probe = loc.copy()
    probe[::2, 1] += 0.5
    close(tdet(t(loc)).log_prob(t(probe)), jdet(j(loc)).log_prob(j(probe)))
    assert torch.equal(tdet(t(loc)).sample(torch.Generator()), t(loc))
    with pytest.raises(ValueError, match="Expected last dim"):
        tdet(torch.zeros(2, 4))


def test_static_flow_over_a_von_mises_base_matches_jax():
    """A StaticFlowedDistribution takes a base of any family: a 2-D MAF
    over an Independent(VonMises) base, its buffers and log_prob."""
    flow = JMAF.create(jax.random.PRNGKey(5), 2, num_blocks=2,
                       rqs_params={"num_bins": 8, "hidden_dim": 16,
                                   "bin_range": [-np.pi, np.pi]})
    base = jd.Independent(jd.VonMises(j([0.3, -1.0]), j([2.0, 0.5])), 1)
    jstatic = JStatic(flow=flow, base=base)
    tstatic = from_jax(jstatic, "cpu")
    assert set(dict(tstatic.named_buffers())) >= {"base_loc",
                                                   "base_concentration"}
    x = np.random.default_rng(6).uniform(-3.0, 3.0, (25, 2)).astype(
        np.float32)
    close(tstatic().log_prob(t(x)), jstatic().log_prob(j(x)))
    assert isinstance(tstatic.to("cpu").base.base, td.VonMises)


# ---------------------------------------------------------------------------
# AutoregressiveBlockwise
# ---------------------------------------------------------------------------


def jax_autoregressive(seed, families, conditional):
    """A JAX AutoregressiveBlockwise whose MADE weights are scaled up so
    the autoregressive shift matters."""
    layer = jdists.AutoregressiveBlockwise.create(
        jax.random.PRNGKey(seed), 3, families, conditional=conditional,
        conditional_event_shape=4 if conditional else None)
    rng = np.random.default_rng(seed)
    made = layer.made
    made = made.replace(
        kernels=tuple(j(10.0 * np.asarray(k)) for k in made.kernels),
        biases=tuple(j(0.2 * rng.normal(size=b.shape)) for b in made.biases),
        cond_kernels=(None if made.cond_kernels is None else tuple(
            j(10.0 * np.asarray(c)) for c in made.cond_kernels)))
    return layer.replace(made=made)


AR_CASES = [("von_mises_mixture_2", True), (["normal", "von_mises", "gamma"],
                                            False)]


@pytest.mark.parametrize("families,conditional", AR_CASES)
def test_autoregressive_blockwise_log_prob_matches_jax(families,
                                                       conditional):
    jdists.register_von_mises_mixture(2)
    tdists.register_von_mises_mixture(2)
    jl = jax_autoregressive(8, families, conditional)
    tl = from_jax(jl, "cpu")
    assert tl.params_size() == jl.params_size()
    D, P = jl.params_size()
    rng = np.random.default_rng(9)
    raw = rng.normal(size=(33, D, P)).astype(np.float32)
    ctx = rng.normal(size=(33, 4)).astype(np.float32) if conditional else None
    x = rng.uniform(-np.pi, np.pi, (33, D)).astype(np.float32)
    if not conditional:
        x[:, 2] = np.abs(x[:, 2]) + 0.1  # the gamma DOF is positive
    tdist = tl(t(raw), None if ctx is None else t(ctx))
    jdist = jl(j(raw), None if ctx is None else j(ctx))
    close(tdist.log_prob(t(x)), jdist.log_prob(j(x)))
    assert tdist.batch_shape == (33,) and tdist.event_shape == (3,)


def test_autoregressive_sample_is_a_fixed_point_of_its_passes():
    """A (D+1)-th pass on the same noise changes nothing and leaves the
    generator where the D passes left it; one pass alone is not yet the
    draw; the next call draws anew."""
    tdists.register_von_mises_mixture(2)
    jl = jax_autoregressive(10, "von_mises_mixture_2", True)
    tl = from_jax(jl, "cpu")
    rng = np.random.default_rng(11)
    raw = t(rng.normal(size=(200, 3, 8)))
    ctx = t(rng.normal(size=(200, 4)))
    dist = tl(raw, ctx)
    gen = torch.Generator().manual_seed(12)
    start = gen.get_state()
    x3 = dist.sample(gen)
    after = gen.get_state()
    replay = torch.Generator()
    replay.set_state(start)
    assert torch.equal(dist._dist_at(x3).sample(replay), x3)
    assert torch.equal(replay.get_state(), after)
    replay.set_state(start)
    x1 = dist._dist_at(torch.ones_like(x3)).sample(replay)
    assert not torch.equal(x1, x3)
    assert not torch.equal(dist.sample(gen), x3)
    assert x3.shape == (200, 3)
    assert bool((x3.abs() <= math.pi + 1e-6).all())
    # Each DOF follows its own conditional given the returned parents:
    # its density is finite there.
    assert bool(torch.isfinite(dist.log_prob(x3)).all())


def test_mapping_to_distribution_with_the_2d_params_size():
    """MappingToDistribution sizes the FCDeepNN head to (D, P) from the
    autoregressive layer; the whole decoder against JAX."""
    jdists.register_von_mises_mixture(2)
    tdists.register_von_mises_mixture(2)
    jdec = JM2D.create(jax.random.PRNGKey(13),
                       jax_autoregressive(14, "von_mises_mixture_2", True),
                       input_shape=4, mapping_kwargs={"hidden_dim": 12})
    tdec = from_jax(jdec, "cpu")
    assert tdec.mapping.target_shape == (3, 8)
    rng = np.random.default_rng(15)
    inp = rng.normal(size=(21, 4)).astype(np.float32)
    x = rng.uniform(-np.pi, np.pi, (21, 3)).astype(np.float32)
    close(tdec(t(inp)).log_prob(t(x)), jdec(j(inp)).log_prob(j(x)))
    built = MappingToDistribution.create(
        torch.Generator().manual_seed(0),
        tdists.AutoregressiveBlockwise.create(
            torch.Generator().manual_seed(1), 3, "von_mises_mixture_2",
            conditional=True, conditional_event_shape=4, device="cpu"),
        input_shape=4, mapping_kwargs={"hidden_dim": 12}, device="cpu")
    assert ({k: tuple(v.shape) for k, v in built.state_dict().items()}
            == {k: tuple(v.shape) for k, v in tdec.state_dict().items()})


@pytest.mark.parametrize("kind", ["independent_blockwise",
                                  "autoregressive_blockwise",
                                  "independent_von_mises",
                                  "independent_deterministic"])
def test_every_dist_layer_kind_builds_as_in_jax(kind):
    cfg = dict(kind=kind, num_dofs=3, families="normal")
    jlayer = jconfig.DistLayerConfig(**cfg).build(jax.random.PRNGKey(0))
    tlayer = tconfig.DistLayerConfig(**cfg).build(
        torch.Generator().manual_seed(0), "cpu")
    assert type(tlayer).__name__ == type(jlayer).__name__
    assert tlayer.params_size() == jlayer.params_size()
    cond = tconfig.DistLayerConfig(**cfg, conditional=True,
                                   conditional_event_shape=2)
    if kind == "autoregressive_blockwise":
        assert cond.build(torch.Generator(), "cpu").conditional
    else:
        with pytest.raises(ValueError, match="no conditional"):
            cond.build(torch.Generator(), "cpu")

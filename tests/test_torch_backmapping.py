"""The port's backmapping path against the JAX package, on the CPU:
DistanceSelection, the von Mises distribution (density, sampler,
implicit reparameterization) and its family layer, SoftClip, and
BackmappingOnly (``log_prob``, ``predict``, ``train.fit``, config JSON).

JAX models are built at narrow widths on the notebook's wiring and
carried into the port with ``convert.from_jax``; inputs come from
``numpy.random.default_rng``.  The two packages draw different random
numbers, so the sampler is pinned by its statistics, not its samples.
Float32; each tolerance is stated with its reason.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import config as jconfig
from vaemolsim_tpu.dists import layers as jlayers
from vaemolsim_tpu.nn.mappings import DistanceSelection as JSelect
from vaemolsim_tpu.ops import bijectors as jbj
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.dists import layers as tlayers
from vaemolsim_tpu_torch.nn import DistanceSelection
from vaemolsim_tpu_torch.ops import bijectors as tbj
from vaemolsim_tpu_torch.ops import distributions as td
from vaemolsim_tpu_torch.train import fit

torch.set_num_threads(1)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


# ---------------------------------------------------------------------------
# DistanceSelection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "stored_box", "per_call_box",
                                  "mask", "fewer_than_k", "padding_ties"])
def test_distance_selection_matches_jax(case):
    """Selections, validity and co-selected info equal JAX's exactly
    (the same float32 differences and comparisons).  ``padding_ties``:
    more masked rows than free slots, all at finfo.max, so top-k takes
    tied padding rows, in whatever order; they are invalid and zeroed
    on both sides."""
    rng = np.random.default_rng(1)
    P = 5 if case == "fewer_than_k" else 20
    coords = (2.0 * rng.normal(size=(4, P, 3))).astype(np.float32)
    ref = (0.3 * rng.normal(size=(4, 3))).astype(np.float32)
    info = rng.normal(size=(4, P, 2)).astype(np.float32)
    mask = None
    if case == "mask":
        mask = rng.random((4, P)) > 0.3
    if case == "padding_ties":
        mask = np.zeros((4, P), bool)
        mask[:, :3] = True
    box = np.asarray([3.0, 4.0, 5.0], np.float32)
    stored = box if case == "stored_box" else None
    per_call = (np.asarray([[3.0, 4.0, 5.0]] * 4, np.float32)
                if case == "per_call_box" else None)
    jsel = JSelect.create(2.5, max_included=8, box_lengths=stored)
    tsel = from_jax(jsel, "cpu")
    want = jsel(j(coords), j(ref), None if mask is None else jnp.asarray(mask),
                j(info), None if per_call is None else j(per_call))
    got = tsel(t(coords), t(ref), None if mask is None else torch.tensor(mask),
               t(info), None if per_call is None else t(per_call))
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (4, 8, 3)
    if case == "fewer_than_k":
        assert not bool(got[1][:, P:].any())
    if case == "padding_ties":
        assert int(got[1].sum(-1).max()) <= 3


def test_distance_selection_box_takes_no_gradient():
    coords = t(np.random.default_rng(2).normal(size=(2, 6, 3))).requires_grad_()
    box = torch.tensor([2.0, 2.0, 2.0], requires_grad=True)
    sel = DistanceSelection.create(3.0, 4, device="cpu")(
        coords, torch.zeros(2, 3),
                                           box_lengths=box)[0]
    sel.sum().backward()
    assert box.grad is None and coords.grad is not None


# ---------------------------------------------------------------------------
# Von Mises
# ---------------------------------------------------------------------------


KAPPAS = [1e-6, 1e-5, 3e-5, 0.5, 2.0, 10.0, 100.0, 3e3, 1e5]


def test_von_mises_log_prob_matches_jax():
    """log_prob through i0e at tiny, moderate and large concentration:
    1e-5 + 1e-5|v| (k cos(x - loc) and log(i0e(k)) + k cancel to O(1)
    out of O(k) terms)."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-math.pi, math.pi, size=(len(KAPPAS), 16)).astype(
        np.float32)
    loc = rng.uniform(-math.pi, math.pi, size=(len(KAPPAS), 1)).astype(
        np.float32)
    k = np.asarray(KAPPAS, np.float32)[:, None]
    want = np.asarray(jd.VonMises(j(loc), j(k)).log_prob(j(x)))
    got = td.VonMises(t(loc), t(k)).log_prob(t(x)).numpy()
    scale = np.maximum(1.0, k)
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kappa", [1e-6, 0.5, 2.0, 10.0, 50.0])
def test_von_mises_sampler_statistics(kappa):
    """20k draws about loc = 2.5: the circular mean is loc and the mean
    resultant length is A(k) = I1(k)/I0(k) (0 below k = 1e-5, where the
    sampler draws uniformly), each within 5 standard errors
    (sqrt((1 - A^2) / 2n) per axis, at least 1/sqrt(n)); every sample
    lies in [-pi, pi]."""
    n = 20_000
    d = td.VonMises(torch.full((n,), 2.5), torch.full((n,), kappa))
    z = d.sample(torch.Generator().manual_seed(4)).double()
    assert bool((z.abs() <= math.pi + 1e-6).all())
    C, S = torch.cos(z - 2.5).mean().item(), torch.sin(z - 2.5).mean().item()
    a = 0.0 if kappa < 1e-5 else float(
        torch.special.i1e(torch.tensor(kappa, dtype=torch.float64))
        / torch.special.i0e(torch.tensor(kappa, dtype=torch.float64)))
    se = max(math.sqrt((1.0 - a * a) / (2 * n)), 1.0 / math.sqrt(n))
    assert abs(C - a) < 5 * se
    assert abs(S) < 5 * se


def test_von_mises_dz_dconc_matches_jax_and_drives_autograd():
    """The quadrature against JAX's at shared centred samples (1e-5 +
    1e-4|v|: 64-node sums of exponentials), and the sampler's gradients:
    1 with respect to loc, dz/dk at the drawn sample with respect to the
    concentration."""
    z0 = np.linspace(-3.1, 3.1, 41, dtype=np.float32)
    k = np.asarray([0.3, 1.0, 5.0, 40.0, 900.0, 2000.0], np.float32)
    zz, kk = np.meshgrid(z0, k)
    want = np.asarray(jd._von_mises_dz_dconc(j(zz), j(kk)))
    got = td.von_mises_dz_dconc(t(zz), t(kk)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    loc = torch.tensor([0.4, -2.0, 1.0]).requires_grad_()
    conc = torch.tensor([0.7, 3.0, 25.0]).requires_grad_()
    z = td.VonMises(loc, conc).sample(torch.Generator().manual_seed(5), (2,))
    w = torch.tensor([[1.0, 2.0, 3.0], [0.5, -1.0, 2.0]])
    gl, gc = torch.autograd.grad((w * z).sum(), [loc, conc])
    torch.testing.assert_close(gl, w.sum(0))
    z0s = td._wrap(z.detach() - loc.detach())
    expect = (w * td.von_mises_dz_dconc(z0s, conc.detach().expand(2, 3))
              ).sum(0)
    torch.testing.assert_close(gc, expect)


def test_von_mises_family_from_raw_matches_jax():
    """loc = atan2 with the (0, 0) guard, concentration soft-clipped to
    [eps, sqrt(float32 max)/2]; at sin = cos = 0 loc is 0 with a zero,
    finite gradient."""
    rng = np.random.default_rng(6)
    raw = rng.normal(size=(5, 3, 3)).astype(np.float32) * 3.0
    raw[0, 0, :2] = 0.0
    raw[1, 1, 2] = -30.0
    jdist = jlayers._von_mises_from_raw(j(raw))
    traw = t(raw).requires_grad_()
    tdist = tlayers.build_family_dist("von_mises", traw)
    np.testing.assert_allclose(tdist.loc.detach().numpy(),
                               np.asarray(jdist.loc), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tdist.concentration.detach().numpy(),
                               np.asarray(jdist.concentration), rtol=1e-6,
                               atol=1e-12)
    assert float(tdist.loc[0, 0].detach()) == 0.0
    (g,) = torch.autograd.grad(tdist.loc.sum(), [traw])
    assert bool(torch.isfinite(g).all()) and float(g[0, 0].abs().sum()) == 0.0
    assert tlayers.family_param_count(td.VonMises) == 3


def test_soft_clip_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.normal(size=64).astype(np.float32) * 4.0
    jb, tb = jbj.SoftClip(low=-1.0, high=2.0), tbj.SoftClip(-1.0, 2.0)
    for jf, tf, arg in ((jb.forward_and_log_det, tb.forward_and_log_det, x),
                        (jb.inverse_and_log_det, tb.inverse_and_log_det,
                         np.clip(x, -0.9, 1.9))):
        for g, w in zip(tf(t(arg)), jf(j(arg))):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5)
    assert bool(torch.isnan(tb.inverse(torch.tensor([2.5]))).all())


# ---------------------------------------------------------------------------
# BackmappingOnly
# ---------------------------------------------------------------------------


def jax_backmapping_config(**kw):
    """The notebook's wiring at narrow widths: 6 of 16 particles within
    3.0, a 2-block embedding of width 8 (hidden 12), a decoder 8 -> 10
    -> 9 over three von Mises DOFs and a 2-block conditional MAF (6 bins
    on [-pi, pi], hidden 10)."""
    return jconfig.ExperimentConfig(model=jconfig.BackmappingConfig(
        selection=jconfig.DistanceSelectionConfig(cutoff=3.0,
                                                  max_included=6),
        embedding=jconfig.ParticleEmbeddingConfig(
            info_dim=2, embedding_dim=8, hidden_dim=12, num_blocks=2),
        decoder=jconfig.MappingToDistConfig(
            input_shape=8, dist=jconfig.FlowedDistConfig(
                flow=jconfig.MAFConfig(data_dim=3, num_blocks=2,
                                       rqs=jconfig.RQSParams(
                                           bin_range=(-math.pi, math.pi),
                                           num_bins=6, hidden_dim=10,
                                           conditional=True,
                                           conditional_event_shape=8)),
                base=jconfig.DistLayerConfig(num_dofs=3,
                                             families="von_mises")),
            mapping_kwargs={"hidden_dim": 10})), **kw)


def frames(seed, n, P=16):
    """examples/04_backmapping.py's synthetic frames: coordinates of
    spread 1.5, 2-wide info, a CG site of spread 0.3 and torsions whose
    mean depends on the number of particles within 3.0."""
    rng = np.random.default_rng(seed)
    coords = (1.5 * rng.normal(size=(n, P, 3))).astype(np.float32)
    info = rng.normal(size=(n, P, 2)).astype(np.float32)
    ref = (0.3 * rng.normal(size=(n, 3))).astype(np.float32)
    count = (np.linalg.norm(coords - ref[:, None], axis=-1) < 3.0).sum(-1)
    tors = ((count % 5 - 2.0) * 0.8)[:, None] + 0.3 * rng.normal(size=(n, 3))
    tors = (tors - 2 * np.pi * np.round(tors / (2 * np.pi))).astype(
        np.float32)
    return ref, coords, info, tors


@pytest.fixture(scope="module")
def pair():
    jm = jax_backmapping_config().build()
    leaves, tree = jax.tree_util.tree_flatten(jm)
    rng = np.random.default_rng(8)
    jm = jax.tree_util.tree_unflatten(tree, [
        leaf + 0.05 * rng.normal(size=leaf.shape).astype(np.float32)
        if leaf.dtype == np.float32 and leaf.ndim == 1 else leaf
        for leaf in leaves])
    return jm, from_jax(jm, "cpu")


def _nll(m, batch):
    ref, coords, info, tors = batch
    return -m.log_prob(ref, coords, info, tors).mean()


@pytest.mark.parametrize("case", ["plain", "mask_and_box"])
def test_backmapping_log_prob_matches_jax(pair, case):
    """Decoded-torsion log-densities: 2e-5 + 2e-5|v| (an embedding of
    three attention layers, then three O(1) log-dets over a von Mises
    base)."""
    jm, tm = pair
    ref, coords, info, tors = frames(9, 24)
    kw = {}
    if case == "mask_and_box":
        mask = np.random.default_rng(10).random(coords.shape[:2]) > 0.2
        kw = dict(mask=mask, box_lengths=np.asarray([5.0, 6.0, 7.0],
                                                    np.float32))
    want = jm(j(ref), j(coords), j(info),
              **{k: jnp.asarray(v) for k, v in kw.items()}).log_prob(j(tors))
    _build.reset_launches()
    with torch.no_grad():
        got = tm.log_prob(t(ref), t(coords), t(info), t(tors),
                          **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.shape == (24,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert all(v == 0 for v in _build.launch_counts().values())


def test_backmapping_predict_samples_torsions(pair):
    _, tm = pair
    ref, coords, info, _ = frames(11, 40)
    with torch.no_grad():
        z = tm.predict(t(ref), t(coords), t(info),
                       torch.Generator().manual_seed(12))
    assert z.shape == (40, 3)
    assert bool(torch.isfinite(z).all())
    assert bool((z.abs() <= math.pi + 1e-5).all())


def test_backmapping_fit_matches_jax_gradients_and_learns():
    """The first step's gradient of the mean NLL for every parameter
    against jax.grad (5e-5 + 5e-4|g|: sums over the batch and the pair
    grid in another order), then a few epochs of fit at batch 32 on 128
    frames, through a 4-tuple batch: the mean NLL falls."""
    jm = jax_backmapping_config().build()
    tm = from_jax(jm, "cpu")
    batch = frames(13, 128)
    jgrad = jax.grad(lambda m: -jnp.mean(m(*[j(a) for a in batch[:3]])
                                         .log_prob(j(batch[3]))))(jm)
    want = list(from_jax(jgrad, "cpu").parameters())
    got = torch.autograd.grad(_nll(tm, [t(a) for a in batch]),
                              list(tm.parameters()))
    assert len(got) == len(want) > 60
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.detach(), rtol=5e-4, atol=5e-5)
    _, hist = fit(tm, lambda m, b, g: _nll(m, b),
                  tuple(t(a) for a in batch),
                  generator=torch.Generator().manual_seed(14), num_epochs=6,
                  batch_size=32, learning_rate=3e-3)
    assert all(math.isfinite(v) for v in hist["loss"])
    assert hist["loss"][-1] < hist["loss"][0] - 0.05


def test_backmapping_json_from_jax_builds_same_architecture(tmp_path):
    """A BackmappingConfig JSON written by the JAX package loads in the
    port, builds the architecture of from_jax(the JAX build) (every
    parameter shape), and builds the notebook model of
    ``backmapping_experiment_config``."""
    jcfg = jax_backmapping_config(batch_size=128)
    path = str(tmp_path / "backmapping.json")
    jconfig.save_json(jcfg, path)
    cfg = tconfig.load_json(path)
    assert isinstance(cfg.model, tconfig.BackmappingConfig)
    built, carried = cfg.build("cpu"), from_jax(jcfg.build(), "cpu")
    assert ({k: tuple(v.shape) for k, v in built.state_dict().items()}
            == {k: tuple(v.shape) for k, v in carried.state_dict().items()})
    notebook = tconfig.backmapping_experiment_config()
    jnb = jconfig.ExperimentConfig(model=jconfig.BackmappingConfig(
        embedding=jconfig.ParticleEmbeddingConfig(info_dim=2),
        decoder=jconfig.MappingToDistConfig(
            input_shape=20, dist=jconfig.FlowedDistConfig(
                flow=jconfig.MAFConfig(data_dim=3, num_blocks=3,
                                       rqs=jconfig.RQSParams(
                                           bin_range=(-math.pi, math.pi),
                                           num_bins=20, hidden_dim=40,
                                           conditional=True,
                                           conditional_event_shape=20)),
                base=jconfig.DistLayerConfig(num_dofs=3,
                                             families="von_mises")),
            mapping_kwargs={"hidden_dim": 40})))
    assert ({k: tuple(v.shape) for k, v in
             notebook.build("cpu").state_dict().items()}
            == {k: tuple(v.shape) for k, v in
                from_jax(jnb.build(), "cpu").state_dict().items()})


@pytest.mark.parametrize("field,value", [("kind", "schnet"),
                                         ("attention", "two_stage")])
def test_unported_embeddings_raise_by_name(field, value):
    # Both embeddings are ported now: each builds on the CPU, and an
    # unknown value of the same field still raises, naming the value.
    from vaemolsim_tpu_torch.nn import (SchNetEmbedding,
                                        VectorAttentionTwoStage)
    built = tconfig.ParticleEmbeddingConfig(**{field: value}).build(
        torch.Generator(), "cpu")
    if field == "kind":
        assert isinstance(built, SchNetEmbedding)
    else:
        assert isinstance(built.final_attn, VectorAttentionTwoStage)
    cfg = tconfig.ParticleEmbeddingConfig(**{field: "bogus"})
    with pytest.raises(ValueError, match="bogus"):
        cfg.build(torch.Generator(), "cpu")

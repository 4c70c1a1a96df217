"""The port's SchNet layers and two-stage attention against the JAX
package, on the CPU, float32, to 1e-5 relative + 1e-5 absolute:
``SchNetEmbedding`` (with padding and a coincident pair),
``SchNetPotential`` energies and forces, periodic and open, with a
coincident pair, ``energy_force_loss`` and its weight gradients,
``VectorAttentionTwoStage`` in both ``reduce`` modes with a mask, and a
two-stage ``ParticleEmbedding``; and the config switches that build
them.  JAX objects are carried across by ``from_jax(..., "cpu")``;
inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.nn import attention as jattn
from vaemolsim_tpu.nn import schnet as jschnet
from vaemolsim_tpu_torch import config as tconfig
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.nn import (ParticleEmbedding, SchNetEmbedding,
                                    SchNetPotential, VectorAttentionTwoStage,
                                    energy_force_loss)

torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(got, want, tol=TOL, msg=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **tol)


def _cloud(seed, B=5, N=7, F=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(B, N, 3)).astype(np.float32)
    x[:, -1] = 0.0  # zero rows: padding under mask_zero
    x[0, 1] = x[0, 0]  # a coincident pair
    info = rng.normal(size=(B, N, F)).astype(np.float32)
    mask = rng.uniform(size=(B, N)) < 0.8
    mask[1] = False  # a fully masked cloud
    return x, info, mask


@pytest.mark.parametrize("pool", ["mean", "sum"])
def test_schnet_embedding_matches_jax(pool):
    jm = jschnet.SchNetEmbedding.create(jax.random.PRNGKey(0), 3, 6,
                                        features=16, num_blocks=2, n_rbf=8,
                                        cutoff=3.0, pool=pool)
    tm = from_jax(jm, "cpu")
    assert isinstance(tm, SchNetEmbedding)
    x, info, mask = _cloud(1)
    jf = jax.jit(lambda *a: jm(*a))
    close(tm(t(x), t(info)), jf(jnp.asarray(x), jnp.asarray(info)),
          msg="mask_zero")
    close(tm(t(x), t(info), torch.tensor(mask)),
          jf(jnp.asarray(x), jnp.asarray(info), jnp.asarray(mask)),
          msg="explicit mask")


def _potential(seed=0):
    jm = jschnet.SchNetPotential.create(jax.random.PRNGKey(seed), 2,
                                        features=16, num_blocks=2, n_rbf=12,
                                        cutoff=2.5)
    # Non-trivial scale and reference energies.
    jm = jm.replace(e_scale=jnp.asarray(1.3),
                    e_ref=jnp.asarray([0.2, -0.4]))
    return jm, from_jax(jm, "cpu")


def _atoms(seed, B=3, N=10, L=4.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, L, size=(B, N, 3)).astype(np.float32)
    x[0, 3] = x[0, 2]  # a coincident pair
    species = np.eye(2, dtype=np.float32)[np.arange(N) % 2]
    mask = np.ones((B, N), bool)
    mask[2, -3:] = False
    return x, species, mask


@pytest.mark.parametrize("periodic", [False, True])
def test_schnet_potential_energies_and_forces_match_jax(periodic):
    jm, tm = _potential()
    assert isinstance(tm, SchNetPotential)
    x, species, mask = _atoms(2)
    box = np.array([4.0, 4.0, 4.0], np.float32) if periodic else None
    jbox = None if box is None else jnp.asarray(box)
    tbox = None if box is None else t(box)
    for m in (None, mask):
        jmask = None if m is None else jnp.asarray(m)
        tmask = None if m is None else torch.tensor(m)
        close(tm.atom_energies(t(x), t(species), tbox, tmask),
              jax.jit(jm.atom_energies)(jnp.asarray(x), jnp.asarray(species),
                                        jbox, jmask), msg="atom energies")
        tx = t(x).requires_grad_(True)
        e = tm(tx, t(species), tbox, tmask)
        f, = torch.autograd.grad(-e.sum(), tx)
        je, jg = jax.jit(jax.value_and_grad(lambda v: jnp.sum(jm(
            v, jnp.asarray(species), jbox, jmask))))(jnp.asarray(x))
        close(e.sum(), je, msg="energy")
        close(f, -jg, TOL, "forces")
        assert torch.isfinite(f).all()
    pot = tm.as_potential(t(species), tbox)
    close(pot(t(x)), jm.as_potential(jnp.asarray(species), jbox)(
        jnp.asarray(x)), msg="as_potential")
    if periodic:
        close(tm.as_potential_for_box(t(species))(t(box * 1.1))(t(x)),
              jm.as_potential_for_box(jnp.asarray(species))(
                  jnp.asarray(box * 1.1))(jnp.asarray(x)), msg="for_box")


@pytest.mark.parametrize("masked", [False, True])
def test_energy_force_loss_and_gradients_match_jax(masked):
    jm, tm = _potential(1)
    x, species, mask = _atoms(3)
    rng = np.random.default_rng(3)
    energy = rng.normal(size=3).astype(np.float32)
    forces = rng.normal(size=x.shape).astype(np.float32)
    box = np.array([4.0, 4.0, 4.0], np.float32)
    m = mask if masked else None
    kw = dict(w_energy=0.1, w_force=1.0)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda mod: jschnet.energy_force_loss(
            mod, jnp.asarray(x), jnp.asarray(species), jnp.asarray(energy),
            jnp.asarray(forces), box=jnp.asarray(box),
            mask=None if m is None else jnp.asarray(m), **kw)))(jm)
    loss = energy_force_loss(tm, t(x), t(species), t(energy), t(forces),
                             box=t(box),
                             mask=None if m is None else torch.tensor(m),
                             **kw)
    loss.backward()
    close(loss, jloss, msg="loss")
    close(tm.e_ref.grad, jgrad.e_ref, msg="d e_ref")
    close(tm.e_scale.grad, jgrad.e_scale, msg="d e_scale")
    close(tm.blocks[0].filter1.kernel.grad, jgrad.blocks[0].filter1.kernel,
          dict(atol=1e-5, rtol=1e-4), "d filter1")
    close(tm.species_net.kernel.grad, jgrad.species_net.kernel,
          dict(atol=1e-5, rtol=1e-4), "d species_net")


@pytest.mark.parametrize("reduce", [False, True])
def test_two_stage_attention_matches_jax(reduce):
    ja = jattn.VectorAttentionTwoStage.create(jax.random.PRNGKey(3), 5, 6,
                                              hidden_dim=12, reduce=reduce)
    ta = from_jax(ja, "cpu")
    assert isinstance(ta, VectorAttentionTwoStage)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 6, 3)).astype(np.float32)
    v = rng.normal(size=(4, 6, 5)).astype(np.float32)
    mask = rng.uniform(size=(4, 6)) < 0.7
    mask[0] = False
    for m in (None, mask):
        close(ta(t(x), t(v), None if m is None else torch.tensor(m)),
              jax.jit(lambda *a: ja(*a))(
                  jnp.asarray(x), jnp.asarray(v),
                  None if m is None else jnp.asarray(m)))
    # Gradients through the masked layer.
    tx = t(x).requires_grad_(True)
    (ta(tx, t(v), torch.tensor(mask)) ** 2).sum().backward()
    jg = jax.jit(jax.grad(lambda c: jnp.sum(ja(c, jnp.asarray(v),
                                               jnp.asarray(mask)) ** 2)))(
        jnp.asarray(x))
    close(tx.grad, jg, dict(atol=1e-5, rtol=1e-4), "d coords")


def test_two_stage_particle_embedding_matches_jax():
    je = jattn.ParticleEmbedding.create(jax.random.PRNGKey(5), 2, 8,
                                        hidden_dim=10, num_blocks=2,
                                        attention="two_stage")
    te = from_jax(je, "cpu")
    assert isinstance(te, ParticleEmbedding)
    assert isinstance(te.final_attn, VectorAttentionTwoStage)
    x, info, _ = _cloud(6, F=2)
    close(te(t(x), t(info)),
          jax.jit(lambda *a: je(*a))(jnp.asarray(x), jnp.asarray(info)))


def test_configs_build_schnet_and_two_stage_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    emb = tconfig.ParticleEmbeddingConfig(kind="schnet", hidden_dim=16,
                                          num_blocks=1).build(g, "cpu")
    assert isinstance(emb, SchNetEmbedding)
    assert all(p.device.type == "cpu" for p in emb.parameters())
    two = tconfig.ParticleEmbeddingConfig(attention="two_stage").build(
        g, "cpu")
    assert isinstance(two.final_attn, VectorAttentionTwoStage)
    bm = tconfig.backmapping_experiment_config()
    bm.model.embedding.attention = "two_stage"
    model = bm.build("cpu")
    assert isinstance(model.mask_and_embed.embed.final_attn,
                      VectorAttentionTwoStage)

"""The port's ``JointBackmapping`` against the JAX package, on the CPU
(B = 8 systems, R = 4 residues, D = 2 internal coordinates a residue),
for both environment embeddings, float32: the joint log-density to 1e-5
relative + 1e-5 absolute, and the gradients of the mean negative
log-density in the weights to 1e-4.  Then causality (a change to residue
s >= r leaves residue r's context as it was) and sampling: the shape,
and the same draws from a generator in the same state."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.dists import IndependentBlockwise as JBlockwise
from vaemolsim_tpu.dists import JointBackmapping as JJoint
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.dists import (IndependentBlockwise,
                                       JointBackmapping,
                                       JointBackmappingDistribution)

torch.set_num_threads(1)

B, R, D = 8, 4, 2
VAL = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _system(seed):
    rng = np.random.default_rng(seed)
    t = np.arange(R, dtype=np.float32)
    helix = np.stack([np.cos(0.9 * t), np.sin(0.9 * t), 0.4 * t], -1)
    cg = (helix + 0.25 * rng.normal(size=(B, R, 3))).astype(np.float32)
    info = np.broadcast_to((t / R)[None, :, None], (B, R, 1)).astype(
        np.float32)
    x = rng.uniform(-np.pi, np.pi, size=(B, R, D)).astype(np.float32)
    return cg, info, x


def _models(embedding):
    jm = JJoint.create(jax.random.PRNGKey(1), dofs_per_residue=D,
                       cg_info_dim=1,
                       decoder_dist=JBlockwise.create(D, "von_mises"),
                       embed_dim=6, prefix_dim=4, cutoff=4.0,
                       max_included=4, mapping_hidden=16,
                       embedding=embedding)
    return jm, from_jax(jm, "cpu")


@pytest.mark.parametrize("embedding", ["schnet", "attention"])
def test_joint_log_prob_and_gradients_match_jax(embedding):
    jm, tm = _models(embedding)
    assert isinstance(tm, JointBackmapping)
    cg, info, x = _system(2)

    def jloss(m):
        return -jnp.mean(m(jnp.asarray(cg), jnp.asarray(info)).log_prob(
            jnp.asarray(x)))

    jlp = jax.jit(lambda m: m(jnp.asarray(cg), jnp.asarray(info)).log_prob(
        jnp.asarray(x)))(jm)
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jm)
    dist = tm(torch.tensor(cg), torch.tensor(info))
    assert isinstance(dist, JointBackmappingDistribution)
    assert dist.batch_shape == (B,) and dist.event_shape == (R, D)
    lp = dist.log_prob(torch.tensor(x))
    np.testing.assert_allclose(lp.detach().numpy(), np.asarray(jlp), **VAL)
    loss = -lp.mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), **VAL)
    pairs = [(tm.residue_encoder.kernel, jg.residue_encoder.kernel),
             (tm.mapping.head.kernel, jg.mapping.head.kernel),
             (tm.mapping.layers[0].kernel, jg.mapping.layers[0].kernel),
             (tm.cg_embed.embed.info_net.kernel,
              jg.cg_embed.embed.info_net.kernel)]
    for i, (tp, jp) in enumerate(pairs):
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jp),
                                   err_msg=f"grad {i}", **GRAD)


@pytest.mark.parametrize("embedding", ["schnet", "attention"])
def test_contexts_are_causal(embedding):
    _, tm = _models(embedding)
    cg, info, x = _system(3)
    dist = tm(torch.tensor(cg), torch.tensor(info))
    env = dist._env_contexts()
    base = dist._contexts(torch.tensor(x), env)
    rng = np.random.default_rng(3)
    for r in range(R):
        moved = x.copy()
        moved[:, r:] += rng.normal(size=moved[:, r:].shape).astype(np.float32)
        ctx = dist._contexts(torch.tensor(moved), env)
        torch.testing.assert_close(ctx[:, :r + 1], base[:, :r + 1],
                                   atol=0, rtol=0)
        if r + 1 < R:
            assert not torch.equal(ctx[:, r + 1:], base[:, r + 1:])


def test_sample_shape_and_generator_determinism():
    _, tm = _models("schnet")
    cg, info, _ = _system(4)
    dist = tm(torch.tensor(cg), torch.tensor(info))
    a = dist.sample(torch.Generator().manual_seed(7))
    b = dist.sample(torch.Generator().manual_seed(7))
    c = dist.sample(torch.Generator().manual_seed(8))
    assert a.shape == (B, R, D)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool(torch.isfinite(dist.log_prob(a)).all())
    assert float(a.detach().abs().max()) <= np.pi + 1e-6
    many = dist.sample(torch.Generator().manual_seed(7), (3,))
    assert many.shape == (3, B, R, D)
    torch.testing.assert_close(many[0], a, atol=0, rtol=0)


def test_create_builds_both_embeddings_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    for embedding in ("schnet", "attention"):
        m = JointBackmapping.create(
            g, D, 1, IndependentBlockwise.create(D, "von_mises"),
            embed_dim=12, prefix_dim=8, cutoff=4.0, max_included=4,
            embedding=embedding, device="cpu")
        assert all(p.device.type == "cpu" for p in m.parameters())
    with pytest.raises(ValueError, match="embedding"):
        JointBackmapping.create(g, D, 1, IndependentBlockwise.create(D),
                                embedding="gnn", device="cpu")

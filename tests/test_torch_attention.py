"""The port's geometric-algebra attention and its pair-attention module
against the JAX package, on the CPU.

JAX layers are built at small widths (N <= 8 particles, hidden <= 16),
their biases and LayerNorm parameters moved off their zero/one init, and
carried into the port with ``convert.from_jax``.  Inputs come from
``numpy.random.default_rng``.  The JAX pair grid runs as its own tests
run it: the XLA path ``VectorAttention._xla_call`` and the Pallas kernel
in interpret mode (``_va_fused_impl(..., interpret=True)``).  Float32;
tolerances rtol 1e-5 / atol 1e-6 (the one tests/test_attention_pallas.py
holds the Pallas kernel to) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.nn import attention as ja
from vaemolsim_tpu.nn.core import LayerNorm as JLayerNorm
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.nn import attention as ta
from vaemolsim_tpu_torch.nn.core import LayerNorm
from vaemolsim_tpu_torch.ops import attention as tops

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def perturbed(obj, seed):
    """The JAX pytree with noise of 0.1 on every leaf (biases leave 0,
    LayerNorm gains leave 1)."""
    leaves, tree = jax.tree_util.tree_flatten(obj)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(tree, [
        leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
        for leaf in leaves])


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(0)
    c = (1.3 * rng.normal(size=(4, 6, 3))).astype(np.float32)
    v = rng.normal(size=(4, 6, 5)).astype(np.float32)
    mask = rng.random((4, 6)) > 0.3
    mask[0] = True
    return c, v, mask


def test_pair_invariants_match_jax(cloud):
    c = cloud[0]
    np.testing.assert_allclose(ta.pair_invariants(t(c)).numpy(),
                               np.asarray(ja.pair_invariants(j(c))), **TOL)


def test_layer_norm_uses_keras_eps_and_biased_variance():
    """Against the JAX LayerNorm, and against torch's at eps 1e-3 (its
    default 1e-5 would differ visibly at this small variance)."""
    rng = np.random.default_rng(1)
    x = (0.02 * rng.normal(size=(7, 12))).astype(np.float32)
    jln = perturbed(JLayerNorm.create(12), 2)
    tln = from_jax(jln, "cpu")
    assert tln.eps == 1e-3
    got = tln(t(x)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(jln(j(x))), **TOL)
    want = torch.nn.functional.layer_norm(t(x), (12,), tln.scale.detach(),
                                          tln.offset.detach(), eps=1e-3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert (got - torch.nn.functional.layer_norm(
        t(x), (12,), tln.scale.detach(), tln.offset.detach())
            ).abs().max() > 1e-2
    assert isinstance(LayerNorm.create(3, device="cpu"), torch.nn.Module)


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("masked", [True, False])
def test_pair_attention_plain_matches_xla_and_pallas(cloud, reduce, masked):
    """The port's kernel route (on the CPU: the plain version of the
    kernel) and its plain path, against the JAX XLA path and the Pallas
    kernel in interpret mode; no launch counted."""
    c, v, mask = cloud
    jattn = perturbed(ja.VectorAttention.create(
        jax.random.PRNGKey(1), 5, 7, hidden_dim=16, reduce=reduce), 3)
    tattn = from_jax(jattn, "cpu")
    assert tattn.kernel_wiring
    m = mask if masked else None
    want = np.asarray(jattn._xla_call(j(c), j(v), None if m is None
                                      else jnp.asarray(m)))
    mf = mask.astype(np.float32) if masked else np.ones((4, 6), np.float32)
    pallas = np.asarray(ja._va_fused_impl(jattn, j(c), j(v), j(mf),
                                          interpret=True))
    _build.reset_launches()
    with torch.no_grad():
        grid = tattn.pair_grid(t(c), t(v), t(mf)).numpy()
        routed = tattn(t(c), t(v), None if m is None
                       else torch.tensor(m)).numpy()
        plain = tattn.plain_call(t(c), t(v), None if m is None
                                 else torch.tensor(m)).numpy()
    assert grid.shape == want.shape == ((4, 7) if reduce else (4, 6, 7))
    for got in (grid, routed, plain):
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose(got, pallas, **TOL)
    assert _build.launch_counts()["pair_attention"] == 0


@pytest.mark.parametrize("reduce", [False, True])
def test_fully_masked_row_and_cloud_give_exact_zeros(cloud, reduce):
    c, v, _ = cloud
    jattn = perturbed(ja.VectorAttention.create(
        jax.random.PRNGKey(2), 5, 7, hidden_dim=16, reduce=reduce), 4)
    tattn = from_jax(jattn, "cpu")
    mask = np.asarray([[1, 1, 0, 0, 0, 0]] * 3 + [[0] * 6], bool)
    want = np.asarray(jattn._xla_call(j(c), j(v), jnp.asarray(mask)))
    with torch.no_grad():
        (c_, *nodes, mf, weights), kw = tattn.pair_args(
            t(c), t(v), t(mask.astype(np.float32)))
        got = tops.pair_attention_plain(c_, *nodes, mf, *weights,
                                        **kw).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[3]).max() == 0.0
    if not reduce:
        assert np.abs(got[:3, 2:]).max() == 0.0


def _embedding_pair(seed, mask_zero=True):
    jemb = perturbed(ja.ParticleEmbedding.create(
        jax.random.PRNGKey(seed), info_dim=2, embedding_dim=6, hidden_dim=8,
        num_blocks=2, mask_zero=mask_zero), seed + 10)
    return jemb, from_jax(jemb, "cpu")


def _particles(seed, B=3, N=7):
    rng = np.random.default_rng(seed)
    c = (1.2 * rng.normal(size=(B, N, 3))).astype(np.float32)
    info = rng.normal(size=(B, N, 2)).astype(np.float32)
    c[0, -2:] = 0.0   # padding rows, as DistanceSelection leaves them
    c[2] = 0.0        # an empty neighbourhood
    return c, info


@pytest.mark.parametrize("case", ["block", "mask_zero", "explicit_mask",
                                  "no_mask"])
def test_attention_block_and_embedding_match_jax(case):
    c, info = _particles(5)
    if case == "block":
        jblk = perturbed(ja.AttentionBlock.create(jax.random.PRNGKey(6), 6,
                                                  hidden_dim=8), 7)
        tblk = from_jax(jblk, "cpu")
        emb = np.random.default_rng(8).normal(size=(3, 7, 6)).astype(
            np.float32)
        mask = np.any(c != 0.0, -1)
        want = jblk(j(c), j(emb), jnp.asarray(mask))
        with torch.no_grad():
            got = tblk(t(c), t(emb), torch.tensor(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    jemb, temb = _embedding_pair(9, mask_zero=case != "no_mask")
    mask = None
    if case == "explicit_mask":
        mask = np.random.default_rng(10).random((3, 7)) > 0.4
    want = jemb(j(c), j(info), None if mask is None else jnp.asarray(mask))
    with torch.no_grad():
        got = temb(t(c), t(info), None if mask is None
                   else torch.tensor(mask))
    assert got.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "mask_zero":
        assert float(got[2].abs().max()) == 0.0


def _rotation(seed):
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return torch.tensor(q, dtype=torch.float32)


def test_rotation_invariance_and_permutation_symmetry():
    """Rotating every frame leaves the embedding (and an equivariant
    block's output) unchanged; permuting particles permutes the block's
    output and leaves the embedding unchanged: 1e-5 + 1e-5|v| (float32
    sums in another order)."""
    c, info = _particles(11, B=4, N=8)
    c[2] = 1.0  # no padding in this frame
    jemb, temb = _embedding_pair(12)
    R = _rotation(13)
    perm = torch.tensor(np.random.default_rng(14).permutation(8))
    tc, ti = t(c), t(info)
    with torch.no_grad():
        base = temb(tc, ti)
        rot = temb(tc @ R.T, ti)
        per = temb(tc[:, perm], ti[:, perm])
        emb = temb.info_net(ti)
        mask = (tc != 0.0).any(-1)
        blk = temb.blocks[0](tc, emb, mask)
        blk_rot = temb.blocks[0](tc @ R.T, emb, mask)
        blk_per = temb.blocks[0](tc[:, perm], emb[:, perm], mask[:, perm])
    for a, b in ((rot, base), (per, base), (blk_rot, blk),
                 (blk_per, blk[:, perm])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_embedding_gradients_match_jax():
    """Gradients of sum(embedding^2) for every parameter of a 2-block
    embedding, against jax.grad of the JAX one (its kernel route's
    custom_vjp recomputes through XLA): by autograd through the port's
    CPU route, and through the kernel route's recompute
    (``_build.call_with_plain_grad``, the plain version standing in for
    the kernel).  1e-5 + 1e-4|g| (sums over the grid in another
    order)."""
    c, info = _particles(15)
    jemb, temb = _embedding_pair(16)
    jgrad = jax.grad(lambda m: jnp.sum(m(j(c), j(info)) ** 2))(jemb)
    want = [p.detach() for p in from_jax(jgrad, "cpu").parameters()]

    def plain_no_grad(*a, **kw):
        with torch.no_grad():
            return tops.pair_attention_plain(*a, **kw)

    def through_recompute(coords, ni_s, nj_s, ni_v, nj_v, mask, weights,
                          **kw):
        return _build.call_with_plain_grad(
            lambda *ts: plain_no_grad(*ts, **kw),
            lambda *ts: tops.pair_attention_plain(*ts, **kw),
            coords, ni_s, nj_s, ni_v, nj_v, mask, *weights)

    routes = {"cpu": ta.pair_attention, "recompute": through_recompute}
    for name, route in routes.items():
        ta.pair_attention = route
        try:
            params = list(temb.parameters())
            got = torch.autograd.grad((temb(t(c), t(info)) ** 2).sum(),
                                      params)
        finally:
            ta.pair_attention = routes["cpu"]
        assert len(got) == len(want) == 2 + 2 * 16 + 10
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5,
                                       msg=lambda m: f"{name}: {m}")


def test_other_wirings_take_the_plain_path():
    """An activation on value_net.d1, or different activations in the
    two nets, is not the kernel's wiring; such a layer still matches the
    JAX XLA path."""
    c, v, mask = (np.random.default_rng(17).normal(size=s).astype(np.float32)
                  for s in ((2, 5, 3), (2, 5, 4), (2, 5)))
    jattn = perturbed(ja.VectorAttention.create(jax.random.PRNGKey(18), 4,
                                                3, hidden_dim=8), 19)
    jattn = jattn.replace(value_net=jattn.value_net.replace(
        d1=jattn.value_net.d1.replace(activation="tanh")))
    tattn = from_jax(jattn, "cpu")
    assert not tattn.kernel_wiring
    m = mask > 0
    with torch.no_grad():
        got = tattn(t(c), t(v), torch.tensor(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jattn(j(c), j(v), jnp.asarray(m))), **TOL)
    tattn.value_net.d1.activation = None
    tattn.value_net.activation = "tanh"
    assert not tattn.kernel_wiring
    tattn.score_net.d1.activation = "tanh"
    assert tattn.kernel_wiring

"""The port's MAF-block module and a D=3 MAF flow against the JAX
package, on the CPU.

The JAX side runs as its own tests run it: the plain XLA reference
``_xla_reference`` and the Pallas kernel in interpret mode.  Merged block
weights come from a JAX ``MaskedSplineConditioner`` (hidden 32, 8 bins on
[-4, 4]), scaled so that the bins have contrast, and go to both packages
as the same numpy arrays.  Float32 throughout; each tolerance is stated
with its reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.dists import StaticFlowedDistribution as JStatic
from vaemolsim_tpu.flows import RQSSplineMAF as JMAF
from vaemolsim_tpu.flows import spline_flows as jsf
from vaemolsim_tpu.models import FlowModel as JFlowModel
from vaemolsim_tpu.ops import distributions as jd
from vaemolsim_tpu.ops import maf_fused as jmf
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.convert import from_jax
from vaemolsim_tpu_torch.ops import maf_fused as tmf

torch.set_num_threads(1)

K, HIDDEN, BIN_MIN, BIN_MAX = 8, 32, -4.0, 4.0


def t(a):
    return torch.tensor(np.asarray(a, np.float32))


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def block_params(seed, D, cond_dim=None):
    """Merged (k1, b1, k2, b2[, c1, c2]) of a JAX block as numpy arrays:
    weights doubled (the default init gives near-uniform bins) and biases
    made non-zero; the masks' zeros stay zeros."""
    cond = jsf.MaskedSplineConditioner.create(
        jax.random.PRNGKey(seed), D, bin_range=(BIN_MIN, BIN_MAX),
        num_bins=K, hidden_dim=HIDDEN, conditional=cond_dim is not None,
        conditional_event_shape=cond_dim, input_order="left-to-right")
    rng = np.random.default_rng(seed)
    out = []
    for i, p in enumerate(cond.merged_params()):
        if p is None:
            continue
        p = np.asarray(p, np.float32)
        out.append(p + 0.2 * rng.normal(size=p.shape).astype(np.float32)
                   if i in (1, 3) else 2.0 * p)
    return out


def inputs(seed, n, D, cond_dim):
    rng = np.random.default_rng(100 + seed)
    # 2.5 standard deviations reach both identity tails of [-4, 4].
    y = (2.5 * rng.normal(size=(n, D))).astype(np.float32)
    ctx = (rng.normal(size=(n, cond_dim)).astype(np.float32)
           if cond_dim else None)
    return y, ctx


CASES = [  # (D, context width, rows, inverse)
    (1, None, 64, True), (1, None, 64, False),
    (3, None, 64, True), (3, None, 64, False),
    (3, 5, 40, True), (3, 5, 40, False),
    (2, None, 777, True),
]


@pytest.mark.parametrize("D,cond_dim,n,inverse", CASES)
def test_maf_block_plain_matches_jax(D, cond_dim, n, inverse):
    """Against the XLA reference and the Pallas kernel in interpret mode
    (N = 777 is not a multiple of its 512-row tile): 1e-5 on values and
    log-dets, the tolerance tests/test_maf_fused.py holds the Pallas
    kernel to."""
    params = block_params(D + (cond_dim or 0), D, cond_dim)
    y, ctx = inputs(D, n, D, cond_dim)
    jctx = None if ctx is None else j(ctx)
    jparams = tuple(j(p) for p in params)
    want = jmf._xla_reference(j(y), jparams, jctx, D, K, BIN_MIN, BIN_MAX,
                              inverse, jnp.float32)
    fused = (jmf.maf_block_inverse_fused if inverse
             else jmf.maf_block_forward_fused)
    pallas = fused(j(y), jparams, jctx, D, K, BIN_MIN, BIN_MAX, jnp.float32,
                   True)
    _build.reset_launches()
    with torch.no_grad():
        got = (tmf.maf_block_inverse_fused if inverse
               else tmf.maf_block_forward_fused)(
            t(y), [t(p) for p in params], None if ctx is None else t(ctx),
            D, K, BIN_MIN, BIN_MAX)
    assert got[0].shape == (n, D) and got[1].shape == (n,)
    for g, w, p in zip(got, want, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=1e-5,
                                   rtol=1e-5)
    assert _build.launch_counts()["maf_block"] == 0


@pytest.mark.parametrize("inverse,cond_dim", [(True, None), (False, None),
                                              (True, 5)])
def test_maf_block_gradients_match_jax(inverse, cond_dim):
    """Gradients of sum(x^2) + sum(ldj) with respect to y, every merged
    parameter and the context: the port's entry on the CPU (autograd
    through the plain version) and its kernel route's recompute
    (``_PlainGrad``, with the plain version in the kernel's place),
    against jax.grad of the JAX entry in interpret mode (its custom_vjp
    recomputes through XLA): 1e-5, as tests/test_maf_fused.py."""
    D = 2 if cond_dim is None else 3
    params = block_params(7 + D, D, cond_dim)
    y, ctx = inputs(7, 16, D, cond_dim)
    fused = (jmf.maf_block_inverse_fused if inverse
             else jmf.maf_block_forward_fused)

    def jloss(y_, params_, ctx_):
        x, ldj = fused(y_, params_, ctx_, D, K, BIN_MIN, BIN_MAX,
                       jnp.float32, True)
        return jnp.sum(x ** 2) + jnp.sum(ldj)

    jctx = None if ctx is None else j(ctx)
    argnums = (0, 1) if ctx is None else (0, 1, 2)
    want = jax.grad(jloss, argnums=argnums)(j(y), tuple(j(p) for p in params),
                                            jctx)
    want = [want[0], *want[1]] + ([want[2]] if ctx is not None else [])

    def plain_no_grad(*a):
        with torch.no_grad():
            return tmf.maf_block_plain(*a)

    entry = (tmf.maf_block_inverse_fused if inverse
             else tmf.maf_block_forward_fused)
    routes = {
        "entry": lambda y_, p_, c_: entry(y_, p_, c_, D, K, BIN_MIN,
                                          BIN_MAX),
        "plain_grad": lambda y_, p_, c_: tmf._call(
            plain_no_grad, y_, p_, c_, D, K, BIN_MIN, BIN_MAX, inverse),
    }
    for name, route in routes.items():
        ty = t(y).requires_grad_()
        tp = [t(p).requires_grad_() for p in params]
        tc = None if ctx is None else t(ctx).requires_grad_()
        x, ldj = route(ty, tp, tc)
        leaves = [ty, *tp] + ([tc] if tc is not None else [])
        got = torch.autograd.grad((x ** 2).sum() + ldj.sum(), leaves)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                       rtol=1e-5, err_msg=name)


def test_d3_three_block_maf_carried_by_from_jax():
    """A D=3, 3-block RQSSplineMAF flow model (middle block in a seeded
    random order, biases non-zero) after from_jax: every block's input
    order, log_prob at shared points (sums of three O(1) log-dets over a
    normal base) and the sampling map at shared base draws, to 1e-5."""
    flow = JMAF.create(jax.random.PRNGKey(31), 3, num_blocks=3,
                       order_seed=9,
                       rqs_params={"num_bins": K, "hidden_dim": HIDDEN,
                                   "bin_range": [BIN_MIN, BIN_MAX]})
    jmodel = JFlowModel(flowed_dist=JStatic(
        flow=flow, base=jd.Independent(jd.Normal(jnp.zeros(3),
                                                  jnp.ones(3)), 1)))
    leaves, tree = jax.tree_util.tree_flatten(jmodel)
    rng = np.random.default_rng(32)
    leaves = [leaf + 0.1 * rng.normal(size=leaf.shape).astype(np.float32)
              if leaf.ndim == 1 and leaf.size > 3 else leaf
              for leaf in leaves]
    jmodel = jax.tree_util.tree_unflatten(tree, leaves)
    tmodel = from_jax(jmodel, "cpu")
    orders = [tuple(b.conditioner.w_net.input_order_static)
              for b in tmodel.flowed_dist.flow.blocks]
    assert orders == [tuple(b.conditioner.w_net.input_order_static)
                      for b in jmodel.flowed_dist.flow.blocks]
    assert orders[0] == (3, 2, 1) and orders[2] == (1, 2, 3)
    y = (1.5 * rng.normal(size=(301, 3))).astype(np.float32)
    with torch.no_grad():
        got = tmodel.log_prob(t(y)).numpy()
        tb = tmodel(t(y)).bijector
        tx, tl = tb.forward_and_log_det(t(y))
    np.testing.assert_allclose(got, np.asarray(jmodel.log_prob(j(y))),
                               atol=1e-5, rtol=1e-5)
    jx, jl = jmodel(j(y)).bijector.forward_and_log_det(j(y))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                               rtol=1e-5)

"""Second derivatives through the port's kernel routes, against JAX on
the CPU.

A kernel route differentiates by recomputing its plain version
(``_build._PlainGrad``) or, for the cell-list energy, by scaling the
gradient its kernel returned (``potentials._CellEnergy``).  Under
``create_graph=True`` both must hand back a gradient that is itself
differentiable, so that a Hessian-vector product sees the kernel's term
(the JAX package's XLA routes, its defaults, differentiate twice).  The
CPU wrappers never take ``_PlainGrad``, so these tests call it directly,
with the plain version standing in for the kernel.  Inputs come from
numpy seeds; float32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu import potentials as jp
from vaemolsim_tpu.ops import fused_mlp as jfm
from vaemolsim_tpu.ops import maf_fused as jmf
from vaemolsim_tpu.flows import spline_flows as jsf
from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch import potentials as tp
from vaemolsim_tpu_torch.ops import fused_mlp as tfm
from vaemolsim_tpu_torch.ops import maf_fused as tmf

torch.set_num_threads(1)


def t(a, requires_grad=False):
    return torch.tensor(np.asarray(a, np.float32),
                        requires_grad=requires_grad)


def j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def no_grad(fn):
    def run(*a, **k):
        with torch.no_grad():
            return fn(*a, **k)
    return run


def test_plain_grad_second_derivative_probe():
    """f = sum(x^3) through _PlainGrad, plus q = sum(x^2) outside it, at
    x = (1, 2): d/dx sum(grad) = 6x + 2 = (8, 14), as jax.grad of
    jax.grad gives; the kernel term alone differentiates twice too."""
    def f(x):
        return (x ** 3).sum()

    x = torch.tensor([1.0, 2.0], requires_grad=True)
    y = _build._PlainGrad.apply(no_grad(f), f, x) + (x ** 2).sum()
    (g,) = torch.autograd.grad(y, x, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), x)
    want = jax.grad(lambda v: jnp.sum(jax.grad(
        lambda u: jnp.sum(u ** 3) + jnp.sum(u ** 2))(v)))(j([1.0, 2.0]))
    np.testing.assert_array_equal(gg.numpy(), [8.0, 14.0])
    np.testing.assert_allclose(gg.numpy(), np.asarray(want), rtol=1e-6)
    (g1,) = torch.autograd.grad(_build._PlainGrad.apply(no_grad(f), f, x), x,
                                create_graph=True)
    (gg1,) = torch.autograd.grad(g1.sum(), x)
    np.testing.assert_array_equal(gg1.numpy(), [6.0, 12.0])


def test_plain_grad_first_order_keeps_no_graph():
    """Without create_graph the gradient is a plain tensor, as before."""
    def f(x):
        return (x ** 3).sum()

    x = torch.tensor([1.0, 2.0], requires_grad=True)
    (g,) = torch.autograd.grad(_build._PlainGrad.apply(no_grad(f), f, x), x)
    assert not g.requires_grad
    np.testing.assert_array_equal(g.numpy(), [3.0, 12.0])


def _hvp(loss_of, leaves, vs):
    grads = torch.autograd.grad(loss_of(*leaves), leaves, create_graph=True)
    dot = sum((g * v).sum() for g, v in zip(grads, vs))
    return [h.numpy() for h in torch.autograd.grad(dot, leaves)]


def _jax_hvp(loss_of, leaves, vs):
    grad = jax.grad(loss_of, argnums=tuple(range(len(leaves))))
    _, out = jax.jit(lambda a, b: jax.jvp(grad, a, b))(tuple(leaves),
                                                       tuple(vs))
    return [np.asarray(o) for o in out]


def test_dense_stack_route_hessian_vector_product():
    """A 3 -> 16 -> 5 tanh stack with a 2-wide conditional input through
    the dense-stack route (``fused_mlp._call``, the plain version in the
    kernel's place): the Hessian-vector product of sum(out^2) in x, every
    weight and the conditional input, against jax.jvp of jax.grad of
    ``dense_stack_xla``.  Float32 sums of up to 16 terms in another
    order: 1e-5 + 1e-4 relative."""
    rng = np.random.default_rng(0)
    dims, dc, n = [3, 16, 5], 2, 24
    ks = [rng.normal(size=(a, b)) / np.sqrt(a)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * rng.normal(size=b) for b in dims[1:]]
    cks = [0.3 * rng.normal(size=(dc, b)) for b in dims[1:]]
    x, c = rng.normal(size=(n, dims[0])), rng.normal(size=(n, dc))
    leaves = [x, *ks, *bs, c, *cks]
    vs = [rng.normal(size=np.shape(a)) for a in leaves]
    acts = ["tanh", None]

    def torch_loss(x_, k0, k1, b0, b1, c_, c0, c1):
        out = tfm._call(no_grad(tfm.dense_stack_plain), x_, [k0, k1],
                        [b0, b1], acts, c_, [c0, c1])
        return (out ** 2).sum()

    def jax_loss(x_, k0, k1, b0, b1, c_, c0, c1):
        out = jfm.dense_stack_xla(x_, [k0, k1], [b0, b1], acts, c_, [c0, c1])
        return jnp.sum(out ** 2)

    got = _hvp(torch_loss, [t(a, True) for a in leaves], [t(v) for v in vs])
    want = _jax_hvp(jax_loss, [j(a) for a in leaves], [j(v) for v in vs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("inverse", [True, False])
def test_maf_block_route_hessian_vector_product(inverse):
    """A D = 3 MAF block with a 2-wide context (hidden 16, 8 bins on
    [-4, 4]) through the MAF-block route (``maf_fused._call``, the plain
    version in the kernel's place): the Hessian-vector product of
    sum(x^2) + sum(ldj) in y, the merged weights and the context, against
    jax.jvp of jax.grad of ``_xla_reference``.  Second derivatives of the
    spline through its bins: 1e-4 + 1e-3 relative."""
    D, C, K, n = 3, 2, 8, 16
    cond = jsf.MaskedSplineConditioner.create(
        jax.random.PRNGKey(3), D, bin_range=(-4.0, 4.0), num_bins=K,
        hidden_dim=16, conditional=True, conditional_event_shape=C)
    rng = np.random.default_rng(1)
    params = [np.asarray(p, np.float32) for p in cond.merged_params()]
    y, ctx = 1.5 * rng.normal(size=(n, D)), rng.normal(size=(n, C))
    leaves = [y, *params, ctx]
    vs = [rng.normal(size=np.shape(a)) * (np.asarray(a) != 0)
          for a in leaves]

    def torch_loss(y_, *rest):
        ps, c_ = list(rest[:-1]), rest[-1]
        x, ldj = tmf._call(no_grad(tmf.maf_block_plain), y_, ps, c_, D, K,
                           -4.0, 4.0, inverse)
        return (x ** 2).sum() + ldj.sum()

    def jax_loss(y_, *rest):
        ps, c_ = tuple(rest[:-1]), rest[-1]
        x, ldj = jmf._xla_reference(y_, ps, c_, D, K, -4.0, 4.0, inverse,
                                    jnp.float32)
        return jnp.sum(x ** 2) + jnp.sum(ldj)

    got = _hvp(torch_loss, [t(a, True) for a in leaves], [t(v) for v in vs])
    want = _jax_hvp(jax_loss, [j(a) for a in leaves], [j(v) for v in vs])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-3)


def test_cell_list_energy_hessian_vector_product():
    """The cell-list LJ energy plus sum(x^2) on 128 atoms (box 10, cutoff
    2.5, skin 0.5, capacity 32, on the CPU through ``_CellEnergy``): its
    gradient and its Hessian-vector product along a random direction
    against JAX's dense O(N^2) ``lennard_jones``, 1e-5 of the largest
    component (sums over up to 27 C candidates in another order)."""
    rng = np.random.default_rng(2)
    n, L = 128, 10.0
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    x = ((g + 0.5) * (L / 6) + 0.1 * rng.normal(size=(n, 3))).astype(
        np.float32)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    build, energy = tp.lennard_jones_cell_neighbor(
        box=[L] * 3, cutoff=2.5, skin=0.5, capacity=32, device="cpu")
    xt = t(x, True)
    nl = build(xt.detach())
    (gr,) = torch.autograd.grad(energy(nl, xt) + (xt ** 2).sum(), xt,
                                create_graph=True)
    (hv,) = torch.autograd.grad((gr * t(v)).sum(), xt)
    dense = jp.lennard_jones(box=[L] * 3, cutoff=2.5)

    def f(y):
        return dense(y) + jnp.sum(y ** 2)

    want_g, want_hv = (np.asarray(a) for a in jax.jit(
        lambda y, w: jax.jvp(jax.grad(f), (y,), (w,)))(j(x), j(v)))
    np.testing.assert_allclose(gr.detach().numpy(), want_g,
                               atol=1e-5 * np.abs(want_g).max(), rtol=0)
    np.testing.assert_allclose(hv.numpy(), want_hv,
                               atol=1e-5 * np.abs(want_hv).max(), rtol=0)
    # The Sigma x^2 term alone is 2v: the energy's share is really there.
    assert np.abs(want_hv - 2 * v).max() > 1.0


def test_cell_list_second_derivative_keeps_the_nan_contract():
    """A drifted list gives a NaN gradient under create_graph too."""
    build, energy = tp.lennard_jones_cell_neighbor(
        box=[10.0] * 3, cutoff=2.5, skin=0.5, capacity=32, device="cpu")
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    x = t(g * 2.5 + 0.5, True)
    nl = build(x.detach())
    moved = x + torch.tensor([1.0, 0.0, 0.0])
    (gr,) = torch.autograd.grad(energy(nl, moved), x, create_graph=True)
    assert bool(torch.isnan(gr).all())

"""Kernels 1 and 2's member axis on the CPU: the wrappers' layouts and
launch plans, with the C kernels emulated from their launch arguments.

The CUDA kernels run only on the card.  Here each kernel's C entry
(``_build.Kernel._fn``, one entry that takes a member count) is replaced
by an emulation in PyTorch that reads
its inputs from the launch's pointers (CPU memory), checks the plan the
wrapper computed as ``csrc/*.cu`` checks it, applies the C source's
indexing rule (member m's rows through member m's weights; kernel 1's
element i of member m through row m * P + i % P) with the plain version
of each member, and writes the outputs where the kernel would.  So these
tests hold the Python around the launches (shapes, strides, parameter
rows, the vmap rule of ``_build._PlainGrad``, the launch counts) and
leave the kernels' arithmetic to the card tests.

Then ``fit_ensemble`` of example 09's flows (small) runs through the
kernel routes under one ``torch.func.vmap`` (the card's route, forced on
the CPU): one member-batched launch of each kernel per block and step,
and the losses of the plain CPU route.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from vaemolsim_tpu_torch import _build, members as tmembers
from vaemolsim_tpu_torch.dists import StaticFlowedDistribution
from vaemolsim_tpu_torch.flows import RQSSplineRealNVP
from vaemolsim_tpu_torch.ops import distributions as dist
from vaemolsim_tpu_torch.ops import fused_mlp, rqs
from vaemolsim_tpu_torch.train import fit_ensemble, loop, stack_models

torch.set_num_threads(1)

INVALID = 1  # cudaErrorInvalidValue


def _view(ptr, count):
    """``count`` floats at host address ``ptr`` as a writable tensor."""
    buf = (ctypes.c_float * count).from_address(ptr)
    return torch.from_numpy(np.ctypeslib.as_array(buf))


def dense_entry(x, c, out, n, n_layers, dims, acts, W, b, C, dc, members,
                stream):
    dims = [dims[i] for i in range(n_layers + 1)]
    names = {0: None, 1: "tanh", 2: "relu", 3: "gelu"}
    acts = [names[acts[i]] for i in range(n_layers)]
    if not 1 <= members <= 65535:
        return INVALID
    X = _view(x, members * n * dims[0]).view(members, n, dims[0])
    O = _view(out, members * n * dims[-1]).view(members, n, dims[-1])
    Cx = _view(c, members * n * dc).view(members, n, dc) if c else None
    for m in range(members):
        def blk(ptrs, i, rows, cols):
            return _view(ptrs[i], members * rows * cols).view(
                members, rows, cols)[m]
        ks = [blk(W, i, dims[i], dims[i + 1]) for i in range(n_layers)]
        bs = [blk(b, i, 1, dims[i + 1])[0] for i in range(n_layers)]
        cks = ([blk(C, i, dc, dims[i + 1]) for i in range(n_layers)]
               if c else None)
        O[m] = fused_mlp.dense_stack_plain(X[m], ks, bs, acts,
                                           None if Cx is None else Cx[m],
                                           cks)
    return 0


def rqs_entry(x, w, h, s, y, ldj, n, K, p_rows, range_min, inverse,
              threads, blocks, smem, members, stream):
    row = p_rows == 1 and smem != 0
    elems = n if row else n * members
    want_smem = 4 * (rqs.table_floats(K) + 3 * K) if row else 0
    if (threads % 32 or not 32 <= threads <= 256 or smem != want_smem
            or blocks != -(-elems // threads) or members < 1):
        return INVALID
    X = _view(x, members * n).view(members, n)
    Y, L = (_view(p, members * n).view(members, n) for p in (y, ldj))
    Wt, Ht = (_view(p, members * p_rows * K).view(members, p_rows, K)
              for p in (w, h))
    St = _view(s, members * p_rows * (K - 1)).view(members, p_rows, K - 1)
    plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
    r = torch.arange(n) % p_rows          # element i reads row i % P
    for m in range(members):
        Y[m], L[m] = plain(X[m], Wt[m][r], Ht[m][r], St[m][r], range_min)
    return 0


class _Stream:
    cuda_stream = 0


@pytest.fixture
def emulated(monkeypatch):
    """Kernels 1 and 2's C entries emulated on the CPU; their wrappers'
    operand checks keep everything but the device."""
    def require(t, what, shape=None, dtype=torch.float32):
        assert t.dtype == dtype and t.is_contiguous(), what
        if shape is not None:
            assert tuple(t.shape) == tuple(shape), (what, t.shape, shape)
        return t

    monkeypatch.setattr(_build, "require", require)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _Stream())
    for kernel, entry in ((fused_mlp.KERNEL, dense_entry),
                          (rqs.KERNEL, rqs_entry)):
        monkeypatch.setattr(kernel, "_fn", entry)
        monkeypatch.setattr(kernel, "_err", lambda rc: b"invalid value",
                            raising=False)
    _build.reset_launches()
    yield
    _build.reset_launches()


def weights(gen, dims, M, cond=0):
    ks = [torch.randn(M, a, b, generator=gen) / math.sqrt(a)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn(M, b, generator=gen) for b in dims[1:]]
    cks = ([0.3 * torch.randn(M, cond, b, generator=gen) for b in dims[1:]]
           if cond else None)
    return ks, bs, cks


@pytest.mark.parametrize("M,n,dims,acts,cond", [
    (8, 1, [1, 64, 47], ["tanh", None], 0),      # example 09's conditioner
    (3, 1024, [20, 40, 9], ["relu", None], 0),   # tiled regime
    (3, 200, [3, 5, 4], ["tanh", None], 2),      # streaming, conditional
    (2, 40, [900, 7], ["gelu"], 0),              # wide regime
    (2, 16, [4, 30, 30, 6], ["relu", "tanh", None], 3),  # small N
])
def test_dense_stack_member_launch(emulated, M, n, dims, acts, cond):
    """One launch for M stacks: each member's rows through its own
    weights (the plain version member by member, exactly), counted once
    in the kernel's "members" mode."""
    gen = torch.Generator().manual_seed(n + M)
    ks, bs, cks = weights(gen, dims, M, cond)
    x = torch.randn(M, n, dims[0], generator=gen)
    c = torch.randn(M, n, cond, generator=gen) if cond else None
    got = fused_mlp.dense_stack_members_cuda(x, ks, bs, acts, c, cks)
    assert got.shape == (M, n, dims[-1])
    for m in range(M):
        want = fused_mlp.dense_stack_plain(
            x[m], [k[m] for k in ks], [b[m] for b in bs], acts,
            None if c is None else c[m],
            None if cks is None else [k[m] for k in cks])
        assert torch.equal(got[m], want)
    assert fused_mlp.KERNEL.launches == 1
    assert fused_mlp.KERNEL.mode_launches == {"members": 1}


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("layout", ["broadcast", "per_element", "trailing"])
def test_rqs_member_launch(emulated, inverse, layout):
    """One launch for M splines: one knot row a member (the table regime,
    members on the grid's second axis), a row per element and a row per
    trailing block (the walk, members folded into the elements): each
    member's values as the plain version's on that member's parameters."""
    M, K, n = 8, 16, 1024
    gen = torch.Generator().manual_seed(K)
    rows = {"broadcast": (1, 1), "per_element": (n, 1),
            "trailing": (1, 4)}[layout]
    x = torch.rand(M, n // 4, 4, generator=gen) * 14.0 - 7.0
    raw = [torch.randn((M,) + rows + (k,), generator=gen)
           for k in (K, K, K - 1)]
    if layout == "per_element":
        raw = [r.reshape(M, n // 4, 4, -1) for r in raw]
    from vaemolsim_tpu_torch.flows.spline_flows import (_bin_positions,
                                                        _slopes)
    p = (_bin_positions(raw[0], -5.0, 5.0, K),
         _bin_positions(raw[1], -5.0, 5.0, K), _slopes(raw[2]))
    y, ldj = rqs.rqs_members_cuda(x, *p, -5.0, inverse)
    plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
    for m in range(M):
        wy, wl = plain(x[m], *(q[m] for q in p), -5.0)
        torch.testing.assert_close(y[m], wy, rtol=0, atol=0)
        torch.testing.assert_close(ldj[m], wl, rtol=0, atol=0)
    assert rqs.KERNEL.mode_launches == {"members": 1}


def test_rqs_member_plans():
    """The table regime's blocks cover one member (members on the grid's
    second axis); the walk's cover all members' elements."""
    table = rqs.kernel_plan(1024, 16, 1, members=8)
    assert table["regime"] == "table"
    assert table["blocks"] * table["threads"] >= 1024
    assert (table["blocks"] - 1) * table["threads"] < 1024
    walk = rqs.kernel_plan(1024, 16, 1024, members=8)
    assert walk["regime"] == "walk" and walk["blocks"] == 8 * 1024 // 256


def flow(seed):
    base = dist.Independent(dist.Normal(torch.zeros(1), torch.ones(1)), 1)
    return StaticFlowedDistribution(RQSSplineRealNVP.create(
        torch.Generator().manual_seed(seed), 1, num_blocks=3,
        rqs_params={"num_bins": 16, "hidden_dim": 32,
                    "bin_range": [-5.0, 5.0]}, device="cpu"), base)


def test_fit_ensemble_through_the_member_launches(emulated, monkeypatch):
    """Example 09's route on the card, forced on the CPU: the flows'
    dense stacks and splines through the kernel routes, the K members as
    one vmap (no chunks).  Per step and block, one member-batched launch
    of each kernel and no other; the losses and trained weights are the
    plain route's (which takes the members one at a time) to float32
    rounding."""
    def forced_stack(x, kernels, biases, activations, cond=None,
                     cond_kernels=None):
        return fused_mlp._split_call(
            fused_mlp.dense_stack_cuda, x, kernels, biases, activations,
            cond, cond_kernels, fused_mlp.dense_stack_members_cuda)

    def forced_rqs(x, widths, heights, slopes, range_min, inverse):
        plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
        return _build.call_with_plain_grad(
            lambda *a: rqs.rqs_cuda(*a, range_min, inverse),
            lambda *a: plain(*a, range_min), x, widths, heights, slopes,
            member_fn=lambda *a: rqs.rqs_members_cuda(*a, range_min,
                                                      inverse))

    K, steps = 4, 3
    data = torch.randn(96, 1, generator=torch.Generator().manual_seed(9))
    loss = (lambda f, b, d: -f().log_prob(b).mean())
    plain, hist = fit_ensemble(
        stack_models([flow(40 + i) for i in range(K)]), loss, data,
        generator=torch.Generator().manual_seed(1), batch_size=32)
    assert _build.launch_counts()["rqs"] == 0
    monkeypatch.setattr(fused_mlp, "fused_dense_stack", forced_stack)
    monkeypatch.setattr(rqs, "_dispatch", forced_rqs)
    monkeypatch.setattr(loop, "member_chunk", lambda device: None)
    monkeypatch.setattr(tmembers, "member_chunk", lambda device: None)
    routed, rhist = fit_ensemble(
        stack_models([flow(40 + i) for i in range(K)]), loss, data,
        generator=torch.Generator().manual_seed(1), batch_size=32)
    counts = {k.name: dict(k.mode_launches) for k in
              (fused_mlp.KERNEL, rqs.KERNEL)}
    assert counts == {"dense_stack": {"members": 3 * steps},
                      "rqs": {"members": 3 * steps}}
    assert _build.launch_counts()["rqs"] == 3 * steps
    np.testing.assert_allclose(rhist["loss"][0], hist["loss"][0],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(routed.parameters(), plain.parameters()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_no_port_module_nor_chip_smoke_imports_jax():
    """A grep of every module of the port and of chip_smoke.py: no import
    of ``jax`` (or ``jaxlib``, ``optax``, ``flax``) nor of the JAX package
    ``vaemolsim_tpu``."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1]
    pattern = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|optax|flax|"
                         r"vaemolsim_tpu)(?:\.|\s|$|,)", re.M)
    files = sorted((root / "vaemolsim_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    assert len(files) > 50
    bad = [str(f.relative_to(root)) for f in files
           if pattern.search(f.read_text())]
    assert bad == []

"""Dense stacks: a whole MLP in one kernel (port of
``vaemolsim_tpu/ops/fused_mlp.py``).

:func:`fused_dense_stack` computes ``h = act(h @ W_i + b_i (+ c @ C_i))``
layer by layer.  Whether the kernel can take a stack is decided from the
arguments alone, as the JAX dispatch does: activations linear, tanh,
relu or gelu (its tanh form, ``jax.nn.gelu``'s default; the JAX kernel
takes the first three), and the float32 compute dtype.  Inside that set
a CUDA tensor runs ``csrc/dense_stack.cu``, whose gradient recomputes
through :func:`dense_stack_plain`; outside it, or on the CPU, the plain
version runs.  Weights keep the JAX ``(in, out)`` layout.

A stack the kernel cannot take in one launch is split, from its shapes
alone, before any launch (:func:`stack_runs`): into runs of at most
``_MAX_LAYERS`` layers, each the longest whose launch plan is not
refused, each one launch.  A single layer always has a plan: one too
wide for the tiled regime's shared memory (808 or more at more than 16
rows) takes the wide regime, a tiled matrix product.

Under ``torch.func.vmap`` (a member axis: ``fit_ensemble``'s K stacks,
each with its own weights) a CUDA stack launches once for all members
(:func:`dense_stack_members_cuda`, the grid's z axis), in the runs and
regimes of one member's shapes.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from vaemolsim_tpu_torch import _build

Tensor = torch.Tensor

__all__ = ["fused_dense_stack", "dense_stack_plain", "dense_stack_cuda",
           "dense_stack_members_cuda", "stack_regime", "stack_runs",
           "KERNEL"]

KERNEL = _build.Kernel(
    "dense_stack", "csrc/dense_stack.cu", "dense_stack_members_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int],
    replaces="vaemolsim_tpu/ops/fused_mlp.py:106")

_ACT_CODES = {None: 0, "linear": 0, "tanh": 1, "relu": 2, "gelu": 3}
# Mirrors of csrc/dense_stack.cu's limits (the kernel refuses the same
# cases itself): layers, the small-N regime's rows and cluster, the
# streaming regime's record widths, the tiled regime's shared-memory
# stride (32 rows + 4), and the sm_90 shared-memory limit.
_MAX_LAYERS = 8
_SMALL_ROWS = 16
_CLUSTER = 8
_STREAM_BUCKETS = ((4, 4), (8, 8))
_TILE_STRIDE = 36
_MAX_SMEM = 232448


def stack_regime(n: int, dims: Sequence[int], dc: int = 0
                 ) -> Tuple[str, int]:
    """The regime ``csrc/dense_stack.cu`` runs ``n`` rows of a stack of
    widths ``dims`` (input first) with a conditional input ``dc`` wide
    in, and its dynamic shared memory in bytes: ``"small"`` (n <= 16,
    one cluster of 8 blocks, each also holding its slice of the last
    layer's weights), ``"stream"`` (two layers, din + dc + 1 <= 8
    and dout <= 8, one thread per row), ``"tiled"`` (32-row tiles),
    or ``"refused"`` where none fits; the first that fits, in that
    order.  A single layer that none of them takes runs ``"wide"`` (a
    tiled matrix product, 64 x 64 output tiles, no dynamic shared
    memory)."""
    L = len(dims) - 1
    if n <= _SMALL_ROWS:
        slice_ = max([-(-d // _CLUSTER) for d in dims[1:L]], default=0)
        slab = -(-dims[L - 1] // _CLUSTER) * dims[L] if L > 1 else 0
        small = 4 * (n * (max(dims) + slice_ + dims[-1] + dc) + slab)
        if small <= _MAX_SMEM:
            return "small", small
    if L == 2:
        for k_in, k_out in _STREAM_BUCKETS:
            if dims[0] + dc + 1 <= k_in and dims[2] <= k_out:
                stream = 4 * dims[1] * (k_in + k_out)
                if stream <= _MAX_SMEM:
                    return "stream", stream
                break
    tiled = 4 * _TILE_STRIDE * (2 * max(dims) + dc)
    if tiled <= _MAX_SMEM:
        return "tiled", tiled
    return ("wide", 0) if L == 1 else ("refused", tiled)


def stack_runs(n: int, dims: Sequence[int], dc: int = 0
               ) -> List[Tuple[int, int]]:
    """How a stack of widths ``dims`` at ``n`` rows (conditional input
    ``dc`` wide) is split into launches: ``(first layer, end layer)``
    runs in order, each the longest run from ``first`` of at most
    ``_MAX_LAYERS`` layers whose plan is not refused (a single layer's
    never is)."""
    runs, lo, L = [], 0, len(dims) - 1
    while lo < L:
        hi = min(lo + _MAX_LAYERS, L)
        while stack_regime(n, dims[lo:hi + 1], dc)[0] == "refused":
            hi -= 1
        runs.append((lo, hi))
        lo = hi
    return runs


def _mm(a: Tensor, w: Tensor) -> Tensor:
    """``a @ w``; on the CPU as a one-matrix ``bmm``.  Under
    ``torch.func.vmap`` (a member axis) the product and its gradients are
    ``bmm``s, and the CPU's ``mm`` and ``bmm`` sum in different orders:
    so on the CPU each member of a vmapped call rounds exactly as that
    member alone (``tests/test_torch_ensemble_ckpt.py``'s members trained
    as separate fits, bit for bit)."""
    if a.device.type != "cpu":
        return a @ w
    return torch.bmm(a.reshape(1, -1, a.shape[-1]), w[None]).reshape(
        a.shape[:-1] + w.shape[-1:])


def dense_stack_plain(x: Tensor, kernels: Sequence[Tensor],
                      biases: Sequence[Tensor],
                      activations: Sequence[Optional[str]],
                      cond: Optional[Tensor] = None,
                      cond_kernels: Optional[Sequence[Tensor]] = None
                      ) -> Tensor:
    """Reference implementation and gradient path.  Honours
    ``nn.core.set_compute_dtype``: the whole stack runs in that dtype and
    only the output is cast back."""
    if (cond is None) != (cond_kernels is None):
        raise ValueError(
            "cond and cond_kernels must be provided together (a dropped "
            "conditional input would silently train unconditioned)")
    from vaemolsim_tpu_torch.nn.core import compute_dtype, resolve_activation
    cd = compute_dtype()
    out_dtype = x.dtype
    h = x if cd is None else x.to(cd)
    if cond is not None and cd is not None:
        cond = cond.to(cd)

    def cast(w):
        return w if cd is None else w.to(cd)

    for i, (W, b) in enumerate(zip(kernels, biases)):
        h = _mm(h, cast(W)) + cast(b)
        if cond is not None:
            h = h + _mm(cond, cast(cond_kernels[i]))
        h = resolve_activation(activations[i])(h)
    return h if cd is None else h.to(out_dtype)


def dense_stack_cuda(x: Tensor, kernels: Sequence[Tensor],
                     biases: Sequence[Tensor],
                     activations: Sequence[Optional[str]],
                     cond: Optional[Tensor] = None,
                     cond_kernels: Optional[Sequence[Tensor]] = None
                     ) -> Tensor:
    """Launch ``csrc/dense_stack.cu`` on float32 CUDA tensors."""
    return _launch(x, kernels, biases, activations, cond, cond_kernels, 0)


def dense_stack_members_cuda(x: Tensor, kernels: Sequence[Tensor],
                             biases: Sequence[Tensor],
                             activations: Sequence[Optional[str]],
                             cond: Optional[Tensor] = None,
                             cond_kernels: Optional[Sequence[Tensor]] = None
                             ) -> Tensor:
    """M stacks of one structure in one launch of ``csrc/dense_stack.cu``
    (the kernel's member axis): every tensor has a leading member axis,
    x (M, ..., in), kernels (M, in, out), biases (M, out), cond (M, ...,
    dc), cond_kernels (M, dc, out); member m's rows go through member
    m's weights.  Counted as the kernel's ``"members"`` mode."""
    return _launch(x, kernels, biases, activations, cond, cond_kernels,
                   x.shape[0])


def _launch(x, kernels, biases, activations, cond, cond_kernels,
            members: int) -> Tensor:
    """The launch behind both wrappers (the kernel's one entry, which
    takes a member count); ``members`` 0 for one stack without a member
    axis, launched as one member."""
    n_layers = len(kernels)
    if not 1 <= n_layers <= _MAX_LAYERS:
        raise ValueError(f"the dense-stack kernel takes 1..{_MAX_LAYERS} "
                         f"layers, got {n_layers}")
    if any(a not in _ACT_CODES for a in activations):
        raise ValueError(f"the dense-stack kernel takes linear, tanh, relu or "
                         f"gelu activations, got {list(activations)}")
    m = (members,) if members else ()
    dims = [x.shape[-1]] + [W.shape[-1] for W in kernels]
    lead = x.shape[:-1]
    x2 = _build.require(x.reshape(m + (-1, dims[0])).contiguous(), "x")
    n = x2.shape[-2]
    Ws = [_build.require(W, f"kernels[{i}]",
                         m + (dims[i], dims[i + 1]))
          for i, W in enumerate(kernels)]
    bs = [_build.require(b, f"biases[{i}]", m + (dims[i + 1],))
          for i, b in enumerate(biases)]
    dc = 0
    c2, Cs = None, [None] * n_layers
    if cond is not None:
        dc = cond.shape[-1]
        c2 = _build.require(cond.reshape(m + (-1, dc)).contiguous(), "cond",
                            m + (n, dc))
        Cs = [_build.require(C, f"cond_kernels[{i}]",
                             m + (dc, dims[i + 1]))
              for i, C in enumerate(cond_kernels)]
    regime, smem = stack_regime(n, dims, dc)
    if regime == "refused":
        raise ValueError(
            f"dense stack of widths {dims} (cond width {dc}) at {n} rows "
            f"needs {smem} bytes of shared memory per block, more than the "
            f"{_MAX_SMEM} a block may use")
    out = torch.empty(m + (n, dims[-1]), dtype=x.dtype, device=x.device)
    ptrs = ctypes.c_void_p * n_layers
    KERNEL.launch(
        x.device, x2.data_ptr(), _build.ptr(c2), out.data_ptr(), n, n_layers,
        (ctypes.c_int * (n_layers + 1))(*dims),
        (ctypes.c_int * n_layers)(*[_ACT_CODES[a] for a in activations]),
        ptrs(*[W.data_ptr() for W in Ws]), ptrs(*[b.data_ptr() for b in bs]),
        ptrs(*[_build.ptr(C) for C in Cs]), dc, max(members, 1),
        mode="members" if members else None, outputs=(out,))
    return out.reshape(lead + (dims[-1],))


def _call(kernel_fn, x: Tensor, kernels: Sequence[Tensor],
          biases: Sequence[Tensor], activations: Sequence[Optional[str]],
          cond: Optional[Tensor], cond_kernels: Optional[Sequence[Tensor]],
          member_fn=None):
    """``kernel_fn`` on the stack, differentiable through the plain
    version with respect to x, every weight and the conditional input;
    ``member_fn`` (its member-batched form) under ``torch.func.vmap``."""
    n = len(kernels)
    acts = tuple(activations)
    has_cond = cond is not None

    def split(ts):
        ks, bs = ts[1:1 + n], ts[1 + n:1 + 2 * n]
        if has_cond:
            return ts[0], ks, bs, acts, ts[1 + 2 * n], ts[2 + 2 * n:]
        return ts[0], ks, bs, acts, None, None

    tensors = [x, *kernels, *biases]
    if has_cond:
        tensors += [cond, *cond_kernels]
    return _build.call_with_plain_grad(
        lambda *ts: kernel_fn(*split(ts)),
        lambda *ts: dense_stack_plain(*split(ts)), *tensors,
        member_fn=(None if member_fn is None
                   else lambda *ts: member_fn(*split(ts))))


def fused_dense_stack(x: Tensor, kernels: Sequence[Tensor],
                      biases: Sequence[Tensor],
                      activations: Sequence[Optional[str]],
                      cond: Optional[Tensor] = None,
                      cond_kernels: Optional[Sequence[Tensor]] = None
                      ) -> Tensor:
    """Dense stack: the kernel for a CUDA tensor inside its supported
    set, in the runs of :func:`stack_runs`; the plain version otherwise."""
    from vaemolsim_tpu_torch.nn.core import compute_dtype
    supported = (all(a in _ACT_CODES for a in activations)
                 and compute_dtype() in (None, torch.float32))
    if not (x.is_cuda and supported):
        return dense_stack_plain(x, kernels, biases, activations, cond,
                                 cond_kernels)
    if (cond is None) != (cond_kernels is None):
        raise ValueError("cond and cond_kernels must be provided together")
    return _split_call(dense_stack_cuda, x, kernels, biases, activations,
                       cond, cond_kernels, dense_stack_members_cuda)


def _split_call(kernel_fn, x: Tensor, kernels: Sequence[Tensor],
                biases: Sequence[Tensor],
                activations: Sequence[Optional[str]],
                cond: Optional[Tensor],
                cond_kernels: Optional[Sequence[Tensor]],
                member_fn=None) -> Tensor:
    """The stack in the runs of :func:`stack_runs`, ``kernel_fn`` (through
    :func:`_call`, ``member_fn`` under a member axis) on each."""
    dims = [x.shape[-1]] + [W.shape[-1] for W in kernels]
    dc = 0 if cond is None else cond.shape[-1]
    h = x
    for lo, hi in stack_runs(x[..., 0].numel(), dims, dc):
        h = _call(kernel_fn, h, kernels[lo:hi], biases[lo:hi],
                  activations[lo:hi], cond,
                  None if cond is None else cond_kernels[lo:hi], member_fn)
    return h

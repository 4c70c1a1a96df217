"""Dense stacks: a whole MLP in one kernel (port of
``vaemolsim_tpu/ops/fused_mlp.py``).

:func:`fused_dense_stack` computes ``h = act(h @ W_i + b_i (+ c @ C_i))``
layer by layer.  Whether the kernel can take a stack is decided from the
arguments alone, as the JAX dispatch does: activations linear, tanh or
relu, and the float32 compute dtype.  Inside that set a CUDA tensor runs
``csrc/dense_stack.cu``, whose gradient recomputes through
:func:`dense_stack_plain`; outside it, or on the CPU, the plain version
runs.  Weights keep the JAX ``(in, out)`` layout.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from vaemolsim_tpu_torch import _build

Tensor = torch.Tensor

__all__ = ["fused_dense_stack", "dense_stack_plain", "dense_stack_cuda",
           "KERNEL"]

KERNEL = _build.Kernel(
    "dense_stack", "csrc/dense_stack.cu", "dense_stack_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int],
    replaces="vaemolsim_tpu/ops/fused_mlp.py:106")

_ACT_CODES = {None: 0, "linear": 0, "tanh": 1, "relu": 2}
# Mirrors of csrc/dense_stack.cu's kMaxLayers, kRows and the sm_90
# shared-memory limit (the kernel refuses the same cases itself).
_MAX_LAYERS = 8
_ROWS = 32
_MAX_SMEM = 232448


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
        h = h @ cast(W) + cast(b)
        if cond is not None:
            h = h + cond @ cast(cond_kernels[i])
        h = resolve_activation(activations[i])(h)
    return h if cd is None else h.to(out_dtype)


def dense_stack_cuda(x: Tensor, kernels: Sequence[Tensor],
                     biases: Sequence[Tensor],
                     activations: Sequence[Optional[str]],
                     cond: Optional[Tensor] = None,
                     cond_kernels: Optional[Sequence[Tensor]] = None
                     ) -> Tensor:
    """Launch ``csrc/dense_stack.cu`` on float32 CUDA tensors."""
    n_layers = len(kernels)
    if not 1 <= n_layers <= _MAX_LAYERS:
        raise ValueError(f"the dense-stack kernel takes 1..{_MAX_LAYERS} "
                         f"layers, got {n_layers}")
    if any(a not in _ACT_CODES for a in activations):
        raise ValueError(f"the dense-stack kernel takes linear, tanh or "
                         f"relu activations, got {list(activations)}")
    dims = [x.shape[-1]] + [W.shape[-1] for W in kernels]
    lead = x.shape[:-1]
    x2 = _build.require(x.reshape(-1, dims[0]).contiguous(), "x")
    n = x2.shape[0]
    Ws = [_build.require(W, f"kernels[{i}]", (dims[i], dims[i + 1]))
          for i, W in enumerate(kernels)]
    bs = [_build.require(b, f"biases[{i}]", (dims[i + 1],))
          for i, b in enumerate(biases)]
    dc = 0
    c2, Cs = None, [None] * n_layers
    if cond is not None:
        dc = cond.shape[-1]
        c2 = _build.require(cond.reshape(-1, dc).contiguous(), "cond",
                            (n, dc))
        Cs = [_build.require(C, f"cond_kernels[{i}]", (dc, dims[i + 1]))
              for i, C in enumerate(cond_kernels)]
    smem = 4 * _ROWS * (2 * (max(dims) | 1) + dc)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"dense stack of widths {dims} (cond width {dc}) needs {smem} "
            f"bytes of shared memory per block, more than the {_MAX_SMEM} "
            "a block may use")
    out = torch.empty((n, dims[-1]), dtype=x.dtype, device=x.device)
    ptrs = ctypes.c_void_p * n_layers
    KERNEL.launch(
        x.device, x2.data_ptr(), _build.ptr(c2), out.data_ptr(), n, n_layers,
        (ctypes.c_int * (n_layers + 1))(*dims),
        (ctypes.c_int * n_layers)(*[_ACT_CODES[a] for a in activations]),
        ptrs(*[W.data_ptr() for W in Ws]), ptrs(*[b.data_ptr() for b in bs]),
        ptrs(*[_build.ptr(C) for C in Cs]), dc)
    return out.reshape(lead + (dims[-1],))


def fused_dense_stack(x: Tensor, kernels: Sequence[Tensor],
                      biases: Sequence[Tensor],
                      activations: Sequence[Optional[str]],
                      cond: Optional[Tensor] = None,
                      cond_kernels: Optional[Sequence[Tensor]] = None
                      ) -> Tensor:
    """Dense stack: the kernel for a CUDA tensor inside its supported
    set, the plain version otherwise."""
    from vaemolsim_tpu_torch.nn.core import compute_dtype
    supported = (all(a in _ACT_CODES for a in activations)
                 and compute_dtype() in (None, torch.float32))
    if not (x.is_cuda and supported):
        return dense_stack_plain(x, kernels, biases, activations, cond,
                                 cond_kernels)
    if (cond is None) != (cond_kernels is None):
        raise ValueError("cond and cond_kernels must be provided together")
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
        lambda *ts: dense_stack_cuda(*split(ts)),
        lambda *ts: dense_stack_plain(*split(ts)), *tensors)

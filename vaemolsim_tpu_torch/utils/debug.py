"""Runtime numerical sanitizers (port of ``vaemolsim_tpu/utils/debug.py``).

``checked(fn)`` runs ``fn`` under a ``TorchDispatchMode`` that looks at
every ATen op: its floating outputs for a NaN its inputs did not hold,
its index operands against the indexed size, and integer divisions for a
zero divisor, and raises
:class:`CheckError` naming the op and the line of Python that called it,
instead of letting a NaN run on or an index read out of bounds (on the
card a bad index is a device assert that ends the process).  The port's
kernels launch through ``ctypes`` and bypass the dispatcher, so the
check also reads what each launch writes (``_build.LAUNCH_HOOKS``).
These are the counterparts of checkify's float, index and div checks;
checkify's user checks are the function's own exceptions, which pass
through unchanged.  (checkify has no Inf check, nor does this: guard
overflow with :func:`assert_finite`.)  Every check reads a value back to
the host, so ``checked`` is for debugging, not for timed runs.
``assert_finite`` / ``assert_shape`` are eager guards for layer code.
"""

from __future__ import annotations

import functools
import os
import traceback
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vaemolsim_tpu_torch import _build

__all__ = ["checked", "assert_finite", "assert_shape", "CheckError"]

_aten = torch.ops.aten
_HERE = os.path.abspath(__file__)
_BUILD = os.path.abspath(_build.__file__)
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))

# (op, position of the indexed tensor, position of the index, dim arg
# position or None for "axis 0" / advanced indexing).
_INDEXING = {
    _aten.index_select.default: (0, 2, 1),
    _aten.gather.default: (0, 2, 1),
    _aten.embedding.default: (0, 1, None),
    _aten.index_add.default: (0, 2, 1),
    _aten.index_copy.default: (0, 2, 1),
    _aten.scatter.src: (0, 2, 1),
    _aten.scatter.value: (0, 2, 1),
    _aten.scatter_add.default: (0, 2, 1),
    _aten.take.default: (0, 1, -1),
}
_DIVISION = {_aten.div.Tensor, _aten.div.Tensor_mode,
             _aten.floor_divide.default, _aten.remainder.Tensor,
             _aten.fmod.Tensor, _aten.div_.Tensor, _aten.div_.Tensor_mode}


class CheckError(RuntimeError):
    """A check of :func:`checked` failed; the message names the op and
    where it was called."""


def _caller() -> str:
    """The innermost frame outside torch, this module and the kernels'
    launcher: the line of user (or port) code that issued the op or the
    launch."""
    for frame in reversed(traceback.extract_stack()):
        path = os.path.abspath(frame.filename)
        if path in (_HERE, _BUILD) or path.startswith(_TORCH):
            continue
        return f"{frame.filename}:{frame.lineno} ({frame.line})"
    return "unknown location"


def _raise(what: str, op) -> None:
    raise CheckError(f"{what} in {op} at {_caller()}")


def _check_index(func, args) -> None:
    src_pos, idx_pos, dim_pos = _INDEXING[func]
    src, idx = args[src_pos], args[idx_pos]
    if not torch.is_tensor(idx) or idx.numel() == 0:
        return
    if dim_pos == -1:          # take: the flattened tensor
        size = src.numel()
    elif dim_pos is None:      # embedding: rows of the table
        size = src.shape[0]
    else:
        size = src.shape[args[dim_pos] % max(src.dim(), 1)]
    lo, hi = int(idx.min()), int(idx.max())
    if lo < -size or hi >= size:
        _raise(f"index out of bounds (range [{lo}, {hi}] for size {size})",
               func)


def _check_advanced_index(func, args) -> None:
    src, indices = args[0], args[1]
    for d, idx in enumerate(indices):
        if idx is None or not torch.is_tensor(idx) or idx.dtype == torch.bool:
            continue
        if idx.numel() == 0:
            continue
        size = src.shape[d]
        lo, hi = int(idx.min()), int(idx.max())
        if lo < -size or hi >= size:
            _raise(f"index out of bounds on axis {d} (range [{lo}, {hi}] "
                   f"for size {size})", func)


def _has_nan(values) -> bool:
    return any(torch.is_tensor(t) and (t.is_floating_point() or t.is_complex())
               and bool(torch.isnan(t).any()) for t in values)


def _flat(args) -> list:
    out = []
    for a in args:
        if isinstance(a, (tuple, list)):
            out.extend(_flat(a))
        else:
            out.append(a)
    return out


def _check_outputs(op, out) -> None:
    if _has_nan(out if isinstance(out, (tuple, list)) else (out,)):
        _raise("NaN produced", op)


class _CheckMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _INDEXING:
            _check_index(func, args)
        elif func in (_aten.index.Tensor, _aten.index_put.default,
                      _aten.index_put_.default, _aten._unsafe_index.Tensor):
            _check_advanced_index(func, args)
        elif func in _DIVISION:
            a, b = args[0], args[1]
            ints = [t for t in (a, b) if torch.is_tensor(t)]
            if all(not t.is_floating_point() and not t.is_complex()
                   for t in ints) and (
                    (torch.is_tensor(b) and bool((b == 0).any()))
                    or (not torch.is_tensor(b) and b == 0)):
                _raise("integer division by zero", func)
        # A NaN is flagged where it is made: an op whose inputs held none
        # (a view or copy of a NaN passes, as the op that made it raised).
        clean = not _has_nan(_flat(args) + _flat(kwargs.values()))
        out = func(*args, **kwargs)
        if clean:
            _check_outputs(func, out)
        return out


def _launch_hook(kernel, outputs) -> None:
    # A launch's inputs are not known here: any NaN it wrote counts.
    _check_outputs(f"the {kernel.name} kernel ({kernel.source})", outputs)


def checked(fn: Callable) -> Callable:
    """``fn`` with NaN, index and integer-division checks on every op it
    runs (and every port kernel it launches); raises :class:`CheckError`
    with the op's name and the calling line.

    >>> safe_step = checked(lambda s: run_mcmc(step, s, 100)[0])
    >>> state = safe_step(state)   # raises if any check trips
    """

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        _build.LAUNCH_HOOKS.append(_launch_hook)
        try:
            with _CheckMode():
                return fn(*args, **kwargs)
        finally:
            _build.LAUNCH_HOOKS.remove(_launch_hook)

    return wrapper


def _tensors(x) -> list:
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return [x] if torch.is_tensor(x) else []


def assert_finite(x, name: str = "value") -> None:
    """Every element of a tensor or tree of tensors is finite.  A no-op
    while a CUDA graph is being captured (a host read would break the
    capture), as the JAX package's is under tracing."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        return
    for i, t in enumerate(_tensors(x)):
        if (t.is_floating_point() or t.is_complex()) and not bool(
                torch.isfinite(t).all()):
            raise AssertionError(f"{name}: leaf {i} has non-finite values")


def assert_shape(x, shape, name: str = "value") -> None:
    """``x``'s shape is ``shape`` (``None`` or ``...`` matches any size
    on that axis)."""
    got = tuple(x.shape)
    want = tuple(shape)
    if len(got) != len(want) or any(
            w is not None and w is not Ellipsis and g != w
            for g, w in zip(got, want)):
        raise AssertionError(f"{name}: expected shape {want}, got {got}")

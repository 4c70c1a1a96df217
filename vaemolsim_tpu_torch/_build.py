"""Build, load and launch the hand-written CUDA kernels.

Every ``csrc/*.cu`` compiles, at first use, into its own shared library
with a plain C interface, which is loaded with ``ctypes``.  All sources
build at once, one ``nvcc`` process each, in parallel; a library is
rebuilt only when its source, a header or the flags change (the file
name carries a digest of all three).  Libraries go to ``_build_cache/``
beside this file, which git ignores.

A kernel is reached through a :class:`Kernel`: it checks the C return
code (``cudaGetLastError()`` right after the launch, so a refused launch
raises instead of silently never running) and counts its launches.  A
CUDA tensor never goes to a plain version: a wrapper launches its kernel
or raises.  Nothing here synchronises with the device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["Kernel", "KERNELS", "LAUNCH_HOOKS", "NVCC_FLAGS", "BUILD_LOGS",
           "build_all",
           "reset_launches", "launch_counts",
           "call_with_plain_grad"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
CACHE_DIR = Path(__file__).resolve().parent / "_build_cache"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# The compiler's output of each source built in this process (ptxas's
# registers, shared memory and spills per kernel), by source stem.
BUILD_LOGS: Dict[str, str] = {}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in sorted(SRC_DIR.glob("*.cuh")) + [src]:
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    return CACHE_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all
    in parallel; return {source stem: library path}.  Raises with the
    compiler's output if any build fails."""
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    paths = {src.stem: (src, _lib_path(src))
             for src in sorted(SRC_DIR.glob("*.cu"))}
    todo = {name: sp for name, sp in paths.items() if not sp[1].exists()}
    procs = {}
    if todo:
        nvcc = _nvcc()
        for name, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(SRC_DIR), "-o", str(tmp),
                   str(src)]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return {name: sp[1] for name, sp in paths.items()}


def _library(stem: str) -> ctypes.CDLL:
    with _lock:
        if stem not in _libs:
            for name, path in build_all().items():
                if name not in _libs:
                    _libs[name] = ctypes.CDLL(str(path))
        return _libs[stem]


class Kernel:
    """One C entry point of one ``csrc/<source>.cu`` library.

    ``argtypes`` lists the entry's arguments before the trailing stream
    (``ctypes.c_void_p`` for every pointer).  ``launches`` counts the
    launches made through :meth:`launch` and nowhere else, and
    ``mode_launches`` those of them made in a named mode (the MAF block's
    ``"bf16"``, kernels 1 and 2's ``"members"``)."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]
        self.replaces = replaces
        self.launches = 0
        self.mode_launches: Dict[str, int] = {}
        self._fn = None
        KERNELS[name] = self

    def _bind(self):
        lib = _library(Path(self.source).stem)
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        err = lib.vms_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._fn, self._err = fn, err
        return fn

    def launch(self, device: torch.device, *args,
               mode: Optional[str] = None,
               outputs: Sequence[torch.Tensor] = ()) -> None:
        """Launch on ``device``'s current stream.  ``outputs`` are the
        tensors the launch writes: every hook in ``LAUNCH_HOOKS`` (the
        NaN check of ``utils.debug.checked``) sees them after the launch;
        the dispatcher never does."""
        fn = self._fn or self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{self._err(rc).decode()} (cudaError {rc})")
        self.launches += 1
        if mode is not None:
            self.mode_launches[mode] = self.mode_launches.get(mode, 0) + 1
        for hook in LAUNCH_HOOKS:
            hook(self, outputs)

    def query(self, symbol: str, *args: int) -> int:
        """An int-valued host function of the kernel's library (a limit
        of its launch), called with int arguments; no launch, no count."""
        fn = getattr(_library(Path(self.source).stem), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        return int(fn(*args))


KERNELS: Dict[str, Kernel] = {}
# Callables ``hook(kernel, outputs)`` run after every launch.
LAUNCH_HOOKS: List[Callable] = []


def reset_launches() -> None:
    """Set every kernel's launch counts to 0."""
    for k in KERNELS.values():
        k.launches = 0
        k.mode_launches = {}


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """Device address of a tensor (None for an absent optional input)."""
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, what: str, shape=None,
            dtype=torch.float32) -> torch.Tensor:
    """Check a kernel operand: on CUDA, the kernel's dtype, contiguous
    and (if given) of the exact shape.  Raises on anything else."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: the kernel takes {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    return t


class _PlainGrad(torch.autograd.Function):
    """Forward through a kernel, backward by the plain version's VJP
    (the counterpart of the JAX ``custom_vjp``s whose backward re-runs
    the XLA path), in the ``setup_context`` form, so that it also runs
    under ``torch.func`` transforms.

    The backward is ``torch.func.vjp`` of the plain version at the saved
    inputs.  Under ``create_graph=True`` it runs in grad mode and the
    gradient it returns is differentiable again (a second derivative
    through a kernel route); otherwise it keeps no graph.

    Under ``torch.func.vmap`` (a member axis) the ``vmap`` rule maps the
    batch axis onto one launch of the kernel's member-batched form
    (``kernel_fn.members``, see :func:`call_with_plain_grad`).  A kernel
    without one raises on a CUDA tensor; on the CPU the stand-in kernel
    is itself vmapped."""

    @staticmethod
    def forward(kernel_fn, plain_fn, *tensors):
        return kernel_fn(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.plain_fn = inputs[1]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    def backward(ctx, *grads):
        inputs = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        wrt = [i for i, n in enumerate(need) if n]

        def plain(*diff):
            args = list(inputs)
            for i, d in zip(wrt, diff):
                args[i] = d
            return ctx.plain_fn(*args)

        _, vjp_fn = torch.func.vjp(plain, *[inputs[i] for i in wrt])
        got = iter(vjp_fn(grads if len(grads) > 1 else grads[0]))
        return (None, None, *[next(got) if n else None for n in need])

    @staticmethod
    def vmap(info, in_dims, kernel_fn, plain_fn, *tensors):
        dims = in_dims[2:]
        members = getattr(kernel_fn, "members", None)
        if members is None:
            if any(t.is_cuda for t in tensors):
                raise RuntimeError(
                    "this kernel has no member axis: it cannot run under "
                    "torch.func.vmap on a CUDA tensor")
            out = torch.func.vmap(kernel_fn, in_dims=dims)(*tensors)
        else:
            out = members(*[
                (t.expand((info.batch_size,) + t.shape) if d is None
                 else t.movedim(d, 0)).contiguous()
                for t, d in zip(tensors, dims)])
        return out, (tuple(0 for _ in out) if isinstance(out, tuple) else 0)


class _WithMembers:
    """A kernel call with a member-batched form: ``fn(*tensors)`` for one
    member, ``members(*tensors)`` for all at once (every tensor and
    every output with a leading member axis)."""

    def __init__(self, fn: Callable, members: Callable):
        self.fn, self.members = fn, members

    def __call__(self, *tensors):
        return self.fn(*tensors)


def _transformed(t: torch.Tensor) -> bool:
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def call_with_plain_grad(kernel_fn: Callable, plain_fn: Callable,
                         *tensors: torch.Tensor,
                         member_fn: Optional[Callable] = None):
    """``kernel_fn(*tensors)``, differentiable through ``plain_fn``.
    ``member_fn``, where the kernel has a member axis, takes every
    tensor with a leading member axis and launches once for all members:
    the route under ``torch.func.vmap``.  Without a gradient to track or
    a transform around it, it is the bare kernel call."""
    if member_fn is not None:
        kernel_fn = _WithMembers(kernel_fn, member_fn)
    if (any(_transformed(t) for t in tensors)
            or (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors))):
        return _PlainGrad.apply(kernel_fn, plain_fn, *tensors)
    return kernel_fn(*tensors)

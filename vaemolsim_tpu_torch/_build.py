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
from typing import Callable, Dict, Optional, Sequence

import torch

__all__ = ["Kernel", "KERNELS", "NVCC_FLAGS", "BUILD_LOGS", "build_all",
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
    ``"bf16"``)."""

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
               mode: Optional[str] = None) -> None:
        fn = self._fn or self._bind()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{self._err(rc).decode()} (cudaError {rc})")
        self.launches += 1
        if mode is not None:
            self.mode_launches[mode] = self.mode_launches.get(mode, 0) + 1

    def query(self, symbol: str, *args: int) -> int:
        """An int-valued host function of the kernel's library (a limit
        of its launch), called with int arguments; no launch, no count."""
        fn = getattr(_library(Path(self.source).stem), symbol)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = ctypes.c_int
        return int(fn(*args))


KERNELS: Dict[str, Kernel] = {}


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
    """Forward through a kernel, backward by recomputing the plain
    version under autograd (the counterpart of the JAX ``custom_vjp``s
    whose backward re-runs the XLA path).

    Under ``create_graph=True`` the backward runs in grad mode: it then
    recomputes on the saved inputs themselves and keeps the graph, so
    the gradient it returns is differentiable again (a second derivative
    through a kernel route).  Otherwise it recomputes on detached copies
    and keeps no graph alive."""

    @staticmethod
    def forward(ctx, kernel_fn, plain_fn, *tensors):
        ctx.plain_fn = plain_fn
        ctx.save_for_backward(*tensors)
        return kernel_fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        higher = torch.is_grad_enabled()
        if higher:
            inputs = list(ctx.saved_tensors)
        else:
            inputs = [t.detach().requires_grad_(t.requires_grad)
                      for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ctx.plain_fn(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
        need = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs],
                                       need, [g for _, g in pairs],
                                       allow_unused=True,
                                       create_graph=higher))
        return (None, None, *[next(got) if t.requires_grad else None
                              for t in inputs])


def call_with_plain_grad(kernel_fn: Callable, plain_fn: Callable,
                         *tensors: torch.Tensor):
    """``kernel_fn(*tensors)``, differentiable through ``plain_fn``.
    Without a gradient to track it is the bare kernel call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlainGrad.apply(kernel_fn, plain_fn, *tensors)
    return kernel_fn(*tensors)

"""vaemolsim_tpu_torch: the PyTorch + CUDA port of vaemolsim_tpu.

The JAX package ``vaemolsim_tpu`` is the reference; this package mirrors
its module paths and public names.  Layers are ``torch.nn.Module``s,
every sampling entry point takes an explicit ``torch.Generator``, and
the TPU kernels on the ported path are hand-written CUDA kernels under
``csrc/``, built at first use (``_build``).  On a CPU tensor every
kernel wrapper runs the kernel's plain PyTorch version instead.

Ported so far: the VAE-proposal MC step on the flagship model (see
ROADMAP.md for what is still to come).
"""

from vaemolsim_tpu_torch import config, convert  # noqa: F401
from vaemolsim_tpu_torch import dists, flows, mcmc, models, nn, ops  # noqa: F401

__version__ = "0.1.0"

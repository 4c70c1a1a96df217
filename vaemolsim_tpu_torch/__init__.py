"""vaemolsim_tpu_torch: the PyTorch + CUDA port of vaemolsim_tpu.

The JAX package ``vaemolsim_tpu`` is the reference; this package mirrors
its module paths and public names.  Layers are ``torch.nn.Module``s,
every sampling entry point takes an explicit ``torch.Generator``, and
the TPU kernels on the ported path are hand-written CUDA kernels under
``csrc/``, built at first use (``_build``).  On a CPU tensor every
kernel wrapper runs the kernel's plain PyTorch version instead.

Ported so far: the VAE-proposal MC step on the flagship model, and
training (``train.fit``, the ELBO and flow-model losses) with the
MAF-block kernel for flows of two or more dimensions, and CG ->
atomistic backmapping (``BackmappingOnly``: distance selection, the
geometric-algebra attention embedding with the pair-attention kernel,
and a von Mises + conditional MAF decoder), served by ``predict`` and
trained by ``train.fit``, and molecular MD (``potentials``: bonds, the
cell-list Lennard-Jones / Ewald real-space term with the cell-pair
kernel, PME; ``md``: velocity Verlet and BAOAB, with neighbour-list
rebuilds), and the sampling stack: the RealNVP flow family, local moves
(random walk, MALA, HMC) and their tuner, chain diagnostics, simulated
tempering, replica exchange on one device (``parallel``) and the
free-energy estimators, and the rest of the reference library's
surface: dual-ELBO and Hamiltonian VAEs, batch-norm flows, the
autoregressive and von Mises heads, CG maps, ensembles and checkpoints;
joint backmapping (``dists.JointBackmapping``) with SchNet or two-stage
attention embeddings, SchNet potentials, BAT/NeRF internal coordinates
(``coords``), trajectory I/O (``data``: DCD, PDB, XYZ) and checkpointed
MC; and the rest of the molecular stack: the Ewald sum, dense Coulomb,
the bonded terms and the other pair terms (``potentials``), constrained
and thermostatted MD (``md``: SHAKE / RATTLE, Nose-Hoover chains, CSVR,
r-RESPA, steered Langevin, the NPT barostat), ``observables``, and NPT,
grand-canonical and Gibbs-ensemble Monte Carlo (``mcmc``); and triclinic
cells with triclinic PME and the L-BFGS polish (``triclinic``,
``potentials``), replica-exchange MD and Hamiltonian replica exchange
(``parallel``), temperature extrapolation (``extrapolation``),
path-integral, Brownian, generalized-Langevin and DPD dynamics
(``pimd``, ``bd``, ``gle``, ``dpd``) and flow matching (``flows``) (see
ROADMAP.md for what is still to come).
"""

from vaemolsim_tpu_torch import config, convert, coords, data  # noqa: F401
from vaemolsim_tpu_torch import losses  # noqa: F401
from vaemolsim_tpu_torch import md, observables, potentials  # noqa: F401
from vaemolsim_tpu_torch import bd, dpd, extrapolation, gle  # noqa: F401
from vaemolsim_tpu_torch import pimd, triclinic  # noqa: F401
from vaemolsim_tpu_torch import dists, flows, mcmc, models, nn, ops  # noqa: F401
from vaemolsim_tpu_torch import parallel  # noqa: F401
from vaemolsim_tpu_torch import train  # noqa: F401

__version__ = "0.1.0"

#!/usr/bin/env python3
"""Drive vaemolsim_tpu_torch's MC, training, backmapping, molecular MD,
sampling-stack paths, the rest of the reference library's surface,
joint backmapping with its tools, the rest of the molecular stack and
biased sampling, path sampling, rare events and kinetics, top-down and
bottom-up potential fitting, score diffusion, an equivariant potential
and committee uncertainty, the parallel layer, the input pipeline and
the debug and profiling utilities on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the CUDA kernels from ``vaemolsim_tpu_torch/csrc`` (nvcc, one
   process per source, in parallel, from a thread), and meanwhile runs
   the slice-11 phases that launch no kernel (examples 22, 14 + 19 + 21
   and 13, item 11);
2. holds each kernel against its plain PyTorch version on the card, at
   the shapes of the paths below, with the tolerances stated beside
   each check, and times both by CUDA events behind a device spin, so
   that the host's enqueue does not count (the MAF block also against
   its unfused route and by torch.profiler's device time; the one-row
   MAF conditioner also against the library chain addmm, tanh, addmm);
   the dense-stack checks name the regime the kernel ran (the tiled
   regime at the backmapping decoder's widths also with device times and
   its bound), the RQS and proposal checks print each timed case's launch
   plan and time both at 10k and 50k, the launch floor (the device time
   of an empty ``torch.cuda._sleep(0)``, timed the same way) is printed
   beside the RQS kernel's bound, and the build prints ptxas's registers
   and spills of every kernel;
3. checks the proposal kernel's own Philox draws: the plain version on
   the same seed, the densities of its samples recomputed through the
   model's distribution objects, and the moments of the normals it drew;
4. runs both MC paths on the full-width flagship (hidden 200, 32 bins,
   random weights from the config's seed) on a 2-D standard-normal
   target at 10k and 50k chains: the generic ``make_mcmc_step`` (dense
   stack + RQS kernels) and ``make_fused_vae_step`` (proposal kernel),
   and checks acceptance, finiteness, the chains' second moment and the
   counters, with the device busy time per step of a profiled window;
5. trains the flagship VAE by its ELBO through ``train.fit`` at batch
   10k on 100k two-mode 2-D points (dense stack + RQS kernels), and an
   8-D RQS-spline MAF flow model (reference widths: hidden 200, 32 bins
   on [-10, 10]) by maximum likelihood at batch 10k on 100k correlated
   Gaussian points, then samples 10k points from it (MAF-block kernel
   in both directions): finite, falling losses, samples moving toward
   the data's moments, and each path's gradients against a CPU copy;
6. runs CG -> atomistic backmapping on the notebook's model
   (``backmapping_experiment_config``: 10 nearest of 30 particles within
   3.0, a 2-block GA-attention embedding of width 20, hidden 40, a von
   Mises + 3-block conditional MAF decoder): ``predict`` and
   ``log_prob`` at 10k CG sites (pair-attention, dense-stack and
   MAF-block kernels), rotation invariance of ``log_prob`` on the card,
   and ``train.fit`` at batch 128 on 2000 frames, with its gradients
   against a CPU copy.  The pair-attention kernel is also held against
   its plain version at the notebook's shape (N = 10, H = 40, B = 2000
   and serving's B = 10 000, on the path's own selections), at the
   compute-dense N = 50, H = 64 (B = 1000) and at a ragged N = 37, in
   both modes, with fully masked rows and clouds, each timed case with
   the kernel's lane plan;
7. runs molecular MD through ``md.baoab_neighbor`` at 8192 atoms (cell-
   pair kernel): the production molecular stack of bench.py:631 (charged
   dimers, harmonic bonds, bonded exclusions masked inside the cell-list
   LJ with its Ewald real-space term, PME reciprocal space) and the LJ
   liquid of bench.py:559, each thermalised, timed over 200 steps and
   profiled over one rebuild chunk, with the kinetic temperature checked;
   for the liquid also the cell-list energy and gradient against the
   dense O(N^2) form and an NVE run's energy conservation.  The cell-pair
   kernel is held against its plain version on both paths' own gathered
   inputs, on a binary Lorentz-Berthelot mixture with charges and
   exclusions, a coincident pair and a ragged grid, and the energy's NaN
   contract (overflowed and drifted builds) is checked on the card; its
   bound is printed by two counts, the occupied candidate slots (the
   least work) and every padded slot (the first design's count);
8. runs the sampling stack: the 1-D ``RQSSplineRealNVP`` flow workload
   of bench.py:368 (4 blocks, 32 bins on [-5, 5], hidden 100, built by
   ``RealNVPConfig``; ``fit`` at batch 4096 on 100k 4-mode points for 10
   epochs, then 10k samples; gradients against a CPU copy), the
   sampler-statistics block of bench.py:461 on the flagship (10k chains x
   600 cycled VAE / MALA / random-walk steps with scales tuned on the
   card, and its four asserted thresholds), molecular HMC on LJ7 (bench.py
   :521: ``minimize_energy``, ``tune_scale``, 100 HMC steps at 8192
   chains; plain PyTorch, no kernel), examples 10 and 40 at their --full
   sizes with their own validations (EXP, BAR, AIS, the flow-FEP, MBAR;
   a 2-D RealNVP trained by ``tfep_loss`` for 200 steps at N = 20k,
   then targeted EXP and BAR), replica exchange on the flagship (4
   replicas of 1000 chains, exact swap counters) and simulated tempering
   on a double well (every rung visited, the adapted weights against
   quadrature); then kernels 2 and 1 at those paths' shapes and weights
   (the one-row 1->100->95 conditioner with the library chain, the
   1->64->47 conditioner at 20k rows, kernel 1's broadcast row and its row
   per element at K = 16, N = 20k), each timed with its bound.  Kernel 1's
   launches are also tallied by route (broadcast row or row per element);
9. runs the rest of the reference library's surface: the flagship as a
   dual-ELBO VAE (``VAEConfig(dual_elbo=True)``, KL forward, reverse KL
   reverse, the potential -log_target) and by the Hamiltonian VAE bound
   (5 leapfrog steps of 0.1), each through ``fit`` at batch 10k with its
   gradients at fixed draws against a CPU copy (the HVAE's through second
   derivatives of kernels 1 and 2's routes) and the HVAE's bound at 0
   steps against the ELBO; the 8-D MAF with 3 blocks and batch norm
   between them (maximum likelihood with ``update_batch_stats`` after
   each step, ``predict`` of 10k, and a checkpoint saved mid-training
   and resumed into a fresh model, optimizer and generator with the
   uninterrupted run's losses); examples/09 at its --full widths (K = 8
   members, 25k points, batch 1024) through ``fit_ensemble`` for
   ENS_EPOCHS epochs with the example's validation, on the member axis
   (one vmapped step: kernels 1 and 2 launch once a block for all eight
   members, each member-batched launch then held to the plain version
   member by member); the backmapping
   model with BASELINE.json's autoregressive von Mises mixture decoder
   (training, ``predict`` and ``log_prob`` at 10k sites, rotation
   invariance); then kernel 2 at that decoder's MADE (3 -> 24 -> 24) and
   kernel 3 at the batch-norm flow's middle block, against their plain
   versions;
10. runs slice 10: examples/06 at --full (a DCD written and read back
   with the native reader, BAT, a 3-block periodic MAF over a von Mises
   base through ``fit`` on kernels 3 and 2, 500 generated frames through
   NeRF to DCD; the BAT round trip, the NLL and the trans population
   checked, kernel 3 at that shape); examples/16 at --full (a
   ``JointBackmapping`` with SchNet embeddings against its prefix-zeroed
   ablation, 512 sampled systems, the example's own asserts; then the
   attention embedding on kernels 5 and 2 against a CPU copy, kernel 5
   at B = 24 000, N = 4); bench.py:736's SchNet MD (256 x 32 atoms,
   BAOAB, the energy-force loss's gradients against a CPU copy); the
   notebook's backmapping model with ``attention="two_stage"``;
   ``run_mcmc_checkpointed`` at 50k chains, fused and generic, resumed
   bit for bit; the 8-D MAF under ``set_compute_dtype(torch.bfloat16)``
   (kernel 3's bf16 mode against its plain version and against its
   float32 mode's time, MLE steps, sampling); and the shapes whose
   one-launch plan the kernels refuse (split launches, the dense stack's
   wide regime, kernel 5's stream regime) with kernel 1's log-det
   outliers against float64;
11. runs slice 11 at the examples' --full widths, with fewer steps
   (PERF.md section 4 lists the cuts) and each example's own asserts:
   example 15's molten salt (1728 ions; the split Ewald sum, kernel 6's
   erfc mode plus the reciprocal sum, against the dense sum, also with
   TF32 allowed; BAOAB on the neighbour list; charge ordering; kernel 6
   at that shape), example 39 (512 dimers; PME and kernel 6 against the
   exact Ewald sum; bonds, charge ordering, kT), example 22 (rigid water
   with SHAKE / RATTLE and Ewald, its polar run and apolar control in
   one batch, constrained NVE, a TF32 run), example 11 (the Boltzmann
   generator: HMC, the 3-block MAF by MLE and reverse KL on kernels 3
   and 2, flow MC; kernel 3 at that shape; gradients against a CPU
   copy), examples 14, 19 and 21 (NPT, GCMC and Gibbs-ensemble MC),
   example 13 (soft-core decoupling, MBAR against TI), and kernel 5's
   key-chunked stream regime at N = 1553, 4096 and 8192 and at H = 300
   and 512;
12. runs slice 12 at the examples' --full widths, with fewer steps
   (PERF.md section 4 lists the cuts) and each example's own asserts:
   example 41 (anisotropic NPT of an LJ fluid in a sheared cell, the
   strain-derivative pressure tensor, the triclinic cell list against
   the dense energy), example 42 (a rock-salt crystal with triclinic
   Ewald: Madelung, NPT against a q = 0 control, and triclinic PME
   against the classic sum), example 24 (REMD, a flow-matching CNF
   trained through ``fit`` on kernel 2 with gelu, sampling and flow MC;
   kernel 2 at the velocity field's shape), example 26 (the L-BFGS
   polish's LJ7 golden, REMD, temperature extrapolation and
   reweighting), example 38 (HREX over a soft-core ladder: TI, MBAR and
   Widom), example 34 (PILE PIMD against grid diagonalisation) and
   Brownian (free and RPY), GLE and DPD dynamics at 1000 particles and
   more;
13. runs slice 13a, whose loops go through ``utils.scan_collect`` and so
   replay captured CUDA graphs: first the replay against the eager loop
   (``scan.eager()``) for metadynamics, a shooting sweep and committor
   shots at the phases' widths (at most 1e-6 apart); then, at the
   examples' --full widths and default depths (PERF.md section 4),
   example 23 (well-tempered metadynamics of a butane-like torsion, 64
   walkers, 16 000 steps, and its unbiased control), the OPES and eABF
   convergence checks of tests/test_opes.py and tests/test_abf.py,
   example 32 (Muller-Brown minima, the climbing NEB and its saddle,
   harmonic TST, 48 TPS walkers of 401 frames over 400 sweeps) and
   example 33 (768 TPS configurations labelled by 12 committor shots
   each, a tanh MLP trained on them, 256 shots from the saddle), each
   with its own asserts and a line of its rate, its ms a step replayed
   against eager and its idle share;
14. runs slice 13b (``SLICE13B_PHASES``) at the examples' default
   depths, its long Langevin loops replayed through ``md._BAOAB``,
   ``we.run_we`` and FFS's scans (``scan_replay_path`` also holds
   ``basin_flux``, ``ffs_stage`` and five WE iterations to the eager
   loop): examples 25 and 29 on one Muller-Brown trajectory of 48
   walkers x 80 000 steps (TICA, the Voronoi MSM, stationary populations
   against quadrature, implied timescales, committor, MFPT; the VAMPnet
   trained through ``fit``), example 27 (weighted ensemble against brute
   force) and example 35 (brute force, FFS, WE and Kramers-corrected TST
   on one escape rate), each with the example's own asserts and a line
   of its rate, its ms a step replayed against eager and its idle share;
15. runs slice 13c (``SLICE13C_PHASES``) at the examples' default depths,
   every MD run replayed through ``md._BAOAB`` (``scan_replay_path`` also
   holds one DiffTRe sampling round and example 18's FG and CG MD to the
   eager loop): example 31 (``difftre.difftre_fit`` recovers LJ epsilon
   and sigma from a reference fluid's g(r) and virial pressure, the
   pressure's gradient reverse over forward) and example 18 at its
   --full width (force matching a SchNet CG potential on mapped forces of
   48 trimer-fluid replicas, CG MD on it, the g(r) check; then
   tests/test_cg.py's ``rel_entropy_fit``), each with the example's own
   asserts, its ms a DiffTRe inner step or force-matching step, and its
   ms a step replayed against eager with the idle share of a window that
   skips the first replay;
16. runs slice 14a (``SLICE14A_PHASES``): example 28 at its default depths
   but its epochs
   (a VP score diffusion with a 128 x 128 gelu noise net on kernel 2,
   trained by denoising score matching through ``fit`` with EMA weights;
   ancestral SDE samples, probability-flow densities on a grid and an
   importance-sampled normalization, the diffusion as an MH independence
   proposal; the example's own asserts; then kernel 2 at the path's four
   row counts), and a PaiNN potential at ``ml_potential_md_path``'s
   configuration (BAOAB replayed through ``md._BAOAB`` and held to the
   eager loop within 1e-6, ``energy_force_loss``'s gradients, the box
   gradient against a CPU copy, rotated forces on a cluster) with a
   committee of three PaiNNs (``ensemble_energy_forces`` and
   ``max_force_uncertainty`` over 256 frames, masked and not, against a CPU
   copy; identical members spread exactly 0);
17. runs slice 14b (``SLICE14B_PHASES``): the parallel layer in a
   world-size-1 NCCL group (the card is one; several ranks are held on
   the CPU by tests/torch_ranks.py's gloo groups): example 08 at its
   default depths (the flagship trained by ``fit(mesh=)``, then sharded
   generic and fused MC, the fused run bit for bit against the unsharded
   one), example 05 over a ("replica", "chain") mesh held to the JAX
   example's spread over seeds, kernel 4 at a chain offset, kernel 6's
   four slabs one after another at the molecular stack's shape and the
   mesh path against the unsharded call, slab-decomposed PME, the
   collective checkpoint; then the input pipeline (a DCD file through
   ``epoch_stream``, prefetch copies against compute) and the utilities
   (``checked`` on a NaN through kernel 2, ``StepTimer`` and
   ``benchmark_fn`` against CUDA events, a ``trace`` file);
18. runs slice 15 (``SLICE15_PHASES``): examples/30 at its default
   depths (a committee of three SchNets stacked on the member axis,
   trained on cold LJ frames, deployed by committee-mean MD at a hotter
   state, two rounds of labelling the frames of highest force
   disagreement, the random-acquisition control, the example's four
   asserts), its committee trainer and every MD run replayed from
   captured CUDA graphs.
   A line before the last gives every phase's seconds, longest first.

Every path runs with the launch counters zeroed just before it and read
just after; a path whose layers reach kernel 5 fails unless it launched
it (a CUDA call never takes a plain version).  Any failed check raises
and the script
exits non-zero;
there is no CPU fallback.  The last stdout lines are the card's name and
power limit, one JSON line of per-kernel results, and
``{"ok": true, "device": {...}}``.  The full results also go to
``chiprun_out/chip_smoke_results.json``.  TF32 is off throughout, so
every float32 product is a float32 product.
"""

import copy
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from vaemolsim_tpu_torch import _build, coords, data
from vaemolsim_tpu_torch.config import (DistLayerConfig, ExperimentConfig,
                                        FlowedDistConfig, FlowModelConfig,
                                        MAFConfig, MappingToDistConfig,
                                        OptimizerConfig, RealNVPConfig,
                                        RegularizerConfig, RQSParams,
                                        backmapping_experiment_config,
                                        flagship_experiment_config)
from vaemolsim_tpu_torch.dists import (FlowedDistribution,
                                       IndependentBlockwise,
                                       JointBackmapping,
                                       StaticFlowedDistribution,
                                       register_von_mises_mixture)
from vaemolsim_tpu_torch.flows import RQSSplineMAF, RQSSplineRealNVP
from vaemolsim_tpu_torch.flows.spline_flows import (CouplingLayer, MAFLayer,
                                                    MaskedSplineConditioner,
                                                    _bin_positions, _slopes)
from vaemolsim_tpu_torch.mcmc import (
    MCMCState, STState, ais, bar_free_energy, cycle_moves, exp_free_energy,
    make_fused_vae_step, make_hmc_step, make_mala_step, make_mcmc_step,
    make_random_walk_step, make_st_step, mbar_from_samples,
    potential_scale_reduction, run_mcmc, run_mcmc_checkpointed, run_st,
    targeted_bar,
    targeted_work_values, tfep_loss, tune_scale, vae_proposal_fns,
    work_values)
from vaemolsim_tpu_torch.mcmc import fused as mf
from vaemolsim_tpu_torch import colvars, md, potentials
from vaemolsim_tpu_torch.models import FlowModel, VAEDualELBO
from vaemolsim_tpu_torch.nn import (FCDeepNN, SchNetPotential,
                                    VectorAttentionTwoStage,
                                    energy_force_loss, set_compute_dtype)
from vaemolsim_tpu_torch.nn.attention import VectorAttention
from vaemolsim_tpu_torch.ops import attention as pa
from vaemolsim_tpu_torch.ops import bijectors as bj
from vaemolsim_tpu_torch.ops import cell_lj, maf_fused, rqs
from vaemolsim_tpu_torch.ops import distributions as dist
from vaemolsim_tpu_torch.parallel import (REMCState, make_remc_step,
                                          run_remc, temperature_ladder)
from vaemolsim_tpu_torch.ops.fused_mlp import (dense_stack_cuda,
                                               dense_stack_members_cuda,
                                               dense_stack_plain,
                                               stack_regime)
from vaemolsim_tpu_torch.train import (CheckpointManager, fit, fit_ensemble,
                                       make_train_step,
                                       restore_checkpoint, save_checkpoint,
                                       stack_models, unstack_model)

SIZES = (10_000, 50_000)
WARMUP_STEPS, TIMED_STEPS, MC_PROFILED = 20, 200, 20
# Steps in a training path's torch.profiler window (an epoch before PR 13:
# the profiler's Python aggregation of a whole epoch took 10-45 s a path).
PROFILED_STEPS = 3
TRAIN_N, TRAIN_BATCH, TRAIN_EPOCHS = 100_000, 10_000, 5
FLOW_D = 8
BM_SITES, BM_FRAMES, BM_BATCH, BM_EPOCHS = 10_000, 2_000, 128, 5
BM_PARTICLES, PA_FRAMES = 30, 2_000
PA_MAIN = f"row notebook path N=10 H=40 Fo=20 B={PA_FRAMES}"
# (N, H, B): compute-dense, ragged, and wider than the rows regime takes.
PA_DENSE, PA_RAGGED, PA_WIDE = (50, 64, 1000), (37, 40, 300), (12, 300, 64)
# A frame beyond the rows and grid regimes' shared memory: the stream regime.
PA_STREAM = (100, 40, 2000)
# Molecular MD: the production molecular stack (bench.py:631) and the
# LJ liquid (bench.py:559), N atoms each, BAOAB with a neighbour-list
# rebuild every MD_REBUILD steps.
MD_N, MD_REBUILD, MD_TIMED, MD_NVE = 8192, 5, 200, 200
MOL = dict(rho=0.6, cutoff=3.5, skin=0.4, capacity=72, dt=0.002)
LJ = dict(rho=0.8, cutoff=2.5, skin=0.4, capacity=48, dt=0.004)
MOL_SHAPE = "molecular coulomb+exclusion"
# The sampling stack at its benchmarks' and examples' shapes: the 1-D
# RealNVP flow workload (bench.py:368), the sampler-statistics block
# (bench.py:461), molecular HMC (bench.py:521), examples 10 and 40 at
# --full, REMC and simulated tempering.
# RNVP_EPOCHS: bench.py:368 runs 10; 6 here, a depth cut (PERF.md section 4).
RNVP_N, RNVP_BATCH, RNVP_EPOCHS, RNVP_SAMPLES = 100_000, 4096, 6, 10_000
STATS_CHAINS, STATS_STEPS = 10_000, 600
HMC_CHAINS, HMC_STEPS, HMC_LEAP = 8192, 100, 10
# Molecular HMC's set-up: minimize_energy steps and tuning rounds (bench.py:521
# 1000 and 15; 500 and 8 here, a depth cut: PERF.md section 4).
HMC_MIN_STEPS, HMC_TUNE_ROUNDS = 500, 8
FE_CHAINS, FE_STEPS, FE_AIS, FE_EPOCHS = 4096, 125, 96, 6
TFEP_N, TFEP_STEPS = 20_000, 200
REMC_R, REMC_CHAINS, REMC_STEPS = 4, 1000, 50
ST_RUNGS, ST_CHAINS, ST_STEPS = 6, 2000, 2000
# Slice 9 at full width: the dual ELBO and the HVAE (5 leapfrog steps)
# on the flagship at batch 10k, the 3-block batch-norm MAF (MLE steps,
# then checkpoint and resume), example 09 at --full widths with its
# epochs cut, and the autoregressive backmapping decoder.
DUAL_EPOCHS, HVAE_EPOCHS, HVAE_LEAPFROG, HVAE_CHECK_ROWS = 3, 1, 5, 1000
HVAE_N = 20_000
BN_STEPS, CKPT_STEPS = 20, 5
ENS_K, ENS_TRAIN, ENS_VAL, ENS_BATCH, ENS_EPOCHS = 8, 25_000, 10_000, 1024, 2
ENS_NLL_GAP = 0.1
# Slice 10: examples 06 and 16 at --full (WF_*, JB_*), the ML-potential MD
# of bench.py:736 (MLP_*), the two-stage backmapping model's fit
# (TS_FIT_STEPS), the checkpointed MC (CK_*) and the bf16 MAF (BF_STEPS).
WF_FRAMES, WF_ATOMS, WF_EPOCHS, WF_BATCH, WF_GEN = 4000, 8, 18, 256, 500
JB_SYSTEMS, JB_R, JB_D, JB_STEPS, JB_SAMPLES = 4000, 6, 2, 300, 512
JB_COUPLE = 0.7
MLP_REPLICAS, MLP_ATOMS, MLP_STEPS, MLP_RHO = 256, 32, 100, 0.6
MLP_FEATURES, MLP_BLOCKS, MLP_RBF, MLP_CUTOFF, MLP_DT = 64, 3, 32, 2.5, 0.002
TS_FIT_STEPS = 15
CK_CHAINS, CK_STEPS, CK_EVERY = 50_000, 200, 50
BF_STEPS = 20
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores, and dense bfloat16 FLOP/s on the tensor cores
# (bfloat16 operands, float32 sums).
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
# The H100 SXM's boost SM clock, to turn a spin time into cycles.
SM_HZ = 1.98e9
RESULTS = {"checks": [], "mc": [], "train": [], "sampling": []}


def fail_unless(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed(fn, reps=20):
    """Mean device milliseconds of fn() over reps back-to-back calls,
    after a warm-up, by CUDA events.  The device first spins for 1.5x the
    host's time to enqueue the reps calls (``torch.cuda._sleep``, capped
    at 0.2 s), so that where the host keeps ahead of the device the
    events time the launches and not the host's enqueue between them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(1.5 * reps * host, 0.2) * SM_HZ))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name, got, want, atol, rtol, allowed_frac=0.0):
    """Max |got - want|; fails if more than ``allowed_frac`` of the
    elements exceed atol + rtol*|want| or any value is not finite."""
    got, want = got.float(), want.float()
    fail_unless(bool(torch.isfinite(got).all()), f"{name}: non-finite")
    err = (got - want).abs()
    bad = (err > atol + rtol * want.abs()).float().mean().item()
    fail_unless(bad <= allowed_frac,
                f"{name}: {bad:.2e} of elements beyond atol={atol} "
                f"rtol={rtol} (max err {err.max().item():.3e})")
    return err.max().item()


def record(kernel, shape, max_err, ms=None, plain_ms=None, **extra):
    RESULTS["checks"].append({"kernel": kernel, "shape": shape,
                              "max_abs_err": max_err, "ms": ms,
                              "plain_ms": plain_ms, **extra})
    t = "" if ms is None else f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
    t += "".join(f"  {k} {v:.4f}" if isinstance(v, float) else f"  {k} {v}"
                 for k, v in extra.items() if v is not None)
    print(f"check {kernel:12s} {shape:44s} max_abs_err {max_err:.3e}{t}",
          flush=True)


def profiled(fn):
    """Run fn() once under torch.profiler, ending in a device sync:
    (wall seconds of the call, the profile)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof


# kineto's bookkeeping events, left out as torch's own parse leaves them out.
_NOT_OPS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit", "aten::is_leaf", "aten::output_nr",
    "aten::_version"))


def events(prof):
    """The profile's events as (name, on the card, µs), read once from
    kineto's results: a kernel or copy on the card with its duration, a
    host op with its self time (its duration less that of the host ops
    nested in it on its thread, as ``key_averages`` counts it).  torch's
    own parse of the events into a tree (``key_averages``) walks every
    event in Python: ~90 s of a whole run's profiles on the H100, 41 s of
    them for one profiled HVAE step (a host stack sampler's count)."""
    if hasattr(prof, "_events"):
        return prof._events
    cuda = torch.autograd.DeviceType.CUDA
    out, host = [], {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name in _NOT_OPS:
            continue
        if e.is_async() or e.start_thread_id() != e.end_thread_id():
            continue                     # key_averages counts them as 0
        t0, t1 = e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            out.append((name, True, (t1 - t0) / 1e3))
        else:
            host.setdefault(e.start_thread_id(), []).append((t0, -t1, name))
    for evs in host.values():
        evs.sort()
        stack = []                       # [end, name, self ns]
        for t0, neg_t1, name in evs:
            t1 = -neg_t1
            while stack and (t0 >= stack[-1][0] or t1 > stack[-1][0]):
                _, done, own = stack.pop()
                out.append((done, False, own / 1e3))
            if stack:
                stack[-1][2] -= t1 - t0
            stack.append([t1, name, t1 - t0])
        out.extend((done, False, own / 1e3) for _, done, own in stack)
    prof._events = out
    return out


def copy_overlap(prof):
    """(µs of host-to-device copies on the card, µs of them during which
    a kernel ran) in a profile: how much of the copies a side stream hid
    behind compute."""
    cuda = torch.autograd.DeviceType.CUDA
    kernels, copies = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda:
            continue
        span = (e.start_ns(), e.end_ns())
        if e.name().startswith("Memcpy HtoD"):
            copies.append(span)
        elif not e.name().startswith(("Memcpy", "Memset")):
            kernels.append(span)
    busy = []                            # the kernels' union, in order
    for a, b in sorted(kernels):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    hidden = sum(max(0, min(b, kb) - max(a, ka))
                 for a, b in copies for ka, kb in busy)
    return sum(b - a for a, b in copies) / 1e3, hidden / 1e3


def device_time(prof, match=""):
    """A profile's device microseconds: (all of its kernels, those whose
    name contains ``match``); (None, None) where it holds no device
    time."""
    total = named = 0.0
    for name, on_card, us in events(prof):
        if on_card:
            total += us
            if match in name:
                named += us
    if total == 0.0:
        return None, None
    return total, named


def top_ops(prof, per=1, n=6):
    """The profile's n largest device kernels and n largest host ops by
    self time, in µs per ``per`` (for example per step)."""
    sums = ({}, {})
    for name, on_card, us in events(prof):
        d = sums[on_card]
        d[name] = d.get(name, 0.0) + us

    def top(d):
        return [(torch._C._demangle(k)[:60], us / per) for k, us in
                sorted(d.items(), key=lambda kv: -kv[1])[:n]]

    return {"device": top(sums[True]), "host": top(sums[False])}


def device_us(fn, match, reps=10):
    """torch.profiler's device microseconds per call of fn(), after a
    warm-up call: (all of its kernels, those whose name contains
    ``match``); None where the trace holds no device time."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    total, named = device_time(profiled(calls)[1], match)
    return ((None, None) if total is None
            else (total / reps, named / reps))


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------


def check_rqs(vae, gen, dev):
    """Forward and inverse, per-row and one broadcast row (the flagship
    prior's own block-0 tables), x over [-7, 7] (both identity tails).
    Kernel and plain version place knots by the same left-to-right sum,
    so they differ by FMA contraction and libm ulps: values to 1e-5 +
    1e-5|y|, log-dets to 1e-4; a fraction 1e-4 of elements may sit on a
    knot and pick the neighbouring bin (the map is C1 there)."""
    tables, range_min = mf._extract_prior(vae.prior)[0]()
    K = tables[0].shape[-1]
    for n in SIZES:
        x = (torch.rand(n, 1, generator=gen, device=dev) * 14.0 - 7.0)
        rand = [torch.randn(n, 1, k, generator=gen, device=dev)
                for k in (K, K, K - 1)]
        per_row = (_bin_positions(rand[0], -5.0, 5.0, K),
                   _bin_positions(rand[1], -5.0, 5.0, K), _slopes(rand[2]))
        shared = tuple(t[0:1] for t in tables)
        for pname, params in (("per-row", per_row), ("broadcast", shared)):
            for inverse in (False, True):
                plain = rqs.rqs_inverse_plain if inverse \
                    else rqs.rqs_forward_plain
                got = rqs.rqs_cuda(x, *params, range_min, inverse)
                want = plain(x, *params, range_min)
                err = max(compare("rqs value", got[0], want[0], 1e-5, 1e-5,
                                  1e-4),
                          compare("rqs ldj", got[1], want[1], 1e-4, 0.0,
                                  1e-4))
                ms = timed(lambda: rqs.rqs_cuda(x, *params, range_min,
                                                inverse))
                plain_ms = timed(lambda: plain(x, *params, range_min))
                shape = (f"{'inverse' if inverse else 'forward'} {pname} "
                         f"N={n} K={K}")
                record("rqs", shape, err, ms, plain_ms,
                       plan=rqs.kernel_plan(n, K, params[0].shape[0]))


def check_dense_stack(vae, gen, dev):
    """The flagship encoder (2->200->2 relu) and decoder (1->200->4 relu)
    with their own weights; 1->200->95 tanh with and without a 3-wide
    conditional input; the backmapping decoder's widths (20->40->9 relu);
    and the one-row merged MAF conditioner (1->600->95 tanh), also at 16
    and 17 rows (the small-N regime's limit and one past it).  Float32
    sums of up to 600 terms in another order than cuBLAS's: 1e-4 +
    1e-4|y|.  Each check names the regime the kernel ran; the one-row
    conditioner is timed against the library chain that computes it
    (``torch.addmm``, ``tanh``, ``torch.addmm``) in the same run."""
    def weights(dims, cond_dim=0):
        ks = [torch.randn(a, b, generator=gen, device=dev) / math.sqrt(a)
              for a, b in zip(dims[:-1], dims[1:])]
        bs = [0.1 * torch.randn(b, generator=gen, device=dev)
              for b in dims[1:]]
        cks = (None if not cond_dim else
               [torch.randn(cond_dim, b, generator=gen, device=dev) * 0.3
                for b in dims[1:]])
        return ks, bs, cks

    def own(m2d):
        lyr, head = m2d.mapping.layers[0], m2d.mapping.head
        return ([lyr.kernel.detach(), head.kernel.detach()],
                [lyr.bias.detach(), head.bias.detach()], None)

    cond = vae.prior.flow.blocks[0].conditioner
    k1, b1, k2, b2, _, _ = cond.merged_params()
    cases = [
        ("encoder 2->200->2 relu", 2, own(vae.encoder), ["relu", None], 0,
         SIZES),
        ("decoder 1->200->4 relu", 1, own(vae.decoder), ["relu", None], 0,
         SIZES),
        ("1->200->95 tanh", 1, weights([1, 200, 95]), ["tanh", None], 0,
         SIZES),
        ("1->200->95 tanh cond 3", 1, weights([1, 200, 95], 3),
         ["tanh", None], 3, SIZES),
        ("backmapping decoder 20->40->9 relu", 20,
         weights([20, 40, 9]), ["relu", None], 0, (BM_BATCH, BM_SITES)),
        ("MAF conditioner 1->600->95 tanh", 1,
         ([k1.detach(), k2.detach()], [b1.detach(), b2.detach()], None),
         ["tanh", None], 0, (1, 16, 17)),
    ]
    for name, din, (ks, bs, cks), acts, dc, sizes in cases:
        for n in sizes:
            x = torch.randn(n, din, generator=gen, device=dev)
            c = (torch.randn(n, dc, generator=gen, device=dev) if dc
                 else None)
            got = dense_stack_cuda(x, ks, bs, acts, c, cks)
            want = dense_stack_plain(x, ks, bs, acts, c, cks)
            err = compare(name, got, want, 1e-4, 1e-4)
            ms = plain_ms = None
            extra = {}
            tiled_row = name.startswith("backmapping decoder")
            if n in (SIZES[-1], 1) or tiled_row:
                ms = timed(lambda: dense_stack_cuda(x, ks, bs, acts, c, cks))
                plain_ms = timed(lambda: dense_stack_plain(x, ks, bs, acts,
                                                           c, cks))
            if tiled_row:
                _, extra["device_us"] = device_us(
                    lambda: dense_stack_cuda(x, ks, bs, acts, c, cks),
                    "dense_")
                extra["plain_device_us"], _ = device_us(
                    lambda: dense_stack_plain(x, ks, bs, acts, c, cks), "")
                extra["bound_us"], extra["bound_by"] = stack_bound(n, ks, bs)
            if n == 1:
                (w1, w2), (c1, c2) = ks, bs
                extra["library_ms"] = timed(lambda: torch.addmm(
                    c2, torch.tanh(torch.addmm(c1, x, w1)), w2))
            regime = stack_regime(n, [din] + [k.shape[1] for k in ks], dc)[0]
            record("dense_stack", f"{name} N={n}", err, ms, plain_ms,
                   regime=regime, **extra)


def stack_bound(n, ks, bs):
    """(bound µs, what bounds it) of a dense stack over n rows: inputs,
    weights and biases read once and the output written once, against 2
    operations per weight per row."""
    nbytes = 4 * (n * (ks[0].shape[0] + ks[-1].shape[1])
                  + sum(k.numel() for k in ks) + sum(b.numel() for b in bs))
    return _bound(nbytes, 2 * n * sum(k.numel() for k in ks))


def _proposal_args(vae):
    enc_w, enc_act, _, d_z = mf._extract_mlp(vae.encoder, "encoder")
    dec_w, dec_act, _, d_x = mf._extract_mlp(vae.decoder, "decoder")
    tables_fn, base = mf._extract_prior(vae.prior)
    tables, range_min = tables_fn()
    spec = mf._Spec(d_x, d_z, enc_act, dec_act, tables[0].shape[-1],
                    float(range_min))
    detach = lambda ts: tuple(t.detach() for t in ts)  # noqa: E731
    return detach(enc_w), detach(dec_w), detach(tables), base, spec


def check_proposal(vae, gen, dev):
    """Noise-input mode and in-kernel Philox, all five outputs, against
    the plain version (which draws the same Philox stream): samples to
    1e-4 + 1e-4|v|, log-densities to 1e-3 + 1e-4|v| (sums of six
    log-probs of O(10) each); a fraction 1e-4 may take a neighbouring
    spline bin at a knot."""
    enc_w, dec_w, tables, base, spec = _proposal_args(vae)
    names = ("x2", "fwd", "rev", "z1", "z2")
    for n in SIZES:
        x1 = torch.randn(n, spec.d_x, generator=gen, device=dev)
        seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (2,), generator=gen,
                             dtype=torch.int32, device=dev)
        noise = torch.randn(n, 2 + spec.d_x, generator=gen, device=dev)
        for mode, nz in (("noise input", noise), ("philox", None)):
            args = (x1, seed, enc_w, dec_w, tables, base, spec, nz)
            got = mf.vae_proposal_cuda(*args)
            want = mf.vae_proposal_plain(*args)
            err = 0.0
            for name, g, w in zip(names, got, want):
                dens = name in ("fwd", "rev")
                err = max(err, compare(f"proposal {mode} {name}", g, w,
                                       1e-3 if dens else 1e-4, 1e-4, 1e-4))
            ms = timed(lambda: mf.vae_proposal_cuda(*args))
            plain_ms = timed(lambda: mf.vae_proposal_plain(*args))
            H, (B, K) = enc_w[0].shape[1], tables[0].shape
            record("vae_proposal", f"{mode} N={n} H={H} K={K} B={B}", err,
                   ms, plain_ms,
                   plan=mf.kernel_plan(n, spec.d_x, H, B, K))
    return x1, seed, (enc_w, dec_w, tables, base, spec)


def check_philox_samples(vae, x1, seed, args):
    """For the kernel's own Philox draws: fwd and rev recomputed through
    the model's distribution objects (a CPU copy, so the plain path) at
    its (x1, z1, z2, x2), to 2e-3 + 1e-4|v| on all but 1e-4 of chains;
    and the normals it drew, recovered from its samples, with the mean
    and variance of a standard normal within 5 standard errors and
    cross-correlations below 5/sqrt(N)."""
    enc_w, dec_w, tables, base, spec = args
    x2, fwd, rev, z1, z2 = mf.vae_proposal_cuda(x1, seed, enc_w, dec_w,
                                                tables, base, spec)
    cpu = copy.deepcopy(vae).to("cpu")
    x1, x2, fwd, rev, z1, z2 = (t.cpu() for t in (x1, x2, fwd, rev, z1, z2))
    with torch.no_grad():
        enc1, prior = cpu.encoder(x1), cpu._prior_dist(z1, False)
        dec2 = cpu.decoder(z2)
        want_fwd = (enc1.log_prob(z1) + prior.log_prob(z2)
                    + dec2.log_prob(x2))
        want_rev = (cpu.encoder(x2).log_prob(z2) + prior.log_prob(z1)
                    + cpu.decoder(z1).log_prob(x1))
        err = max(compare("philox fwd vs distributions", fwd, want_fwd,
                          2e-3, 1e-4, 1e-4),
                  compare("philox rev vs distributions", rev, want_rev,
                          2e-3, 1e-4, 1e-4))
        f0 = enc1.families[0]
        u = prior.bijector.inverse(z2)
        fx = dec2.families[0]
        eps = torch.cat([(z1 - f0.loc) / f0.scale,
                         (u - cpu.prior.base_loc) / cpu.prior.base_scale,
                         (x2 - fx.loc) / fx.scale], -1).double()
    n = eps.shape[0]
    mean, var = eps.mean(0), eps.var(0)
    corr = torch.corrcoef(eps.T) - torch.eye(eps.shape[1],
                                             dtype=torch.float64)
    fail_unless(bool((mean.abs() < 5 / math.sqrt(n)).all()),
                f"Philox normals mean {mean.tolist()}")
    fail_unless(bool(((var - 1).abs() < 5 * math.sqrt(2 / n)).all()),
                f"Philox normals variance {var.tolist()}")
    fail_unless(bool((corr.abs() < 5 / math.sqrt(n)).all()),
                f"Philox normals correlation {corr.abs().max().item()}")
    record("vae_proposal", f"philox densities+moments N={n}", err)
    print(f"philox normals: mean {[round(v, 4) for v in mean.tolist()]} "
          f"var {[round(v, 4) for v in var.tolist()]}", flush=True)
    return err


def check_maf_block(flow, gen, dev, label=""):
    """Inverse and forward at D=8 (the flow model's own block-0 weights)
    and at D=3, with and without a 5-wide context (fresh conditioners at
    the reference widths), N=10k, and N=777 once; y of spread 4 reaches
    both identity tails of [-10, 10].  Against the plain version: values
    to 1e-4 + 1e-4|v|, log-dets to 1e-3 + 1e-4|v| (sums of 600 products
    in another order than cuBLAS's, through steep bins), a fraction 1e-4
    of elements allowed a neighbouring bin at a knot.  At D=8 and 10k
    rows the unfused route is held to the same tolerances, and the
    kernel, its plain version and the unfused route
    (``MAFLayer.unfused_and_log_det``: dense-stack and RQS kernels) are
    timed."""
    cases = [("D=8", flow.flowed_dist.flow.blocks[0], 0, (TRAIN_BATCH, 777))]
    if not label:
        cases += [
            ("D=3", MAFLayer(MaskedSplineConditioner.create(
                gen, 3, device=dev)), 0, (TRAIN_BATCH,)),
            ("D=3 ctx 5", MAFLayer(MaskedSplineConditioner.create(
                gen, 3, conditional=True, conditional_event_shape=5,
                device=dev)), 5, (TRAIN_BATCH,))]
    for name, layer, dc, sizes in cases:
        cond = layer.conditioner
        params = [p.detach() for p in cond.merged_params() if p is not None]
        D, K = cond.w_net.event_size, cond.num_bins
        deg = cond.w_net.input_order_static
        for n in sizes:
            y = 4.0 * torch.randn(n, D, generator=gen, device=dev)
            ctx = torch.randn(n, dc, generator=gen, device=dev) if dc else None
            for inverse in (True, False):
                args = (y, params, ctx, D, K, cond.bin_min, cond.bin_max,
                        inverse)

                def kernel():
                    return maf_fused.maf_block_cuda(*args, degrees=deg)

                got = kernel()
                want = maf_fused.maf_block_plain(*args)
                err = max(compare(f"maf_block {name} x", got[0], want[0],
                                  1e-4, 1e-4, 1e-4),
                          compare(f"maf_block {name} ldj", got[1], want[1],
                                  1e-3, 1e-4, 1e-4))
                extra = {}
                ms = plain_ms = None
                if name == "D=8" and n == TRAIN_BATCH:
                    unf = layer.unfused_and_log_det(y, ctx, inverse)
                    compare(f"unfused {name} x", unf[0], want[0], 1e-4,
                            1e-4, 1e-4)
                    compare(f"unfused {name} ldj", unf[1], want[1], 1e-3,
                            1e-4, 1e-4)
                    if not label:
                        ms = timed(kernel)
                        plain_ms = timed(
                            lambda: maf_fused.maf_block_plain(*args))
                        extra["unfused_ms"] = timed(
                            lambda: layer.unfused_and_log_det(y, ctx,
                                                              inverse))
                        _, extra["device_us"] = device_us(
                            kernel, "maf_block_kernel")
                        extra["plain_device_us"], _ = device_us(
                            lambda: maf_fused.maf_block_plain(*args), "")
                        extra["unfused_device_us"], _ = device_us(
                            lambda: layer.unfused_and_log_det(y, ctx,
                                                              inverse), "")
                direction = "inverse" if inverse else "forward"
                record("maf_block", f"{direction} {name} N={n}{label}", err,
                       ms, plain_ms, **extra)


def backmapping_frames(n, seed, dev):
    """examples/04_backmapping.py's synthetic frames, made with numpy:
    30 particles of spread 1.5 with 2-wide info around a CG site of
    spread 0.3, and three torsions whose mean depends on the number of
    particles within 3.0 of the site, wrapped to [-pi, pi]."""
    rng = np.random.default_rng(seed)
    coords = 1.5 * rng.normal(size=(n, BM_PARTICLES, 3))
    info = rng.normal(size=(n, BM_PARTICLES, 2))
    ref = 0.3 * rng.normal(size=(n, 3))
    count = (np.linalg.norm(coords - ref[:, None], axis=-1) < 3.0).sum(-1)
    tors = ((count % 5 - 2.0) * 0.8)[:, None] + 0.3 * rng.normal(size=(n, 3))
    tors = tors - 2 * np.pi * np.round(tors / (2 * np.pi))
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in (ref, coords, info, tors))


def pair_attention_work(B, N, H, Fo, mask, reduce):
    """(bytes, least float32 operations) of one pair-attention call on
    these inputs: each input read once and the output written once; per
    valid pair (m_i m_j = 1) the invariants (~20), the two trunks (4
    FMAs and 2 adds per hidden unit each: 20 H), the score head (2 H),
    LayerNorm (~8 H), the softmax (~5) and the weighted accumulation of
    the value trunk (2 H); the value head, which is linear, once per
    valid row (per non-empty frame with reduce): 2 H Fo.  Also the count
    with the value head taken per pair (2 H Fo + 2 Fo per valid pair),
    as a kernel that does not fold it through the contraction would."""
    m = mask.double()
    rows = m.sum(-1)
    pairs = float((rows * rows).sum())
    heads = float((rows > 0).sum()) if reduce else float(rows.sum())
    out = B * Fo if reduce else B * N * Fo
    nbytes = 4 * (B * N * 3 + B * N + 4 * B * N * H
                  + 13 * H + H * Fo + Fo + 1 + out)
    per_pair = 32 * H + 25
    return (nbytes, pairs * per_pair + heads * 2 * H * Fo,
            pairs * (per_pair + 2 * H * Fo + 2 * Fo))


def check_pair_attention(bm, gen, dev):
    """The pair-attention kernel against its plain version: atol 1e-5 +
    rtol 1e-5 (LayerNorm, softmax and contraction sums of up to N^2 =
    2500 terms in another order; the kernel also folds the value head
    through the contraction), every element; fully masked rows and
    clouds exactly zero.  Shapes: the notebook's (N = 10, F = Fo = 20,
    H = 40, B = 2000) through the model's own block-0 and final
    attention layers, on the path's own selections and masks (timed),
    and with a random mask; the compute-dense N = 50, H = 64, B = 1000
    and a ragged N = 37, H = 40, B = 300 (both timed); H = 300 (the grid
    regime: wider than the rows regime takes); each in both modes."""
    ref, coords, info, _ = backmapping_frames(PA_FRAMES, 21, dev)
    lpd = bm.mask_and_embed
    sel, valid, sel_info = lpd.select(coords, ref, particle_info=info)
    values = lpd.embed.info_net(sel_info)

    def random_mask(B, N):
        m = (torch.rand(B, N, generator=gen, device=dev) > 0.3).float()
        m[0, 1] = 0.0  # a fully masked row
        m[1] = 0.0     # a fully masked cloud
        return m

    def fresh(N, H, B):
        attn = VectorAttention.create(gen, 20, 20, hidden_dim=H, device=dev)
        for p in attn.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, device=dev))
        return (attn, 1.5 * torch.randn(B, N, 3, generator=gen, device=dev),
                torch.randn(B, N, 20, generator=gen, device=dev),
                random_mask(B, N))

    blocks = lpd.embed.blocks[0].attn, lpd.embed.final_attn
    nb = f"N=10 H=40 Fo=20 B={PA_FRAMES}"
    cases = [(f"notebook path {nb}", blocks, sel, values, valid.float(),
              True)]
    # The same layers at serving's 10k sites (one frame each).
    ref10, coords10, info10, _ = backmapping_frames(BM_SITES, 26, dev)
    sel10, valid10, info10 = lpd.select(coords10, ref10, particle_info=info10)
    cases.append((f"notebook path N=10 H=40 Fo=20 B={BM_SITES}", blocks,
                  sel10, lpd.embed.info_net(info10), valid10.float(), True))
    cases.append((f"notebook random mask {nb}", blocks, sel, values,
                  random_mask(PA_FRAMES, 10), False))
    for label, (N, H, B), timed_case in (("dense", PA_DENSE, True),
                                         ("ragged", PA_RAGGED, True),
                                         ("wide", PA_WIDE, False),
                                         ("stream", PA_STREAM, True)):
        attn, c, v, m = fresh(N, H, B)
        cases.append((f"{label} N={N} H={H} Fo=20 B={B}", (attn, attn),
                      c, v, m, timed_case))
    for shape, (row_attn, red_attn), c, v, m, timed_case in cases:
        for reduce in (False, True):
            base = red_attn if reduce else row_attn
            pair_attention_case(shape, base, c, v, m, reduce, timed_case)


def pair_attention_case(shape, base, c, v, m, reduce, timed_case):
    """One case of check_pair_attention: the layer ``base``'s weights in
    mode ``reduce`` on coordinates c, values v and float mask m; timed
    with its plan and bound where ``timed_case``."""
    attn = VectorAttention(base.score_net, base.value_net, reduce)
    (c_, *nodes, mf, weights), kw = attn.pair_args(c, v, m)
    args = (c_, *nodes, mf, *weights)
    got = pa.pair_attention_cuda(*args, **kw)
    want = pa.pair_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    err = compare(f"pair_attention {shape} reduce={reduce}", got, want, 1e-5,
                  1e-5)
    empty = (m.sum(-1) == 0) if reduce else (m == 0)
    if bool(empty.any()):
        fail_unless(float(got[empty].abs().max()) == 0.0,
                    f"pair_attention {shape}: masked outputs not exactly "
                    "zero")
    ms = plain_ms = None
    extra = {}
    if timed_case:
        ms = timed(lambda: pa.pair_attention_cuda(*args, **kw))
        plain_ms = timed(lambda: pa.pair_attention_plain(*args, **kw))
        _, extra["device_us"] = device_us(
            lambda: pa.pair_attention_cuda(*args, **kw),
            "pair_attention_kernel")
        extra["plain_device_us"], _ = device_us(
            lambda: pa.pair_attention_plain(*args, **kw), "")
        B, N = m.shape
        nbytes, ops, per_pair_ops = pair_attention_work(
            B, N, nodes[0].shape[-1], got.shape[-1], m, reduce)
        extra["bound_us"], by = _bound(nbytes, ops)
        extra["per_pair_head_bound_us"], _ = _bound(nbytes, per_pair_ops)
        plan = pa.kernel_plan(B, N, nodes[0].shape[-1], got.shape[-1])
        lanes = ("" if plan["regime"] == "grid" else
                 f"{plan['lanes']} lanes x {plan['units']} units, ")
        extra["plan"] = (f"{plan['regime']}: {lanes}"
                         f"{plan['frames']} frames a block, "
                         f"{plan['blocks']} blocks, {plan['smem']} B shared")
        RESULTS.setdefault("pair_attention_bound_by", {})[
            f"{'reduce' if reduce else 'row'} {shape}"] = by
    record("pair_attention", f"{'reduce' if reduce else 'row'} {shape}", err,
           ms, plain_ms, **extra)


# ---------------------------------------------------------------------------
# The main paths: both MC steps on the full-width flagship, then training
# ---------------------------------------------------------------------------


def log_target(x):
    return -0.5 * (x ** 2).sum(-1)


def run_path(name, step, dev):
    """Warm-up and timed steps at each size; returns the launch counts of
    this path's run.  Counters are zeroed just before and read just
    after."""
    _build.reset_launches()
    for n in SIZES:
        gen = torch.Generator(device=dev).manual_seed(1)
        x0 = torch.randn(n, 2, generator=gen, device=dev)
        state = MCMCState.create(x0, log_target(x0),
                                 torch.Generator(device=dev).manual_seed(2))
        state, _ = run_mcmc(step, state, WARMUP_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_mcmc(step, state, TIMED_STEPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        acc = float(state.acceptance_rate)
        m2 = float((state.configs.double() ** 2).mean())
        steps = WARMUP_STEPS + TIMED_STEPS
        fail_unless(0.0 < acc < 1.0, f"{name} N={n} acceptance {acc}")
        fail_unless(bool(torch.isfinite(state.energies).all()
                         and torch.isfinite(state.configs).all()),
                    f"{name} N={n}: non-finite chains")
        # Chains start at the target and MH keeps it: E[x^2] = 1, with a
        # standard error of 1/sqrt(n) over 2n coordinates (x^2 has
        # variance 2); 6 standard errors.
        fail_unless(abs(m2 - 1.0) < 6.0 / math.sqrt(n),
                    f"{name} N={n}: second moment {m2}")
        fail_unless(int(state.num_trials) == n * steps,
                    f"{name} N={n}: {int(state.num_trials)} trials")
        rate = n * TIMED_STEPS / dt
        row = {"path": name, "chains": n, "steps": TIMED_STEPS,
               "seconds": dt, "proposals_per_s": rate, "acceptance": acc,
               "second_moment": m2}
        busy = ""
        if n == SIZES[-1]:
            # Device busy per step from a profiled window of MC_PROFILED
            # steps (the profiler adds host time: the window's own wall
            # time gives the idle share).
            window_s, prof = profiled(lambda: run_mcmc(step, state,
                                                       MC_PROFILED))
            busy_us, _ = device_time(prof)
            window_ms = 1e3 * window_s / MC_PROFILED
            if busy_us is not None:
                row["device_busy_ms_per_step"] = busy_us / 1e3 / MC_PROFILED
                row["device_idle_share"] = (
                    1.0 - row["device_busy_ms_per_step"] / window_ms)
                busy = (f"  device busy {row['device_busy_ms_per_step']:.3f}"
                        f" of {window_ms:.3f} ms/step profiled "
                        f"({row['device_idle_share']:.3f} idle)")
        RESULTS["mc"].append(row)
        print(f"mc {name:8s} N={n:6d} {rate:14.1f} proposals/s  "
              f"({dt * 1e3 / TIMED_STEPS:.3f} ms/step)  acceptance "
              f"{acc:.4f}  E[x^2] {m2:.4f}{busy}", flush=True)
    return path_counts(name)


def two_mode_data(dev):
    """100k points whose coordinates each come from an equal mixture of
    N(-2, 0.5^2) and N(2, 0.5^2) (examples/02_train_vae.py's data)."""
    rng = np.random.default_rng(0)
    x = (np.where(rng.random((TRAIN_N, 2)) < 0.5, -2.0, 2.0)
         + 0.5 * rng.normal(size=(TRAIN_N, 2)))
    return torch.tensor(x, dtype=torch.float32, device=dev)


def gaussian_data(dev):
    """100k points of an 8-D correlated Gaussian: means in [-1.5, 1.5],
    covariance A A^T / 8 + I/2."""
    rng = np.random.default_rng(1)
    mean = rng.uniform(-1.5, 1.5, FLOW_D)
    a = rng.normal(size=(FLOW_D, FLOW_D))
    cov = a @ a.T / FLOW_D + 0.5 * np.eye(FLOW_D)
    x = rng.multivariate_normal(mean, cov, size=TRAIN_N)
    return torch.tensor(x, dtype=torch.float32, device=dev)


def train_path(name, model, loss_fn, data, dev, batch=TRAIN_BATCH,
               epochs=TRAIN_EPOCHS, profiled_steps=None):
    """A warm-up epoch, then ``epochs`` epochs of fit() at ``batch`` with
    Adam 1e-3, counters zeroed just before and read just after the timed
    run; checks finite losses, the last epoch's mean below the warm-up
    epoch's, and reports steps/s, ms per step and peak memory.  The
    profiled window is one more epoch, or ``profiled_steps`` steps where
    a step holds so many launches that the profiler's bookkeeping of a
    whole epoch would take minutes.  By default the window is
    PROFILED_STEPS steps (or the epoch, if shorter)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    adam = OptimizerConfig("adam", 1e-3).build()
    _, warm = fit(model, loss_fn, data, generator=gen, num_epochs=1,
                  batch_size=batch, optimizer=adam)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    _, hist = fit(model, loss_fn, data, generator=gen, num_epochs=epochs,
                  batch_size=batch, optimizer=adam)
    counts = path_counts(name)
    peak = torch.cuda.max_memory_allocated()
    losses = warm["loss"] + hist["loss"]
    fail_unless(all(math.isfinite(v) for v in losses),
                f"{name}: non-finite loss {losses}")
    fail_unless(hist["loss"][-1] < warm["loss"][0],
                f"{name}: loss did not fall: {losses}")
    n = (data[0] if isinstance(data, tuple) else data).shape[0]
    per_epoch = n // batch
    steps = epochs * per_epoch
    seconds = sum(hist["epoch_time_s"])
    ms_per_step = 1e3 * seconds / steps
    # One more epoch of fit() under torch.profiler: its device-busy time
    # and its wall time both come from this one window.  The profiler
    # adds host time, so the window's ms/step is kept beside the
    # unprofiled one.
    window = min(per_epoch, PROFILED_STEPS if profiled_steps is None
                 else profiled_steps)
    window_data = (tuple(a[:window * batch] for a in data)
                   if isinstance(data, tuple) else data[:window * batch])
    window_s, prof = profiled(lambda: fit(
        model, loss_fn, window_data, generator=gen, num_epochs=1,
        batch_size=batch, optimizer=adam))
    busy_us, _ = device_time(prof)
    tops = top_ops(prof, window)
    window_ms = 1e3 * window_s / window
    busy_ms = None if busy_us is None else busy_us / 1e3 / window
    row = {"path": name, "batch": batch, "steps": steps,
           "seconds": seconds, "steps_per_s": steps / seconds,
           "ms_per_step": ms_per_step, "losses": losses,
           "peak_memory_bytes": peak, "launches": counts,
           "profiled_ms_per_step": window_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": (None if busy_ms is None
                                 else 1.0 - busy_ms / window_ms),
           "top_ops_us_per_step": tops}
    RESULTS["train"].append(row)
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} of {window_ms:.3f} ms/step in a profiled epoch "
            f"({row['device_idle_share']:.3f} idle)")
    print(f"train {name:6s} batch {batch} {row['steps_per_s']:.3f} "
          f"steps/s ({ms_per_step:.3f} ms/step)  device busy {busy}  peak "
          f"memory {peak / 2 ** 20:.1f} MiB  loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}", flush=True)
    for side in ("device", "host"):
        print(f"  profiled {name} step, top {side} µs: " + "; ".join(
            f"{k} {us:.1f}" for k, us in tops[side]), flush=True)
    return row


def _off_knots(spline, t, inverse, margin):
    """Rows of t (N, D) more than ``margin`` from every knot of
    ``spline`` on its input side."""
    x_knots, y_knots = rqs._knots(spline.bin_widths, spline.bin_heights,
                                  spline.range_min)
    knots = y_knots if inverse else x_knots
    return ((t[..., None] - knots).abs().amin(-1) > margin).all(-1)


def knot_safe(layers, y, inverse=True, margin=1e-4, context=None):
    """A CPU mask of the rows of y (N, D) whose spline input lies more
    than ``margin`` from every knot, the ends of the bin range included,
    in every pass of the MAF or coupling ``layers`` (with their
    ``context`` (N, C) where they are conditional) applied in turn in one
    direction (a flow's density pass: its blocks last first,
    ``inverse=True``), evaluated on CPU copies.  At a knot the spline is
    C1, but its gradient with respect to the bin parameters jumps; a row
    that float32 roundoff (~1e-5 here) puts in the neighbouring bin on
    one device changes a mean gradient by O(1)/N, whichever device is
    right."""
    y = y.cpu()
    ctx = None if context is None else context.cpu()
    keep = torch.ones(y.shape[0], dtype=torch.bool)
    with torch.no_grad():
        for layer in layers:
            layer = copy.deepcopy(layer).to("cpu")
            if isinstance(layer, CouplingLayer):
                cond, rest, _ = layer._split(y)
                keep &= _off_knots(layer._spline(cond), rest, inverse,
                                   margin)
                y = (layer.inverse_and_log_det if inverse
                     else layer.forward_and_log_det)(y)[0]
                continue
            cur = y
            for _ in range(1 if inverse
                           else layer.conditioner.w_net.event_size):
                spline = layer._spline(cur, ctx)
                keep &= _off_knots(spline, y, inverse, margin)
                cur = spline.forward(y)
            y = layer.unfused_and_log_det(y, ctx, inverse)[0]
    return keep


def rows_off_knots(flow, y, context=None, min_share=0.99):
    """knot_safe over the flow's density pass, on y's device; fails
    unless it keeps more than ``min_share`` of the rows."""
    keep = knot_safe(reversed(list(flow.blocks)), y, context=context)
    fail_unless(float(keep.float().mean()) > min_share,
                f"only {int(keep.sum())} of {keep.numel()} rows away from "
                "the knots")
    print(f"rows away from the knots: {int(keep.sum())} of {keep.numel()}",
          flush=True)
    return keep.to(y.device)


def check_grads(name, model, loss_of, dev, atol=1e-4, rtol=1e-3):
    """Every parameter's gradient of loss_of(model) on the card (kernels
    forward, plain recompute backward) against a CPU copy's (plain
    throughout): 1e-4 + 1e-3|g| by default, on rows away from the spline
    knots (see knot_safe)."""
    cpu = copy.deepcopy(model).to("cpu")
    got = torch.autograd.grad(loss_of(model, dev), list(model.parameters()))
    want = torch.autograd.grad(loss_of(cpu, torch.device("cpu")),
                               list(cpu.parameters()))
    err = max(compare(f"{name} gradient {i}", g.cpu(), w, atol, rtol)
              for i, (g, w) in enumerate(zip(got, want)))
    print(f"gradients {name}: {len(got)} parameters, max abs err "
          f"{err:.3e}", flush=True)
    RESULTS.setdefault("gradients", {})[name] = err
    return err


def elbo_path(dev):
    """Training path 1: the flagship VAE (built with no device: on the
    card) by its ELBO."""
    vae = flagship_experiment_config().build()
    fail_unless(next(vae.parameters()).device.type == dev.type,
                "build() with no device did not build on the card")
    data = two_mode_data(dev)
    row = train_path("elbo", vae, lambda m, b, g: m.elbo_loss(b, g), data,
                     dev)
    fail_unless(row["launches"]["rqs"] > 0
                and row["launches"]["dense_stack"] > 0,
                f"ELBO path launch counts {row['launches']}")
    eps = torch.randn(TRAIN_BATCH, 1,
                      generator=torch.Generator(device=dev).manual_seed(12),
                      device=dev)
    with torch.no_grad():
        f = vae.encoder(data[:TRAIN_BATCH]).families[0]
        keep = rows_off_knots(vae.prior.flow, f.loc + f.scale * eps)
    x, eps = data[:TRAIN_BATCH][keep], eps[keep]

    def elbo_at(m, d):
        """The ELBO at fixed encoder normals (the same on both devices)."""
        xd = x.to(d)
        enc = m.encoder(xd, train=True)
        f = enc.families[0]
        z = f.loc + f.scale * eps.to(d)
        prior = m._prior_dist(z, True)
        return (-m.decoder(z, train=True).log_prob(xd).mean()
                + m.regularizer(enc, prior, samples=z))

    check_grads("elbo", vae, elbo_at, dev)
    return row


def moment_distance(x, data):
    x, data = x.double(), data.double()
    return float((x.mean(0) - data.mean(0)).norm()
                 + (torch.cov(x.T) - torch.cov(data.T)).norm())


def flow_path(flow, dev):
    """Training path 2: the D=8 MAF flow model by maximum likelihood,
    then sampling 10k points (MAF-block kernel forward)."""
    data = gaussian_data(dev)
    probe = torch.zeros(TRAIN_BATCH, FLOW_D, device=dev)
    sample_gen = torch.Generator(device=dev).manual_seed(13)
    with torch.no_grad():
        before = moment_distance(flow.predict(probe, sample_gen), data)
    row = train_path("flow", flow, lambda m, b, g: -m.log_prob(b).mean(),
                     data, dev)
    fail_unless(row["launches"]["maf_block"] > 0,
                f"flow training launch counts {row['launches']}")
    _build.reset_launches()
    with torch.no_grad():
        samples = flow.predict(probe, sample_gen)
    predict_counts = path_counts("flow_path")
    fail_unless(predict_counts["maf_block"] > 0,
                f"flow sampling launch counts {predict_counts}")
    fail_unless(bool(torch.isfinite(samples).all())
                and samples.shape == (TRAIN_BATCH, FLOW_D),
                "flow samples not finite or of the wrong shape")
    after = moment_distance(samples, data)
    fail_unless(after < before, f"flow samples' moments did not move toward "
                f"the data's: distance {before} -> {after}")
    with torch.no_grad():
        ms = timed(lambda: flow.predict(probe, sample_gen), reps=10)
    row.update(predict_launches=predict_counts, samples_per_s=
               TRAIN_BATCH / (ms * 1e-3), predict_ms=ms,
               moment_distance=[before, after])
    print(f"sample flow N={TRAIN_BATCH} {row['samples_per_s']:.1f} "
          f"samples/s ({ms:.4f} ms)  moment distance {before:.4f} -> "
          f"{after:.4f}", flush=True)
    x = data[:TRAIN_BATCH]
    x = x[rows_off_knots(flow.flowed_dist.flow, x)]
    check_grads("flow", flow, lambda m, d: -m.log_prob(x.to(d)).mean(), dev)
    return row, predict_counts


def backmapping_path(dev):
    """The backmapping path on the notebook's model, built with no device
    (on the card): serving (``predict`` and ``log_prob`` at 10k CG
    sites, one frame each, then ``log_prob`` of rotated frames) and
    training (``fit`` at batch 128 on 2000 frames), each with the
    counters zeroed just before and read just after; gradients against
    a CPU copy on rows whose flow inputs lie away from the spline knots.
    Returns (serving row, training row)."""
    bm = backmapping_experiment_config().build()
    fail_unless(next(bm.parameters()).device.type == dev.type,
                "build() with no device did not build on the card")
    ref, coords, info, tors = backmapping_frames(BM_SITES, 22, dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    reps = 10
    with torch.no_grad():
        bm.predict(ref, coords, info, gen)
        bm.log_prob(ref, coords, info, tors)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            samples = bm.predict(ref, coords, info, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            lp = bm.log_prob(ref, coords, info, tors)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = path_counts("backmapping_path", expect=("pair_attention",))
        predict_wall, prof = profiled(lambda: bm.predict(ref, coords, info,
                                                         gen))
        busy_us, pa_us = device_time(prof, "pair_attention_kernel")
        R = torch.tensor(np.linalg.qr(np.random.default_rng(24).normal(
            size=(3, 3)))[0], dtype=torch.float32, device=dev)
        lp_rot = bm.log_prob(ref @ R.T, coords @ R.T, info, tors)
    fail_unless(all(counts[k] > 0 for k in ("pair_attention", "maf_block",
                                            "dense_stack")),
                f"backmapping serving launch counts {counts}")
    fail_unless(samples.shape == (BM_SITES, 3)
                and bool(torch.isfinite(samples).all())
                and bool((samples.abs() <= math.pi + 1e-5).all()),
                "sampled torsions not finite, of the wrong shape or outside "
                "[-pi, pi]")
    fail_unless(lp.shape == (BM_SITES,) and bool(torch.isfinite(lp).all()),
                "backmapping log_prob not finite or of the wrong shape")
    # Rotating every frame and its CG site together leaves every
    # selection and invariant unchanged up to float32 roundoff; a site
    # with a particle within roundoff of the cutoff or of a top-k tie may
    # select otherwise (1e-3 of the sites allowed).
    rot_err = compare("log_prob under rotation", lp_rot, lp, 1e-4, 1e-4,
                      1e-3)
    serve = {"sites": BM_SITES, "predict_ms": 1e3 * (t1 - t0) / reps,
             "log_prob_ms": 1e3 * (t2 - t1) / reps,
             "predict_sites_per_s": BM_SITES * reps / (t1 - t0),
             "log_prob_sites_per_s": BM_SITES * reps / (t2 - t1),
             "launches": counts, "rotation_max_abs_err": rot_err,
             "profiled_predict_ms": 1e3 * predict_wall,
             "predict_device_busy_ms": (None if busy_us is None
                                        else busy_us / 1e3),
             "predict_pair_attention_device_ms": (None if pa_us is None
                                                  else pa_us / 1e3),
             "predict_top_ops_us": top_ops(prof),
             "mean_nll": float(-lp.mean())}
    RESULTS["backmapping_serve"] = serve
    busy = ("not measured" if busy_us is None else
            f"{busy_us / 1e3:.3f} of {1e3 * predict_wall:.3f} ms busy in a "
            "profiled call")
    print(f"backmapping predict {BM_SITES} sites "
          f"{serve['predict_sites_per_s']:.1f} sites/s "
          f"({serve['predict_ms']:.3f} ms)  log_prob "
          f"{serve['log_prob_sites_per_s']:.1f} sites/s "
          f"({serve['log_prob_ms']:.3f} ms)  predict device {busy}  "
          f"rotation max abs err {rot_err:.3e}", flush=True)

    data = backmapping_frames(BM_FRAMES, 25, dev)
    row = train_path("backmapping", bm,
                     lambda m, b, g: -m.log_prob(*b).mean(), data, dev,
                     batch=BM_BATCH, epochs=BM_EPOCHS)
    fail_unless(all(row["launches"][k] > 0 for k in (
        "pair_attention", "maf_block", "dense_stack")),
        f"backmapping training launch counts {row['launches']}")
    batch = tuple(a[:512] for a in data)
    with torch.no_grad():
        ctx = bm.embed(*batch[:3])
    # Three trained blocks of 20 bins on [-pi, pi] crowd their knots
    # where the torsions lie: fewer rows stay clear of them than in the
    # flows above (99.35% of 2000 frames at initialisation, on the CPU).
    keep = rows_off_knots(bm.decoder.dist.flow, batch[3], ctx, 0.95)
    batch = tuple(a[keep] for a in batch)
    check_grads("backmapping", bm, lambda m, d: -m.log_prob(
        *(a.to(d) for a in batch)).mean(), dev)
    return serve, row


# ---------------------------------------------------------------------------
# Molecular MD: the production molecular stack and the LJ liquid (kernel 6)
# ---------------------------------------------------------------------------


def molecular_system():
    """bench.py:631-717's production molecular stack: MD_N atoms as
    MD_N / 2 charged dimers (+-0.5) at density 0.6, harmonic bonds (k
    200, r0 1), the bonded pairs excluded inside the cell-list LJ with its
    Ewald real-space term (cutoff 3.5, skin 0.4, capacity 72) and in PME
    (tolerance 1e-4, reciprocal part only).  Start: the even-z lattice of
    bench.py:669-676 (every bond one lattice spacing long).  Potentials
    built with no device: on the card."""
    n = MD_N
    L = float((n / MOL["rho"]) ** (1.0 / 3.0))
    mz = 2 * max(int(np.ceil(n ** (1.0 / 3.0) / 2.0)), 1)
    mxy = int(np.ceil(np.sqrt(n / mz)))
    g = np.stack(np.meshgrid(np.arange(mxy), np.arange(mxy), np.arange(mz),
                             indexing="ij"), -1).reshape(-1, 3)[:n]
    g = g * (L / np.array([mxy, mxy, mz]))
    bonds = np.array([[2 * k, 2 * k + 1] for k in range(n // 2)])
    q = np.tile([0.5, -0.5], n // 2)
    pme_kw = dict(charges=q, box=[L] * 3, r_cutoff=MOL["cutoff"],
                  tolerance=1e-4, exclude=bonds, include_real_space=False)
    recip = potentials.pme_coulomb(**pme_kw)
    cell_kw = dict(box=[L] * 3, cutoff=MOL["cutoff"], skin=MOL["skin"],
                   capacity=MOL["capacity"], charges=q,
                   coulomb_alpha=recip.ewald_alpha, exclude=bonds)
    build, cell_e = potentials.lennard_jones_cell_neighbor(**cell_kw)
    bonded = potentials.harmonic_bonds(bonds, k=200.0, r0=1.0)

    def energy(nl, x):
        return cell_e(nl, x) + recip(x) + bonded(x)

    return dict(name="molecular", L=L, build=build, energy=energy,
                cell_energy=cell_e, recip=recip, x0=g, spec=MOL,
                cell_kw=cell_kw, pme_kw=pme_kw)


def lj_system():
    """bench.py:559-617's LJ liquid: MD_N atoms at density 0.8, cutoff
    2.5, skin 0.4, capacity 48, from a simple-cubic lattice."""
    n = MD_N
    L = float((n / LJ["rho"]) ** (1.0 / 3.0))
    m = int(np.ceil(n ** (1.0 / 3.0)))
    g = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n] * (L / m)
    build, energy = potentials.lennard_jones_cell_neighbor(
        box=[L] * 3, cutoff=LJ["cutoff"], skin=LJ["skin"],
        capacity=LJ["capacity"])
    return dict(name="lj", L=L, build=build, energy=energy,
                cell_energy=energy, x0=g, spec=LJ)


def launch_us(prof, match):
    """(device µs per recorded launch of the kernels whose name contains
    ``match``, the number of launches the profile recorded); (None, 0)
    where it recorded none.  Late in this script a profile has recorded
    only some, or none, of a window's ctypes launches on the H100, so
    kernel 6 is timed per recorded launch, with the count kept."""
    evs = [us for name, on_card, us in events(prof)
           if on_card and match in name]
    n = len(evs)
    return (sum(evs) / n if n else None), n


def md_path(sys_, dev, seed):
    """One MD path on the card: BAOAB (friction 1, kT 1, rebuild every
    MD_REBUILD steps) thermalised for gamma t >= 3, then MD_TIMED steps
    timed on the host clock ending in a device sync, with the launch
    counters zeroed just before and read just after, and the peak memory
    of that run; then one rebuild chunk (a build and MD_REBUILD steps)
    under torch.profiler.  Checks a finite energy, a kinetic temperature
    in (0.8, 1.2) and kernel-6 launches.  Returns (row, final state)."""
    name, spec, build, energy = (sys_["name"], sys_["spec"], sys_["build"],
                                 sys_["energy"])
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = torch.tensor(sys_["x0"], dtype=torch.float32, device=dev)
    v0 = torch.randn(x0.shape, generator=gen, device=dev)

    def run(s_x, s_v, n):
        return md.baoab_neighbor(build, energy, s_x, s_v, gen, dt=spec["dt"],
                                 n_steps=n, rebuild_every=MD_REBUILD,
                                 friction=1.0, kT=1.0)[0]

    equil = MD_REBUILD * int(math.ceil(3.0 / spec["dt"] / MD_REBUILD))
    t0 = time.perf_counter()
    s = run(x0, v0, equil)
    torch.cuda.synchronize()
    equil_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    s = run(s.x, s.v, MD_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = path_counts("md_path")
    peak = torch.cuda.max_memory_allocated()

    def chunk():
        nl = build(s.x)
        return md.baoab(lambda x: energy(nl, x), s.x, s.v, gen,
                        dt=spec["dt"], n_steps=MD_REBUILD, friction=1.0,
                        kT=1.0, f0=s.force)[0]

    chunk()
    chunk_s, prof = profiled(chunk)
    busy_us, _ = device_time(prof)
    k6_us, k6_n = launch_us(prof, "cell_lj_kernel")
    tops = top_ops(prof, MD_REBUILD)
    with torch.no_grad():
        e = float(energy(build(s.x), s.x))
    kt = float(md.temperature(s.v))
    fail_unless(math.isfinite(e), f"md {name}: energy {e}")
    fail_unless(0.8 < kt < 1.2, f"md {name}: kinetic kT {kt}")
    fail_unless(counts["cell_lj"] > 0, f"md {name} launch counts {counts}")
    ms = 1e3 * wall / MD_TIMED
    chunk_ms = 1e3 * chunk_s / MD_REBUILD
    busy_ms = None if busy_us is None else busy_us / 1e3 / MD_REBUILD
    row = {"path": name, "atoms": MD_N, "box": sys_["L"],
           "thermalise_steps": equil, "thermalise_s": equil_s,
           "steps": MD_TIMED, "seconds": wall, "ms_per_step": ms,
           "atom_steps_per_s": MD_N * MD_TIMED / wall,
           "launches": counts, "peak_memory_bytes": peak,
           "profiled_ms_per_step": chunk_ms,
           "device_busy_ms_per_step": busy_ms,
           "cell_lj_device_us_per_launch": k6_us,
           "cell_lj_launches_recorded": k6_n,
           "device_idle_share": (None if busy_ms is None
                                 else 1.0 - busy_ms / chunk_ms),
           "top_ops_us_per_step": tops, "energy": e, "kT": kt}
    RESULTS.setdefault("md", []).append(row)
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} of {chunk_ms:.3f} ms/step in a profiled chunk "
            f"({row['device_idle_share']:.3f} idle; kernel 6 "
            f"{'not measured' if k6_us is None else f'{k6_us:.1f}'} µs "
            f"per launch, {k6_n} of {MD_REBUILD} recorded)")
    print(f"md {name:9s} N={MD_N} {row['atom_steps_per_s']:.1f} atom-steps/s "
          f"({ms:.3f} ms/step)  device busy {busy}  peak memory "
          f"{peak / 2 ** 20:.1f} MiB  U/N {e / MD_N:.4f}  kT {kt:.4f}  "
          f"(thermalised {equil} steps in {equil_s:.1f} s)", flush=True)
    for side in ("device", "host"):
        print(f"  profiled md {name} step, top {side} µs: " + "; ".join(
            f"{k} {us:.1f}" for k, us in tops[side]), flush=True)
    return row, s


def molecular_path(dev):
    """Path A: the production molecular stack.  Also prints the PME grid
    (equal to the JAX package's rule: tests/test_torch_md.py) and the
    device time of one PME energy and force evaluation."""
    sys_ = molecular_system()
    grid = sys_["recip"].grid_shape
    fail_unless(grid == (64, 64, 64), f"PME grid {grid}")
    row, s = md_path(sys_, dev, 31)
    recip = sys_["recip"]

    def pme_force():
        x = s.x.detach().requires_grad_()
        torch.autograd.grad(recip(x), x)

    pme_us, _ = device_us(pme_force, "")
    row.update(pme_grid=list(grid), pme_alpha=recip.ewald_alpha,
               pme_fwd_bwd_device_us=pme_us)
    print(f"  PME grid {grid} alpha {recip.ewald_alpha:.4f}: energy + force "
          f"{'not measured' if pme_us is None else f'{pme_us:.1f} µs'} "
          "device per evaluation", flush=True)
    return sys_, row, s


def lj_path(dev):
    """Path B: the LJ liquid, then at its final state the cell-list energy
    and gradient (kernel 6) against the dense O(N^2) ``lennard_jones`` on
    the card (energy to 1e-5 relative, gradient to 1e-4 of its largest
    component + 1e-5: float32 sums over another set of pair orders), and
    an NVE ``velocity_verlet_neighbor`` run of MD_NVE steps (dt 0.004)
    conserving total energy to 5e-3 relative (tests/test_md.py:196)."""
    sys_ = lj_system()
    row, s = md_path(sys_, dev, 41)
    build, energy, L = sys_["build"], sys_["energy"], sys_["L"]
    dense = potentials.lennard_jones(box=[L] * 3, cutoff=LJ["cutoff"])
    x = s.x.detach().requires_grad_()
    e = energy(build(s.x), x)
    (g,) = torch.autograd.grad(e, x)
    xd = s.x.detach().requires_grad_()
    ed = dense(xd)
    (gd,) = torch.autograd.grad(ed, xd)
    e, ed = float(e.detach()), float(ed.detach())
    e_err = abs(e - ed) / abs(ed)
    fail_unless(e_err <= 1e-5, f"lj cell vs dense energy {e} {ed} "
                f"(relative {e_err:.2e})")
    g_err = compare("lj cell vs dense gradient", g, gd,
                    1e-4 * float(gd.abs().max()) + 1e-5, 0.0)
    del xd, ed, gd
    torch.cuda.empty_cache()
    with torch.no_grad():
        e0 = float(energy(build(s.x), s.x) + md.kinetic_energy(s.v))
    nve, _ = md.velocity_verlet_neighbor(build, energy, s.x, s.v,
                                         dt=LJ["dt"], n_steps=MD_NVE,
                                         rebuild_every=MD_REBUILD)
    with torch.no_grad():
        e1 = float(energy(build(nve.x), nve.x) + md.kinetic_energy(nve.v))
    drift = abs(e1 - e0) / abs(e0)
    fail_unless(drift <= 5e-3, f"NVE energy {e0} -> {e1} ({drift:.2e})")
    row.update(dense_energy_rel_err=e_err, dense_grad_max_abs_err=g_err,
               nve_steps=MD_NVE, nve_energy=[e0, e1], nve_rel_drift=drift)
    print(f"  lj cell list vs dense at N={MD_N}: energy {e_err:.2e} relative, "
          f"gradient max abs err {g_err:.3e}; NVE {MD_NVE} steps: total "
          f"energy {e0:.3f} -> {e1:.3f} ({drift:.2e})", flush=True)
    return sys_, row, s


def cell_lj_pairs(args, kw):
    """The number of (centre, neighbour) slots of the block inside the
    cutoff and not masked: the mask of the plain version, recomputed."""
    cxt, nxt, cid, nid, _, _, excl = args
    r2 = 0.0
    for a, b in enumerate(kw["box"]):
        d = cxt[:, a, :, None] - nxt[:, a, None, :]
        d = d - b * torch.round(d * (1.0 / b))
        r2 = r2 + d * d
    ci = cid.transpose(1, 2)
    n = kw["n_atoms"]
    mask = (ci < n) & (nid < n) & (ci != nid) & (r2 < kw["cutoff"] ** 2)
    if excl is not None:
        for k in range(excl.shape[1]):
            mask &= excl[:, k, :, None] != nid
    return int(mask.sum())


def cell_lj_work(args, kw):
    """(bytes, least float32 operations, the operations of the padded
    count, padded slots, occupied candidate slots, pairs) of one
    cell-pair call on these inputs.  Bytes: every input read once, e and
    grad written once (the gathered blocks: the kernel reads no other
    layout).  Operations per slot tested: the minimum image (5 per axis),
    r^2 (5) and the mask (3 compares + D exclusion compares); on each
    slot inside the cutoff the LJ energy, its derivative, the shift, the
    core test and the accumulation (35, an FMA as 2), +3 for species,
    +40 for charges (erfcf counted as ~20, expf ~5).  The least work
    tests the occupied candidates only (real centres x real neighbour
    slots of each cell); the padded count (C x 27 C slots per cell, the
    first design's bound) is kept beside it."""
    cxt, nxt, cid, nid, species, charge, excl = args
    ins = [cxt, nxt, cid, nid, excl, *(species or ()), *(charge or ())]
    nc, _, C = cxt.shape
    nbytes = 4 * (sum(t.numel() for t in ins if t is not None)
                  + nc + nc * 3 * C)
    D = 0 if excl is None else excl.shape[1]
    n = kw["n_atoms"]
    slots = nc * C * nxt.shape[-1]
    cands = int(((cid[:, 0] < n).sum(-1).double()
                 * (nid[:, 0] < n).sum(-1).double()).sum())
    pairs = cell_lj_pairs(args, kw)
    per_pair = 35 + (3 if species else 0) + (40 if charge else 0)
    return (nbytes, cands * (23 + D) + pairs * per_pair,
            slots * (23 + D) + pairs * per_pair, slots, cands, pairs)


def check_cell_lj_case(label, energy, nl, x, timed_case):
    """Kernel 6 against its plain version on one list's gathered inputs:
    per-cell energies to 1e-5 relative (of the largest) and the total to
    1e-5, gradients to 1e-4 of the largest component + 1e-5 (sums of up
    to 27 C terms in another order; the pair masks are equal by
    construction).  Timed cases add event ms, profiler device µs and the
    bound."""
    args, kw = energy.cell_pair_inputs(nl, x)
    e, g = cell_lj.cell_pair_energy_force_cuda(*args, **kw)
    ew, gw = cell_lj.cell_pair_energy_force_plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(compare(f"cell_lj {label} e", e, ew,
                      1e-5 * float(ew.abs().max()), 1e-5),
              compare(f"cell_lj {label} grad", g, gw,
                      1e-4 * float(gw.abs().max()) + 1e-5, 0.0))
    tot = abs(float(e.sum()) - float(ew.sum()))
    fail_unless(tot <= 1e-5 * abs(float(ew.sum())),
                f"cell_lj {label}: total energy {float(e.sum())} vs "
                f"{float(ew.sum())}")
    nc, _, C = args[0].shape
    shape = f"{label} C={C} cells={nc}"
    ms = plain_ms = None
    extra = {}
    if timed_case:
        ms = timed(lambda: cell_lj.cell_pair_energy_force_cuda(*args, **kw))
        plain_ms = timed(lambda: cell_lj.cell_pair_energy_force_plain(
            *args, **kw), reps=5)
        cell_lj.cell_pair_energy_force_cuda(*args, **kw)
        _, prof = profiled(lambda: [cell_lj.cell_pair_energy_force_cuda(
            *args, **kw) for _ in range(10)])
        extra["device_us"], recorded = launch_us(prof, "cell_lj_kernel")
        extra["launches_recorded_of_10"] = recorded
        extra["plain_device_us"], _ = device_us(
            lambda: cell_lj.cell_pair_energy_force_plain(*args, **kw), "",
            reps=3)
        nbytes, ops, padded_ops, slots, cands, pairs = cell_lj_work(args, kw)
        extra["bound_us"], by = _bound(nbytes, ops)
        extra["padded_bound_us"], padded_by = _bound(nbytes, padded_ops)
        extra["split"] = cell_lj.cluster_split(kw["n_atoms"], nc)
        RESULTS.setdefault("cell_lj_work", {})[shape] = {
            "bytes": nbytes, "ops": ops, "padded_ops": padded_ops,
            "slots": slots, "candidates": cands, "pairs": pairs,
            "bound_by": by, "padded_bound_by": padded_by}
        print(f"  cell_lj {shape}: {slots} padded slots, {cands} occupied "
              f"candidates, {pairs} pairs inside the cutoff, {nbytes} bytes, "
              f"{ops} operations ({padded_ops} by the padded count); "
              f"{extra['split']} blocks a cell", flush=True)
    record("cell_lj", shape, err, ms, plain_ms, **extra)


def check_cell_lj(mol, mol_x, lj, lj_x, dev):
    """Kernel 6 on the paths' own gathered inputs (their final states):
    the molecular shape (charges and exclusions, C = 72, 216 cells) and
    the LJ liquid (scalar, C = 48, 343 cells), timed; a binary
    Lorentz-Berthelot mixture (sigma in {1, 0.88}, epsilon in {1, 0.5},
    charges +-0.5 with alpha 1.2, dimer exclusions) at the LJ liquid's
    size and state, timed; a coincident pair; a ragged 5 x 6 x 7 grid at
    capacity 37 with every branch on.  Then the energy route's NaN
    contract on the card: an overflowed and a drifted build give NaN
    energy and gradient."""
    check_cell_lj_case(MOL_SHAPE, mol["cell_energy"],
                       mol["build"](mol_x), mol_x, True)
    check_cell_lj_case("lj scalar", lj["energy"], lj["build"](lj_x), lj_x,
                       True)
    n, L = MD_N, lj["L"]
    sig = np.where(np.arange(n) % 2 == 0, 1.0, 0.88)
    bonds = np.array([[2 * k, 2 * k + 1] for k in range(n // 2)])
    build, energy = potentials.lennard_jones_cell_neighbor(
        sig, np.where(sig == 1.0, 1.0, 0.5), box=[L] * 3, cutoff=LJ["cutoff"],
        skin=LJ["skin"], capacity=LJ["capacity"],
        charges=np.tile([0.5, -0.5], n // 2), coulomb_alpha=1.2,
        exclude=bonds)
    check_cell_lj_case("species+coulomb+exclusion", energy, build(lj_x),
                       lj_x, True)
    xc = lj_x.clone()
    xc[7] = xc[3]
    check_cell_lj_case("lj coincident pair", lj["energy"], lj["build"](xc),
                       xc, False)
    rng = np.random.default_rng(51)
    box = np.array([14.5, 17.4, 20.3])
    xr = torch.tensor(rng.random((3000, 3)) * box, dtype=torch.float32,
                      device=dev)
    build, energy = potentials.lennard_jones_cell_neighbor(
        rng.uniform(0.85, 1.0, 3000), rng.uniform(0.5, 1.0, 3000),
        box=box.tolist(), cutoff=2.5, skin=0.4, capacity=37,
        charges=np.tile([0.5, -0.5], 1500), coulomb_alpha=1.2,
        exclude=bonds[:1500])
    check_cell_lj_case("ragged all branches", energy, build(xr), xr, False)
    for case in ("overflow", "drift"):
        if case == "overflow":
            build, energy = potentials.lennard_jones_cell_neighbor(
                box=[L] * 3, cutoff=LJ["cutoff"], skin=LJ["skin"], capacity=8)
            nl, x = build(lj_x), lj_x.clone()
            fail_unless(bool(nl.overflow), "capacity 8 did not overflow")
        else:
            build, energy = lj["build"], lj["energy"]
            nl, x = build(lj_x), lj_x.clone()
            x[11, 2] += 0.3
        x.requires_grad_()
        before = cell_lj.KERNEL.launches
        e = energy(nl, x)
        (g,) = torch.autograd.grad(e, x)
        fail_unless(cell_lj.KERNEL.launches == before + 1,
                    f"cell_lj {case}: kernel not launched")
        fail_unless(bool(torch.isnan(e)) and bool(torch.isnan(g).all()),
                    f"cell_lj {case}: energy or gradient not NaN")
        record("cell_lj", f"{case} build: NaN energy and gradient", 0.0)


# ---------------------------------------------------------------------------
# Sampling stack: RealNVP flows, local moves, REMC, tempering, free energies
# ---------------------------------------------------------------------------


def busy_share(fn, per):
    """fn() once under torch.profiler: (window ms, device-busy ms, idle
    share) per ``per`` units of work; the busy pair is None where the
    trace holds no device time."""
    window_s, prof = profiled(fn)
    busy_us, _ = device_time(prof)
    window_ms = 1e3 * window_s / per
    if busy_us is None:
        return window_ms, None, None
    busy_ms = busy_us / 1e3 / per
    return window_ms, busy_ms, 1.0 - busy_ms / window_ms


class RqsRoutes:
    """While active, tallies kernel 1's launches by route, from the
    ``rows`` argument of each launch: one broadcast row, or a row per
    element.  The launches themselves go through the wrapper as ever."""

    def __enter__(self):
        self.tally = {"broadcast": 0, "per_element": 0}
        launch = rqs.KERNEL.launch

        def spy(device, *args, **kw):
            launch(device, *args, **kw)
            self.tally["broadcast" if args[8] == 1 else "per_element"] += 1

        rqs.KERNEL.launch = spy
        return self.tally

    def __exit__(self, *exc):
        del rqs.KERNEL.launch


def sampling_row(name, seconds, rate, unit, counts, busy=None, **extra):
    """Record and print one sampling path's result."""
    row = {"path": name, "seconds": seconds, "rate": rate, "unit": unit,
           "launches": counts, **extra}
    text = ""
    if busy is not None:
        window_ms, busy_ms, idle = busy
        row.update(profiled_ms=window_ms, device_busy_ms=busy_ms,
                   device_idle_share=idle)
        text = ("  device busy not measured" if busy_ms is None else
                f"  device busy {busy_ms:.4f} of {window_ms:.4f} ms "
                f"profiled ({idle:.3f} idle)")
    RESULTS["sampling"].append(row)
    rate = "" if rate is None else f"{rate:16.1f} {unit}  "
    print(f"sampling {name:16s} {rate}({seconds:.3f} s){text}  launches "
          f"{counts}", flush=True)
    return row


def realnvp_1d_data(dev):
    """bench.py:368's data: RNVP_N samples of the 4-mode 1-D mixture,
    centres -3, -1, 1, 3, sigma 0.25."""
    rng = np.random.default_rng(2)
    x = (np.array([-3.0, -1.0, 1.0, 3.0])[rng.integers(0, 4, RNVP_N)]
         + 0.25 * rng.normal(size=RNVP_N))
    return torch.tensor(x[:, None], dtype=torch.float32, device=dev)


def realnvp_1d_path(dev):
    """bench.py:368 (the reference notebook's flow workload): a 1-D
    RQSSplineRealNVP (4 blocks, 32 bins on [-5, 5], hidden 100) built by
    RealNVPConfig in a FlowModel over a standard normal, trained by fit()
    at batch 4096 for RNVP_EPOCHS epochs after a warm-up epoch, then 10k
    samples:
    each block's conditioner on one row (kernel 2's small-N regime) and
    its spline on one broadcast row (kernel 1)."""
    model = ExperimentConfig(model=FlowModelConfig(FlowedDistConfig(
        RealNVPConfig(data_dim=1, num_blocks=4, rqs=RQSParams(
            num_bins=32, hidden_dim=100, bin_range=(-5.0, 5.0))),
        base=None, static_base_dim=1))).build(dev)
    data = realnvp_1d_data(dev)
    probe = torch.zeros(RNVP_SAMPLES, 1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(14)
    with torch.no_grad():
        before = moment_distance(model.predict(probe, gen), data)
    with RqsRoutes() as routes:
        row = train_path("flow_realnvp_1d", model,
                         lambda m, b, g: -m.log_prob(b).mean(), data, dev,
                         batch=RNVP_BATCH, epochs=RNVP_EPOCHS)
    fail_unless(row["launches"]["rqs"] > 0
                and row["launches"]["dense_stack"] > 0
                and routes["broadcast"] > 0,
                f"1-D RealNVP training launch counts {row['launches']}, "
                f"kernel 1 routes {routes}")
    _build.reset_launches()
    with torch.no_grad():
        samples = model.predict(probe, gen)
    sample_counts = path_counts("realnvp_1d_path")
    fail_unless(sample_counts["rqs"] > 0 and sample_counts["dense_stack"] > 0,
                f"1-D RealNVP sampling launch counts {sample_counts}")
    fail_unless(bool(torch.isfinite(samples).all())
                and samples.shape == (RNVP_SAMPLES, 1),
                "1-D RealNVP samples not finite or of the wrong shape")
    after = moment_distance(samples, data)
    fail_unless(after < before, f"1-D RealNVP samples' moments did not move "
                f"toward the data's: distance {before} -> {after}")
    with torch.no_grad():
        ms = timed(lambda: model.predict(probe, gen), reps=10)
    row.update(routes=dict(routes), sample_launches=sample_counts,
               samples_per_s=RNVP_SAMPLES / (ms * 1e-3), predict_ms=ms,
               moment_distance=[before, after])
    print(f"sample realnvp_1d N={RNVP_SAMPLES} {row['samples_per_s']:.1f} "
          f"samples/s ({ms:.4f} ms)  moment distance {before:.4f} -> "
          f"{after:.4f}  kernel 1 routes {dict(routes)}", flush=True)
    x = data[:RNVP_BATCH]
    x = x[rows_off_knots(model.flowed_dist.flow, x)]
    check_grads("flow_realnvp_1d", model,
                lambda m, d: -m.log_prob(x.to(d)).mean(), dev)
    return model, row, sample_counts


def mixture_target(dev):
    """bench.py:461's target: an equal mixture of N(-2, 0.7^2) and
    N(2, 0.7^2) in x0 and N(0, 1) in x1."""
    mix = dist.MixtureSameFamily(
        torch.zeros(2, device=dev),
        dist.Normal(torch.tensor([-2.0, 2.0], device=dev),
                    0.7 * torch.ones(2, device=dev)))

    def log_target(x):
        return mix.log_prob(x[..., 0]) - 0.5 * x[..., 1] ** 2

    return mix, log_target


def statistics_path(vae, dev):
    """bench.py:461's sampler-correctness block: STATS_CHAINS chains x
    STATS_STEPS steps of cycle_moves([generic VAE step, MALA, random
    walk]) on the flagship (random weights), scales tuned on the card
    (random walk, then MALA from 0.05), collected every 50 steps, with
    its asserted thresholds."""
    mix, log_target = mixture_target(dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    cfgs = torch.randn(STATS_CHAINS, 2, generator=gen, device=dev)
    st = MCMCState.create(cfgs, log_target(cfgs), gen)
    vae_step = make_mcmc_step(*vae_proposal_fns(vae), log_target)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    s_rw, st = tune_scale(log_target, st, kind="random_walk")
    s_mala, st = tune_scale(log_target, st, kind="mala", init_scale=0.05)
    step = cycle_moves([vae_step, make_mala_step(log_target, s_mala),
                        make_random_walk_step(log_target, s_rw)])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with RqsRoutes() as routes:
        st, traj = run_mcmc(step, st, STATS_STEPS, collect_every=50)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = path_counts("statistics_path")
    fail_unless(counts["rqs"] > 0 and counts["dense_stack"] > 0,
                f"statistics launch counts {counts}")
    x0 = st.configs[:, 0].double()
    mode_balance = float((x0 > 0).double().mean())
    m2 = float((x0 ** 2).mean())
    want_m2 = float((mix.sample(gen, (200_000,)).double() ** 2).mean())
    rhat = float(potential_scale_reduction(traj[..., 0]))
    acc = float(st.acceptance_rate)
    fail_unless(abs(mode_balance - 0.5) < 0.05, f"mode balance {mode_balance}")
    fail_unless(abs(m2 - want_m2) / want_m2 < 0.05,
                f"second moment {m2} against {want_m2}")
    fail_unless(rhat < 1.05, f"R-hat {rhat}")
    fail_unless(0.05 < acc < 0.95, f"acceptance {acc}")
    fail_unless(int(st.num_trials) == 3 * STATS_CHAINS * STATS_STEPS,
                f"statistics trials {int(st.num_trials)}")
    busy = busy_share(lambda: run_mcmc(step, st, 10), 10)
    return sampling_row(
        "statistics", dt, STATS_CHAINS * STATS_STEPS / dt,
        "proposals/s (chains x cycled steps / s; 3 MH trials a step)",
        counts, busy, ms_per_step=1e3 * dt / STATS_STEPS,
        tune_seconds=t1 - t0, routes=dict(routes),
        mode_balance=mode_balance, second_moment=m2, want_second_moment=
        want_m2, rhat=rhat, acceptance=acc, tuned_rw_scale=s_rw,
        tuned_mala_eps=s_mala, chains=STATS_CHAINS, steps=STATS_STEPS)


def molecular_hmc_path(dev):
    """bench.py:521: composite(lennard_jones(), com_restraint(2.0)) at
    beta 2 on HMC_CHAINS LJ7 clusters from 0.7 N(0, 1) starts, relaxed by
    minimize_energy (HMC_MIN_STEPS steps, lr 0.1), HMC tuned (init 0.05,
    HMC_TUNE_ROUNDS rounds, 10 leapfrog steps), then HMC_STEPS HMC steps.  The dense
    O(N^2) LJ is plain PyTorch: no kernel runs on this path."""
    pot = potentials.composite(potentials.lennard_jones(device=dev),
                               potentials.com_restraint(2.0))
    lp = potentials.as_log_prob(pot, beta=2.0)
    gen = torch.Generator(device=dev).manual_seed(16)
    x0 = 0.7 * torch.randn(HMC_CHAINS, 7, 3, generator=gen, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    x = potentials.minimize_energy(pot, x0, steps=HMC_MIN_STEPS, lr=0.1)
    with torch.no_grad():
        e_start, e_min = pot(x0), pot(x)
        st = MCMCState.create(x, lp(x), gen)
    eps, st = tune_scale(lp, st, kind="hmc", init_scale=0.05,
                         rounds=HMC_TUNE_ROUNDS, n_leapfrog=HMC_LEAP)
    step = make_hmc_step(lp, step_size=eps, n_leapfrog=HMC_LEAP)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out, _ = run_mcmc(step, st, HMC_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    counts = path_counts("molecular_hmc_path")
    acc = float(out.acceptance_rate)
    fail_unless(0.3 < acc <= 1.0, f"HMC acceptance {acc}")
    fail_unless(bool(torch.isfinite(out.configs).all()
                     and torch.isfinite(out.energies).all()),
                "HMC chains not finite")
    fail_unless(float(e_min.max()) < float(e_start.median()),
                "minimize_energy did not relax the clusters")
    fail_unless(sum(counts.values()) == 0,
                f"a kernel launched on the dense-LJ HMC path: {counts}")
    busy = busy_share(lambda: run_mcmc(step, out, 5), 5)
    print("sampling molecular_hmc: no kernel on this path (the dense LJ "
          "and its autograd gradient are plain PyTorch)", flush=True)
    grads = HMC_CHAINS * HMC_STEPS * (HMC_LEAP + 1)
    return sampling_row(
        "molecular_hmc", dt, grads / dt,
        "gradient evaluations/s (chains x steps x 11 / s)", counts, busy,
        ms_per_step=1e3 * dt / HMC_STEPS, setup_seconds=t1 - t0,
        acceptance=acc, tuned_eps=eps,
        min_energy_mean=float(e_min.mean()))


def _fe_log_p_a(x):
    x = x[..., 0]
    return -1.0 * (x ** 2 - 1.5 ** 2) ** 2 / 2.0


def _fe_log_p_b(x):
    x = x[..., 0]
    return -2.2 * (x ** 2 - 1.2 ** 2) ** 2 / 2.0 - 0.6 * x


def _quadrature_ln_z(log_p, lo=-6.0, hi=6.0, n=20_001):
    g = np.linspace(lo, hi, n)
    lp = log_p(torch.tensor(g[:, None], dtype=torch.float64)).numpy()
    m = lp.max()
    return m + np.log(np.trapezoid(np.exp(lp - m), g))


def free_energy_example_10(dev):
    """examples/10_free_energy.py at its --full sizes: EXP, BAR, AIS
    (FE_AIS stages, 2 sweeps), the flow-FEP with a 1-D RealNVP (2 blocks,
    16 bins on [-4, 4], hidden 64) trained by fit() on state-B samples,
    and MBAR over a 5-state tuned-HMC ladder; the example's own check:
    the worst of BAR, AIS and MBAR within 0.15 of quadrature."""
    ln_z_a = _quadrature_ln_z(_fe_log_p_a)
    ln_z_b = _quadrature_ln_z(_fe_log_p_b)
    true_df = -(ln_z_b - ln_z_a)
    gen = torch.Generator(device=dev).manual_seed(17)

    def sample_state(log_p):
        cfgs = torch.randn(FE_CHAINS, 1, generator=gen, device=dev)
        st = MCMCState.create(cfgs, log_p(cfgs), gen)
        st, _ = run_mcmc(make_random_walk_step(log_p, 0.6), st, FE_STEPS)
        return st.configs

    out = {"true_df": true_df}
    x_a, x_b = sample_state(_fe_log_p_a), sample_state(_fe_log_p_b)
    w_f = work_values(_fe_log_p_a, _fe_log_p_b, x_a)
    w_r = work_values(_fe_log_p_b, _fe_log_p_a, x_b)
    out["exp"] = float(exp_free_energy(w_f)[0])
    out["bar"] = float(bar_free_energy(w_f, w_r)[0])

    def prior_lp(x):
        s = 1.5
        return (-0.5 * ((x / s) ** 2).sum(-1)
                - 0.5 * math.log(2 * math.pi * s * s))

    x0 = 1.5 * torch.randn(FE_CHAINS, 1, generator=gen, device=dev)
    res_a = ais(prior_lp, _fe_log_p_a, x0, gen, n_stages=FE_AIS, scale=0.5,
                sweeps_per_stage=2)
    res_b = ais(prior_lp, _fe_log_p_b, x0, gen, n_stages=FE_AIS, scale=0.5,
                sweeps_per_stage=2)
    out["ais"] = -(float(res_b.log_z) - float(res_a.log_z))

    base = dist.Independent(dist.Normal(torch.zeros(1, device=dev),
                                        torch.ones(1, device=dev)), 1)
    flow = RQSSplineRealNVP.create(
        torch.Generator(device=dev).manual_seed(18), 1, num_blocks=2,
        rqs_params={"num_bins": 16, "hidden_dim": 64,
                    "bin_range": [-4.0, 4.0]}, device=dev)
    model = FlowModel.create(gen, StaticFlowedDistribution(flow, base))
    model, hist = fit(model, lambda m, b, g: -m.log_prob(b).mean(), x_b,
                      generator=gen, num_epochs=FE_EPOCHS, batch_size=256)
    with torch.no_grad():
        q = model(torch.zeros(1, 1, device=dev))
        xs, lq = q.sample_and_log_prob(gen, (FE_CHAINS * 4,))
        ln_z_b_flow = -float(exp_free_energy(lq - _fe_log_p_b(xs))[0])
    out["flow_fep"] = -(ln_z_b_flow - ln_z_a)
    out["flow_nll"] = hist["loss"][-1]

    lams = np.linspace(0.0, 1.0, 5)
    fns = [(lambda x, lam=lam: (1.0 - lam) * _fe_log_p_a(x)
            + lam * _fe_log_p_b(x)) for lam in lams]
    ladder = []
    for fn in fns:
        cfgs = 1.5 * torch.randn(FE_CHAINS, 1, generator=gen, device=dev)
        st = MCMCState.create(cfgs, fn(cfgs), gen)
        eps, st = tune_scale(fn, st, kind="hmc", init_scale=0.1, rounds=15,
                             n_leapfrog=5)
        st, _ = run_mcmc(make_hmc_step(fn, step_size=eps, n_leapfrog=5), st,
                         FE_STEPS)
        ladder.append(st.configs)
    res = mbar_from_samples(fns, ladder)
    out["mbar"] = float(res.free_energies[-1])
    out["mbar_se"] = float(res.stderrs[-1])
    worst = max(abs(out[k] - true_df) for k in ("bar", "ais", "mbar"))
    out["worst_error"] = worst
    fail_unless(worst < 0.15, f"example 10: estimators disagree with "
                f"quadrature by {worst}: {out}")
    print("free_energy example 10: " + "  ".join(
        f"{k} {v:+.4f}" for k, v in out.items()), flush=True)
    return out


def _banana_lp(x):
    x1, x2 = x[..., 0], x[..., 1]
    return -(x1 ** 2 / (2 * 0.8 ** 2)
             + (x2 - 0.5 * x1 ** 2 - 1.0) ** 2 / (2 * 0.35 ** 2))


def _gauss_lp(x):
    return -0.5 * (x ** 2).sum(-1)


def free_energy_example_40(dev):
    """examples/40_targeted_fep.py at its --full size: a 2-D
    RQSSplineRealNVP (4 blocks, 16 bins on [-8, 8], hidden 64) trained
    by tfep_loss with Adam 2e-3 for TFEP_STEPS steps on TFEP_N fixed
    A-samples (each block's conditioner on every row: kernel 2 at N =
    TFEP_N, and kernel 1 on a row per element, forward and backward),
    then targeted EXP and BAR, with the example's three validations."""
    gen = torch.Generator(device=dev).manual_seed(19)
    true_df = -math.log(0.8 * 0.35)
    x_a = torch.randn(TFEP_N, 2, generator=gen, device=dev)
    x1 = 0.8 * torch.randn(TFEP_N, generator=gen, device=dev)
    x_b = torch.stack([x1, 0.5 * x1 ** 2 + 1.0 + 0.35 * torch.randn(
        TFEP_N, generator=gen, device=dev)], -1)
    w_f = work_values(_gauss_lp, _banana_lp, x_a)
    w_r = work_values(_banana_lp, _gauss_lp, x_b)
    _, se_bar = bar_free_energy(w_f, w_r)
    flow = RQSSplineRealNVP.create(
        torch.Generator(device=dev).manual_seed(20), 2, num_blocks=4,
        rqs_params={"num_bins": 16, "hidden_dim": 64,
                    "bin_range": [-8.0, 8.0]}, device=dev)
    opt = torch.optim.Adam(flow.parameters(), lr=2e-3)
    losses = []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    with RqsRoutes() as routes:
        for _ in range(TFEP_STEPS):
            loss = tfep_loss(_gauss_lp, _banana_lp, x_a,
                             bijector=flow.as_bijector())
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.detach())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts("free_energy_example_40")
    fail_unless(counts["dense_stack"] > 0 and routes["per_element"] > 0,
                f"example 40 launch counts {counts}, kernel 1 routes "
                f"{routes}")

    def one_step():
        loss = tfep_loss(_gauss_lp, _banana_lp, x_a,
                         bijector=flow.as_bijector())
        opt.zero_grad()
        loss.backward()
        opt.step()

    busy = busy_share(lambda: [one_step() for _ in range(5)], 5)
    losses = [float(v) for v in torch.stack(losses)[::100]]
    with torch.no_grad():
        bij = flow.as_bijector()
        w_t = targeted_work_values(_gauss_lp, _banana_lp, x_a, bijector=bij)
        df_t, se_t = exp_free_energy(w_t)
        df_tb, se_tb = targeted_bar(_gauss_lp, _banana_lp, x_a, x_b,
                                    bijector=bij)
    shrink = float(w_f.std()) / max(float(w_t.std()), 1e-9)
    err_t, err_tb = abs(float(df_t) - true_df), abs(float(df_tb) - true_df)
    fail_unless(shrink > 5.0, f"example 40: work-std shrink {shrink}")
    fail_unless(err_t < max(5 * float(se_t), 0.05),
                f"example 40: targeted EXP off by {err_t} (SE {float(se_t)})")
    fail_unless(err_tb < max(5 * float(se_tb), 0.05),
                f"example 40: targeted BAR off by {err_tb} "
                f"(SE {float(se_tb)})")
    fail_unless(float(se_tb) <= float(se_bar) + 1e-6,
                f"example 40: targeted BAR SE {float(se_tb)} above plain "
                f"BAR's {float(se_bar)}")
    fail_unless(all(math.isfinite(v) for v in losses) and
                losses[-1] < losses[0], f"example 40 losses {losses}")
    print(f"free_energy example 40: exact {true_df:+.4f}  targeted EXP "
          f"{float(df_t):+.4f} +- {float(se_t):.4f}  targeted BAR "
          f"{float(df_tb):+.4f} +- {float(se_tb):.4f} (plain BAR SE "
          f"{float(se_bar):.4f})  work-std shrink {shrink:.1f}x", flush=True)
    row = sampling_row(
        "free_energy_40", dt, TFEP_STEPS / dt, "tfep_loss Adam steps/s",
        counts, busy, ms_per_step=1e3 * dt / TFEP_STEPS,
        routes=dict(routes), losses=losses, true_df=true_df,
        targeted_exp=float(df_t), targeted_exp_se=float(se_t),
        targeted_bar=float(df_tb), targeted_bar_se=float(se_tb),
        plain_bar_se=float(se_bar), work_std_shrink=shrink)
    return flow, x_a, row


def free_energy_path(dev):
    """Examples 10 and 40 at their --full sizes, counters zeroed before
    and read after each."""
    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex10 = free_energy_example_10(dev)
    torch.cuda.synchronize()
    row10 = sampling_row("free_energy_10", time.perf_counter() - t0, None,
                         None, path_counts("free_energy_path"), **ex10)
    flow, x_a, row40 = free_energy_example_40(dev)
    return row10, row40, flow, x_a


def remc_path(vae, dev):
    """REMC on the flagship: temperature_ladder(REMC_R) over REMC_CHAINS
    chains a replica, REMC_STEPS steps, an exchange every step; the
    replica axis rides through the kernel wrappers."""
    gen = torch.Generator(device=dev).manual_seed(21)
    st = REMCState.create(
        torch.randn(REMC_R, REMC_CHAINS, 2, generator=gen, device=dev),
        log_target, temperature_ladder(REMC_R), gen)
    step = make_remc_step(*vae_proposal_fns(vae), log_target)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    st = run_remc(step, st, REMC_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts("remc_path")
    pairs = sum(len(range(i % 2, REMC_R - 1, 2)) for i in range(REMC_STEPS))
    fail_unless(int(st.num_swap_trials) == pairs * REMC_CHAINS,
                f"REMC swap attempts {int(st.num_swap_trials)}, want "
                f"{pairs * REMC_CHAINS}")
    fail_unless(int(st.num_trials) == REMC_R * REMC_CHAINS * REMC_STEPS,
                f"REMC trials {int(st.num_trials)}")
    swap, acc = float(st.swap_acceptance_rate), float(st.acceptance_rate)
    fail_unless(0.0 < swap < 1.0 and 0.0 < acc < 1.0,
                f"REMC swap acceptance {swap}, acceptance {acc}")
    fail_unless(counts["rqs"] > 0 and counts["dense_stack"] > 0,
                f"REMC launch counts {counts}")
    busy = busy_share(lambda: run_remc(step, st, 5), 5)
    return sampling_row(
        "remc", dt, REMC_R * REMC_CHAINS * REMC_STEPS / dt,
        "proposals/s (replicas x chains x steps / s)", counts, busy,
        ms_per_step=1e3 * dt / REMC_STEPS, swap_acceptance=swap,
        acceptance=acc, swap_attempts=int(st.num_swap_trials))


def _double_well(x):
    q = x[..., 0]
    return -4.0 * (q * q - 1.0) ** 2


def tempering_path(dev):
    """Simulated tempering on the 1-D double well -4 (x^2 - 1)^2 over
    temperature_ladder(ST_RUNGS, beta_min=0.1), ST_CHAINS chains,
    ST_STEPS adapting random-walk steps: every rung visited, hops
    accepted at a rate in (0, 1), and the adapted weights within 0.2 of
    the rungs' free energies by quadrature."""
    gen = torch.Generator(device=dev).manual_seed(22)
    betas = temperature_ladder(ST_RUNGS, beta_min=0.1)
    st = STState.create(torch.randn(ST_CHAINS, 1, generator=gen, device=dev),
                        _double_well, betas, gen)
    step = make_st_step(_double_well, scale=0.5)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    st, _ = run_st(step, st, ST_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = path_counts("tempering_path")
    g = np.linspace(-4.0, 4.0, 20_001)
    ln_z = [np.log(np.trapezoid(np.exp(b * _double_well(g[:, None])), g))
            for b in betas.double().cpu().numpy()]
    want = np.asarray(ln_z[0]) - np.asarray(ln_z)
    got = st.free_energies.double().cpu().numpy()
    temp_acc = float(st.temp_acceptance_rate)
    fail_unless(bool((st.occupancy > 0).all()),
                f"tempering: a rung never visited: {st.occupancy.tolist()}")
    fail_unless(0.0 < temp_acc < 1.0, f"tempering hop acceptance {temp_acc}")
    fail_unless(float(np.abs(got - want).max()) < 0.2,
                f"tempering weights {got} against quadrature {want}")
    busy = busy_share(lambda: run_st(step, st, 20), 20)
    return sampling_row(
        "tempering", dt, ST_CHAINS * ST_STEPS / dt,
        "chain-steps/s", counts, busy, temp_acceptance=temp_acc,
        acceptance=float(st.acceptance_rate),
        occupancy=st.occupancy.tolist(), free_energies=got.tolist(),
        quadrature_free_energies=want.tolist())


def kernel_launch_us(fn, match, reps=10):
    """Device µs per launch of the kernels named ``match`` in a profile of
    reps calls of fn() (after a warm-up), per launch the profile
    recorded, with that count: late in this script the profiler records
    only some ctypes launches."""
    fn()
    _, prof = profiled(lambda: [fn() for _ in range(reps)])
    return launch_us(prof, match)


def check_coupling_kernels(realnvp, flow2d, x_a, gen, dev):
    """Kernels 2 and 1 at the RealNVP paths' own shapes and weights,
    each against its plain version and timed with its bound: the 1-D
    conditioner 1->100->95 tanh on one row (with the library chain
    addmm, tanh, addmm), the 2-D conditioner 1->64->47 tanh on TFEP_N
    rows, the 1-D flow's broadcast spline row (K = 32) at RNVP_BATCH and
    RNVP_SAMPLES, and the 2-D flow's per-element rows (K = 16, N =
    TFEP_N) forward and inverse.  Tolerances as check_dense_stack's and
    check_rqs's."""
    def stack_of(cond):
        heads = (cond.w_head, cond.h_head, cond.s_head)
        return ([cond.trunk.kernel.detach(),
                 torch.cat([h.kernel for h in heads], -1).detach()],
                [cond.trunk.bias.detach(),
                 torch.cat([h.bias for h in heads], -1).detach()])

    blk1 = realnvp.flowed_dist.flow.blocks[0]
    blk2 = flow2d.blocks[0]
    cond_x = blk2._split(x_a)[0].contiguous()
    for name, (ks, bs), x in (
            ("RealNVP 1-D conditioner", stack_of(blk1.conditioner),
             torch.ones(1, 1, device=dev)),
            ("RealNVP 2-D conditioner", stack_of(blk2.conditioner), cond_x)):
        acts = ["tanh", None]
        dims = [x.shape[1]] + [k.shape[1] for k in ks]
        got = dense_stack_cuda(x, ks, bs, acts)
        err = compare(name, got, dense_stack_plain(x, ks, bs, acts), 1e-4,
                      1e-4)
        ms = timed(lambda: dense_stack_cuda(x, ks, bs, acts))
        plain_ms = timed(lambda: dense_stack_plain(x, ks, bs, acts))
        extra = {}
        extra["device_us"], extra["recorded_launches"] = kernel_launch_us(
            lambda: dense_stack_cuda(x, ks, bs, acts), "dense_")
        extra["plain_device_us"], _ = device_us(
            lambda: dense_stack_plain(x, ks, bs, acts), "")
        if x.shape[0] == 1:
            (w1, w2), (c1, c2) = ks, bs

            def library():
                return torch.addmm(c2, torch.tanh(torch.addmm(c1, x, w1)),
                                   w2)

            extra["library_ms"] = timed(library)
            extra["library_device_us"], _ = device_us(library, "")
        extra["bound_us"], extra["bound_by"] = stack_bound(x.shape[0], ks, bs)
        record("dense_stack",
               f"{name} {'->'.join(map(str, dims))} tanh N={x.shape[0]}",
               err, ms, plain_ms, regime=stack_regime(x.shape[0], dims)[0],
               **extra)
    with torch.no_grad():
        s1 = blk1._spline(torch.zeros(1, 0, device=dev))
        s2 = blk2._spline(cond_x)
    cases = [("broadcast", s1, n, 1.0) for n in (RNVP_BATCH, RNVP_SAMPLES)]
    cases.append(("per-element", s2, TFEP_N, 4.0))
    for route, spline, n, spread in cases:
        params = tuple(p.detach() for p in (spline.bin_widths,
                                            spline.bin_heights,
                                            spline.knot_slopes))
        K = params[0].shape[-1]
        x = spread * torch.randn(n, 1, generator=gen, device=dev)
        for inverse in (False, True):
            plain = rqs.rqs_inverse_plain if inverse \
                else rqs.rqs_forward_plain
            got = rqs.rqs_cuda(x, *params, spline.range_min, inverse)
            want = plain(x, *params, spline.range_min)
            err = max(compare("rqs value", got[0], want[0], 1e-5, 1e-5,
                              1e-4),
                      compare("rqs ldj", got[1], want[1], 1e-4, 0.0, 1e-4))
            ms = timed(lambda: rqs.rqs_cuda(x, *params, spline.range_min,
                                            inverse))
            plain_ms = timed(lambda: plain(x, *params, spline.range_min))
            dev_us, recorded = kernel_launch_us(
                lambda: rqs.rqs_cuda(x, *params, spline.range_min, inverse),
                "rqs")
            rows = params[0].reshape(-1, K).shape[0]
            # Bytes: x in, y and the log-det out, and the parameter rows
            # (3K - 1 floats each) once.
            bound_us, bound_by = _bound(4 * (3 * n + rows * (3 * K - 1)),
                                        n * spline_flops(K))
            record("rqs", f"RealNVP {'inverse' if inverse else 'forward'} "
                   f"{route} N={n} K={K}", err, ms, plain_ms,
                   plan=rqs.kernel_plan(n, K, rows), device_us=dev_us,
                   recorded_launches=recorded, bound_us=bound_us,
                   bound_by=bound_by)


# ---------------------------------------------------------------------------
# Slice 9: the dual ELBO, the HVAE, the batch-norm flow with a checkpoint,
# the ensemble (example 09) and the autoregressive backmapping decoder
# ---------------------------------------------------------------------------


def potential(x):
    """The dual ELBO's reverse potential: -log_target."""
    return -log_target(x)


def fixed_normal_draw(eps):
    """The sample of a one-family normal Blockwise at fixed normals."""
    def draw(dist):
        f = dist.families[0]
        return f.loc + f.scale * eps.to(f.loc.device)
    return draw


def dual_elbo_path(dev):
    """The flagship with VAEConfig(dual_elbo=True): KL forward, reverse
    KL reverse, the reverse potential -log_target; fit() at batch 10k.
    Gradients at fixed draws (encoder, prior and decoder normals) against
    a CPU copy, on rows whose prior inputs, both passes, lie away from
    the knots."""
    cfg = flagship_experiment_config()
    cfg.model.dual_elbo = True
    cfg.model.reverse_regularizer = RegularizerConfig(kind="reverse_kl")
    vae = cfg.build()
    fail_unless(isinstance(vae, VAEDualELBO)
                and next(vae.parameters()).device.type == dev.type,
                "VAEConfig(dual_elbo=True).build() did not build a "
                "VAEDualELBO on the card")
    data = two_mode_data(dev)
    row = train_path("dual_elbo", vae,
                     lambda m, b, g: m.dual_elbo_loss(b, g, potential), data,
                     dev, epochs=DUAL_EPOCHS, profiled_steps=2)
    fail_unless(row["launches"]["rqs"] > 0
                and row["launches"]["dense_stack"] > 0,
                f"dual ELBO path launch counts {row['launches']}")
    gen = torch.Generator(device=dev).manual_seed(40)
    n = TRAIN_BATCH
    eps_z, eps_r, eps_x = (torch.randn(n, k, generator=gen, device=dev)
                           for k in (1, 1, 2))
    x = data[:n]
    flow = vae.prior.flow
    with torch.no_grad():
        f = vae.encoder(x).families[0]
        z_r = vae.prior().bijector.forward(eps_r)
        keep = (rows_off_knots(flow, f.loc + f.scale * eps_z)
                & rows_off_knots(flow, z_r)
                & knot_safe(list(flow.blocks), eps_r, inverse=False
                            ).to(dev))
    x, eps_z, eps_r, eps_x = x[keep], eps_z[keep], eps_r[keep], eps_x[keep]

    def dual_at(m, d):
        """The dual loss at fixed normals (the same on both devices)."""
        draws = {"encode": fixed_normal_draw(eps_z),
                 "prior": lambda dist: dist.bijector.forward(eps_r.to(d)),
                 "decode": fixed_normal_draw(eps_x)}
        out = m._dual_pass(x.to(d), True, lambda role, dist:
                           draws[role](dist))
        return m._dual_loss(x.to(d), out, potential)[0]

    check_grads("dual_elbo", vae, dual_at, dev)
    return row


def hvae_path(dev):
    """The flagship VAE by hvae_elbo_loss(n_leapfrog=5, step_size=0.1)
    through fit() at batch 10k on HVAE_N points.  At fixed draws: the
    n_leapfrog=0 bound against the one-sample ELBO on the card, and every
    parameter's gradient (through the leapfrog's inner gradients: second
    derivatives of the kernel routes) against a CPU copy, on rows whose
    every leapfrog position lies away from the prior's knots.  The
    gradient check takes 5 steps of 0.05: at 0.1 the flagship's HVAE
    gradient is ill-conditioned in float32 itself (on the CPU, float32
    and float64 disagree on 81% of its entries, by up to 531 times this
    check's tolerance, 2000 rows at initialisation), while at 0.05 they
    agree to 0.16 of it."""
    vae = flagship_experiment_config().build()
    data = two_mode_data(dev)[:HVAE_N]
    row = train_path("hvae", vae, lambda m, b, g: m.hvae_elbo_loss(
        b, g, n_leapfrog=HVAE_LEAPFROG, step_size=0.1), data, dev,
        epochs=HVAE_EPOCHS, profiled_steps=1)
    fail_unless(row["launches"]["rqs"] > 0
                and row["launches"]["dense_stack"] > 0,
                f"HVAE path launch counts {row['launches']}")
    gen = torch.Generator(device=dev).manual_seed(41)
    n = HVAE_CHECK_ROWS
    x = data[:n]
    eps = torch.randn(n, 1, generator=gen, device=dev)
    rho = torch.randn(n, 1, generator=gen, device=dev)

    def bound_at(m, d, leap, trajectory=None):
        enc = m.encoder(x.to(d), train=True)
        f = enc.families[0]
        z0 = f.loc + f.scale * eps.to(d)
        return m._hvae_loss(x.to(d), enc, z0, rho.to(d), leap, 0.05, True,
                            trajectory)[0], enc, z0

    with torch.no_grad():
        b0, enc, z0 = bound_at(vae, dev, 0)
        prior = vae._prior_dist(z0, True)
        elbo = -(vae.decoder(z0, train=True).log_prob(x)
                 + prior.log_prob(z0) - enc.log_prob(z0)).mean()
    zero_err = abs(float(b0) - float(elbo))
    fail_unless(zero_err <= 1e-5 * max(1.0, abs(float(elbo))),
                f"HVAE bound at n_leapfrog=0 {float(b0)} != ELBO "
                f"{float(elbo)}")
    traj = []
    cpu = copy.deepcopy(vae).to("cpu")
    with torch.no_grad():
        bound_at(cpu, torch.device("cpu"), HVAE_LEAPFROG, traj)
    keep = torch.ones(n, dtype=torch.bool)
    for z in traj:
        keep &= knot_safe(reversed(list(cpu.prior.flow.blocks)), z)
    fail_unless(float(keep.float().mean()) > 0.95,
                f"only {int(keep.sum())} of {n} HVAE trajectories away "
                "from the knots")
    keep = keep.to(dev)
    x, eps, rho = x[keep], eps[keep], rho[keep]
    _build.reset_launches()
    check_grads("hvae", vae, lambda m, d: bound_at(m, d, HVAE_LEAPFROG)[0],
                dev)
    grad_counts = path_counts("hvae_path")
    fail_unless(grad_counts["rqs"] > 0 and grad_counts["dense_stack"] > 0,
                f"HVAE gradient check launch counts {grad_counts}")
    row.update(elbo_at_zero_leapfrog_abs_err=zero_err,
               rows_off_knots=int(keep.sum()))
    print(f"hvae n_leapfrog=0 bound {float(b0):.6f} vs ELBO "
          f"{float(elbo):.6f} (abs err {zero_err:.3e}); gradients on "
          f"{int(keep.sum())} of {n} trajectories off the knots", flush=True)
    return row


def bn_flow_steps(flow_model, opt, gen, data, steps):
    """``steps`` maximum-likelihood steps on batches drawn from ``gen``,
    each followed by update_batch_stats on its batch: the losses."""
    step = make_train_step(lambda m, b, g: -m.log_prob(b, train=True).mean(),
                           opt)
    losses = []
    for _ in range(steps):
        idx = torch.randint(data.shape[0], (TRAIN_BATCH,), generator=gen,
                            device=data.device)
        batch = data[idx]
        losses.append(step(flow_model, batch, gen)[0])
        flow_model.flowed_dist.flow.update_batch_stats(batch)
    return torch.stack(losses).tolist()


def bn_flow_model(seed):
    return ExperimentConfig(model=FlowModelConfig(FlowedDistConfig(
        MAFConfig(data_dim=FLOW_D, num_blocks=3, order_seed=5,
                  batch_norm=True, rqs=RQSParams()),
        base=None, static_base_dim=FLOW_D)), seed=seed).build()


def bn_stat_distance(flow, data):
    """How far each batch norm's running moments sit from the moments of
    its own input on ``data`` (the density pass in training mode)."""
    out = 0.0
    y = data
    for bij in flow.as_bijector(train=True).bijectors:
        inner = bij.inner if isinstance(bij, bj.Block) else None
        if hasattr(inner, "update_moments"):
            y, _, m, v = inner.inverse_and_log_det_and_moments(y)
            bn = inner.bn if hasattr(inner, "bn") else inner
            out += float((bn.mean - m).norm() + (bn.var - v).norm())
        else:
            y = bij.inverse(y)
    return out


def flow_bn_path(dev):
    """The D=8 MAF flow model with 3 blocks and batch norm between them
    (reference widths): maximum likelihood at batch 10k with
    update_batch_stats after each step, then predict of 10k samples
    (kernel 3 in both directions), and a checkpoint round trip: saved
    mid-training, restored into a fresh model, optimizer and generator,
    it continues with the uninterrupted run's losses."""
    data = gaussian_data(dev)
    model = bn_flow_model(0)
    flow = model.flowed_dist.flow
    fail_unless(len(flow.bn_params) == 2, "two batch-norm bijectors")
    probe = torch.zeros(TRAIN_BATCH, FLOW_D, device=dev)
    sample_gen = torch.Generator(device=dev).manual_seed(42)
    with torch.no_grad():
        before = moment_distance(model.predict(probe, sample_gen), data)
        stat_before = bn_stat_distance(flow, data[:TRAIN_BATCH])
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    gen = torch.Generator(device=dev).manual_seed(43)
    warm = bn_flow_steps(model, opt, gen, data, 2)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    losses = bn_flow_steps(model, opt, gen, data, BN_STEPS)
    dt = time.perf_counter() - t0
    counts = path_counts("flow_bn_path")
    fail_unless(counts["maf_block"] > 0,
                f"batch-norm flow training launch counts {counts}")
    fail_unless(all(math.isfinite(v) for v in warm + losses)
                and losses[-1] < warm[0],
                f"batch-norm flow loss did not fall: {warm + losses}")
    busy = busy_share(lambda: bn_flow_steps(model, opt, gen, data, 4), 4)
    _build.reset_launches()
    with torch.no_grad():
        samples = model.predict(probe, sample_gen)
        stat_after = bn_stat_distance(flow, data[:TRAIN_BATCH])
    predict_counts = path_counts("flow_bn_path 1")
    fail_unless(predict_counts["maf_block"] > 0,
                f"batch-norm flow sampling launch counts {predict_counts}")
    fail_unless(bool(torch.isfinite(samples).all())
                and samples.shape == (TRAIN_BATCH, FLOW_D),
                "batch-norm flow samples not finite or of the wrong shape")
    after = moment_distance(samples, data)
    fail_unless(after < before, f"batch-norm flow samples did not move "
                f"toward the data: moment distance {before} -> {after}")
    fail_unless(stat_after < stat_before, f"running moments did not move "
                f"toward their inputs': {stat_before} -> {stat_after}")

    path = os.path.join("chiprun_out", "flow_bn_checkpoint.pt")
    save_checkpoint(path, {"model": model, "opt": opt, "gen": gen})
    uninterrupted = bn_flow_steps(model, opt, gen, data, CKPT_STEPS)
    fresh = bn_flow_model(1)
    fresh_opt = torch.optim.Adam(fresh.parameters(), lr=1e-3)
    fresh_gen = torch.Generator(device=dev)
    restore_checkpoint(path, {"model": fresh, "opt": fresh_opt,
                              "gen": fresh_gen})
    os.remove(path)
    resumed = bn_flow_steps(fresh, fresh_opt, fresh_gen, data, CKPT_STEPS)
    resume_err = max(abs(a - b) / max(1.0, abs(a))
                     for a, b in zip(uninterrupted, resumed))
    fail_unless(resume_err <= 1e-6, f"resumed losses {resumed} differ from "
                f"the uninterrupted run's {uninterrupted}")
    with torch.no_grad():
        ms = timed(lambda: model.predict(probe, sample_gen), reps=10)
    row = sampling_row(
        "flow_bn_train", dt, BN_STEPS / dt, "steps/s", counts, busy,
        ms_per_step=1e3 * dt / BN_STEPS, losses=warm + losses,
        predict_launches=predict_counts, predict_ms=ms,
        samples_per_s=TRAIN_BATCH / (ms * 1e-3),
        moment_distance=[before, after],
        bn_stat_distance=[stat_before, stat_after],
        resume_rel_err=resume_err, resume_bit_exact=uninterrupted == resumed)
    print(f"flow_bn {1e3 * dt / BN_STEPS:.3f} ms/step  predict "
          f"{row['samples_per_s']:.1f} samples/s ({ms:.4f} ms)  moment "
          f"distance {before:.4f} -> {after:.4f}  running moments "
          f"{stat_before:.4f} -> {stat_after:.4f}  checkpoint resume max "
          f"rel err {resume_err:.3e} (bit exact: "
          f"{row['resume_bit_exact']})", flush=True)
    return model, row


def ensemble_member(seed, dev):
    """Example 09's member: a 1-D RQSSplineRealNVP (4 blocks, 16 bins on
    [-5, 5], hidden 64) over a standard normal."""
    base = dist.Independent(dist.Normal(torch.zeros(1, device=dev),
                                        torch.ones(1, device=dev)), 1)
    return StaticFlowedDistribution(RQSSplineRealNVP.create(
        torch.Generator(device=dev).manual_seed(seed), 1, num_blocks=4,
        rqs_params={"num_bins": 16, "hidden_dim": 64,
                    "bin_range": [-5.0, 5.0]}), base)


def member_kernel_bounds(M, n, ks, bs=None, K=None):
    """(bound µs, what bounds it) of M members' dense stacks (weights
    ``ks``, biases ``bs``, n rows each) or, with ``K``, of M splines of
    one K-bin knot row over n elements each."""
    if K is not None:
        return _bound(4 * M * (3 * n + 3 * K - 1), M * n * spline_flops(K))
    nbytes = 4 * M * (n * (ks[0].shape[1] + ks[-1].shape[2])
                      + sum(k[0].numel() for k in ks)
                      + sum(b[0].numel() for b in bs))
    return _bound(nbytes, 2 * M * n * sum(k[0].numel() for k in ks))


def check_member_kernels(stack, gen, dev):
    """Kernels 2 and 1 with a member axis (one launch for all members),
    each against the plain version run member by member: example 09's
    conditioner at its trained stacked weights (M = ENS_K, one ones row,
    1->64->47 tanh; the small-N regime), the backmapping decoder's widths
    for M = 3 members at 1024 rows (the tiled regime), and M = ENS_K knot
    rows of 16 bins on [-5, 5], one a member over 1024 elements each,
    forward and inverse (the table regime), at check_dense_stack's and
    check_rqs's tolerances (two log-dets of the 8192 may differ more),
    each member's spline also bit for bit against its own single-spline
    launch.  Each
    is timed against the plain version vmapped over the members (one
    batched call), beside its bound; the stacks also against the batched
    library chain (baddbmm, tanh, baddbmm)."""
    state = stack.state()
    pre = "flow.blocks.0.conditioner."
    heads = ("w_head", "h_head", "s_head")
    cond_case = (
        [state[pre + "trunk.kernel"],
         torch.cat([state[f"{pre}{h}.kernel"] for h in heads], -1)],
        [state[pre + "trunk.bias"],
         torch.cat([state[f"{pre}{h}.bias"] for h in heads], -1)])
    tiled = ([torch.randn(3, a, b, generator=gen, device=dev) / math.sqrt(a)
              for a, b in ((20, 40), (40, 9))],
             [0.1 * torch.randn(3, b, generator=gen, device=dev)
              for b in (40, 9)])
    cases = [(f"members M={ENS_K} N=1 1->64->47 tanh", cond_case,
              ["tanh", None], 1),
             ("members M=3 N=1024 20->40->9 relu", tiled, ["relu", None],
              1024)]
    for name, (ks, bs), acts, n in cases:
        M = ks[0].shape[0]
        x = (torch.ones(M, n, ks[0].shape[1], device=dev) if n == 1 else
             torch.randn(M, n, ks[0].shape[1], generator=gen, device=dev))
        got = dense_stack_members_cuda(x, ks, bs, acts)
        want = torch.stack([dense_stack_plain(
            x[m], [k[m] for k in ks], [b[m] for b in bs], acts)
            for m in range(M)])
        err = compare(name, got, want, 1e-4, 1e-4)
        plain = torch.func.vmap(
            lambda xm, k1, k2, b1, b2: dense_stack_plain(
                xm, [k1, k2], [b1, b2], acts))
        ms = timed(lambda: dense_stack_members_cuda(x, ks, bs, acts))
        plain_ms = timed(lambda: plain(x, *ks, *bs))
        act = torch.tanh if acts[0] == "tanh" else torch.relu
        lib_ms = timed(lambda: torch.baddbmm(
            bs[1][:, None], act(torch.baddbmm(bs[0][:, None], x, ks[0])),
            ks[1]))
        bound_us, bound_by = member_kernel_bounds(M, n, ks, bs)
        record("dense_stack", name, err, ms, plain_ms,
               regime=stack_regime(n, [ks[0].shape[1]]
                                   + [k.shape[2] for k in ks])[0],
               bound_us=bound_us, bound_by=bound_by, library_ms=lib_ms)
    K, n = 16, 1024
    raw = [torch.randn(ENS_K, 1, 1, k, generator=gen, device=dev)
           for k in (K, K, K - 1)]
    params = (_bin_positions(raw[0], -5.0, 5.0, K),
              _bin_positions(raw[1], -5.0, 5.0, K), _slopes(raw[2]))
    x = torch.rand(ENS_K, n, 1, generator=gen, device=dev) * 14.0 - 7.0
    for inverse in (False, True):
        plain = rqs.rqs_inverse_plain if inverse else rqs.rqs_forward_plain
        got = rqs.rqs_members_cuda(x, *params, -5.0, inverse)
        want = [torch.stack(v) for v in zip(*[
            plain(x[m], *(p[m] for p in params), -5.0)
            for m in range(ENS_K)])]
        # Two log-dets of the 8192 may differ more: the inverse's root near
        # a vanishing discriminant magnifies FMA contraction.
        err = max(compare("rqs members value", got[0], want[0], 1e-5, 1e-5),
                  compare("rqs members ldj", got[1], want[1], 1e-4, 0.0,
                          2 / got[1].numel()))
        for m in range(ENS_K):
            one = rqs.rqs_cuda(x[m], *(p[m] for p in params), -5.0, inverse)
            fail_unless(torch.equal(got[0][m], one[0])
                        and torch.equal(got[1][m], one[1]),
                        f"rqs members: member {m} differs from its own "
                        "single-spline launch")
        vplain = torch.func.vmap(lambda *a: plain(*a, -5.0))
        ms = timed(lambda: rqs.rqs_members_cuda(x, *params, -5.0, inverse))
        plain_ms = timed(lambda: vplain(x, *params))
        bound_us, bound_by = member_kernel_bounds(ENS_K, n, None, K=K)
        way = "inverse" if inverse else "forward"
        record("rqs", f"members M={ENS_K} {way} broadcast N={n} K={K}",
               err, ms, plain_ms,
               plan=rqs.kernel_plan(n, K, 1, members=ENS_K),
               bound_us=bound_us, bound_by=bound_by)


def ensemble_path(dev):
    """examples/09_ensemble_training.py at --full widths (K = 8 members,
    ENS_TRAIN training and 10k validation points of the 4-mode mixture, batch
    1024, Adam 3e-3) through fit_ensemble, ENS_EPOCHS epochs: each step
    one vmapped gradient over the stacked members, so kernels 2 and 1
    launch once a block for all members (the kernels' member axis) and
    never one member at a time; then each member-batched kernel against
    its plain version member by member (check_member_kernels), and the
    example's own validation: each member's held-out NLL, the
    deep-ensemble NLL against the target's entropy, and the best
    member's mode split of 20k samples (about 0.75 / 0.5 / 0.25)."""
    target = dist.MixtureSameFamily(
        torch.zeros(4, device=dev),
        dist.Normal(torch.tensor([-3.0, -1.0, 1.0, 3.0], device=dev),
                    0.25 * torch.ones(4, device=dev)))
    gen = torch.Generator(device=dev).manual_seed(44)
    train = target.sample(gen, (ENS_TRAIN,))[:, None]
    val = target.sample(gen, (ENS_VAL,))[:, None]
    stack = stack_models([ensemble_member(100 + i, dev)
                          for i in range(ENS_K)])

    def val_nll():
        with torch.no_grad():
            return torch.stack([-m().log_prob(val).mean() for m in stack])

    nll_before = val_nll()
    _build.reset_launches()
    with RqsRoutes() as routes:
        t0 = time.perf_counter()
        stack, hist = fit_ensemble(
            stack, lambda f, b, g: -f().log_prob(b).mean(), train,
            generator=gen, num_epochs=ENS_EPOCHS, batch_size=ENS_BATCH,
            learning_rate=3e-3)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    counts = path_counts("ensemble_path",
                         expect=("rqs_members", "dense_stack_members"))
    steps = ENS_EPOCHS * (ENS_TRAIN // ENS_BATCH)
    blocks = len(stack[0].flow.blocks)
    fail_unless(all(counts[k] == counts[f"{k}_members"] == blocks * steps
                    for k in ("rqs", "dense_stack")),
                f"ensemble launch counts {counts}: expected one member-"
                f"batched launch of kernels 1 and 2 a block a step "
                f"({blocks} x {steps}) and no other")
    with torch.no_grad():
        check_member_kernels(stack, gen, dev)
    nll = val_nll()
    with torch.no_grad():
        member_lp = torch.stack([m().log_prob(val) for m in stack])
        ens_nll = -float((torch.logsumexp(member_lp, 0)
                          - math.log(ENS_K)).mean())
        entropy = -float(target.log_prob(val[:, 0]).mean())
        best = int(torch.argmin(nll))
        samples = unstack_model(stack, best)().sample(gen, (20_000,))
        edges = torch.tensor([-2.0, 0.0, 2.0], device=dev)
        split = (samples[:, 0, None] > edges).float().mean(0).tolist()
    fail_unless(bool(torch.isfinite(nll).all() and (nll < nll_before).all()),
                f"ensemble validation NLL {nll.tolist()} (before "
                f"{nll_before.tolist()})")
    fail_unless(ens_nll <= float(nll.mean()) + 1e-6
                and ens_nll - entropy < ENS_NLL_GAP,
                f"ensemble NLL {ens_nll} against the target's entropy "
                f"{entropy}")
    fail_unless(all(abs(a - b) < 0.05 for a, b in zip(split,
                                                       (0.75, 0.5, 0.25))),
                f"best member's mode split {split}")
    busy = busy_share(lambda: fit_ensemble(
        stack, lambda f, b, g: -f().log_prob(b).mean(), train[:ENS_BATCH],
        generator=gen, num_epochs=1, batch_size=ENS_BATCH,
        learning_rate=3e-3), 1)
    row = sampling_row(
        "ensemble", dt, ENS_K * steps / dt, "member-steps/s", counts, busy,
        ms_per_step=1e3 * dt / steps, members=ENS_K, epochs=ENS_EPOCHS,
        vmapped=True,
        val_nll=nll.tolist(), ensemble_nll=ens_nll, target_entropy=entropy,
        best_member=best, mode_split=split, routes=dict(routes),
        losses=[h.tolist() for h in hist["loss"]])
    print(f"ensemble K={ENS_K} {1e3 * dt / steps:.3f} ms per ensemble step "
          f"({row['rate']:.1f} member-steps/s)  validation NLL "
          f"{[round(v, 4) for v in nll.tolist()]}  ensemble {ens_nll:.4f} "
          f"(target entropy {entropy:.4f})  best {best} split "
          f"{[round(v, 3) for v in split]}", flush=True)
    return row


def backmapping_ar_path(dev):
    """The backmapping notebook's model with the autoregressive von
    Mises mixture decoder (BASELINE.json's config 3: 3 DOFs, 2
    components each, a MADE 3 -> 24 -> 24): fit() at batch 128 on 2000
    frames, then predict and log_prob at 10k sites, log_prob under
    rotation."""
    register_von_mises_mixture(2)
    cfg = backmapping_experiment_config()
    cfg.model.decoder = MappingToDistConfig(
        input_shape=20, dist=DistLayerConfig(
            kind="autoregressive_blockwise", num_dofs=3,
            families="von_mises_mixture_2"),
        mapping_kwargs={"hidden_dim": 40})
    bm = cfg.build()
    data = backmapping_frames(BM_FRAMES, 45, dev)
    row = train_path("backmapping_ar", bm,
                     lambda m, b, g: -m.log_prob(*b).mean(), data, dev,
                     batch=BM_BATCH, epochs=BM_EPOCHS)
    fail_unless(row["launches"]["pair_attention"] > 0
                and row["launches"]["dense_stack"] > 0,
                f"autoregressive backmapping training launch counts "
                f"{row['launches']}")
    ref, coords, info, tors = backmapping_frames(BM_SITES, 46, dev)
    gen = torch.Generator(device=dev).manual_seed(47)
    reps = 5
    with torch.no_grad():
        bm.predict(ref, coords, info, gen)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        for _ in range(reps):
            samples = bm.predict(ref, coords, info, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(reps):
            lp = bm.log_prob(ref, coords, info, tors)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = path_counts("backmapping_ar_path", expect=("pair_attention",))
        busy = busy_share(lambda: bm.predict(ref, coords, info, gen), 1)
        R = torch.tensor(np.linalg.qr(np.random.default_rng(48).normal(
            size=(3, 3)))[0], dtype=torch.float32, device=dev)
        lp_rot = bm.log_prob(ref @ R.T, coords @ R.T, info, tors)
    fail_unless(counts["pair_attention"] > 0 and counts["dense_stack"] > 0,
                f"autoregressive backmapping serving launch counts {counts}")
    fail_unless(samples.shape == (BM_SITES, 3)
                and bool(torch.isfinite(samples).all())
                and bool((samples.abs() <= math.pi + 1e-5).all()),
                "autoregressive torsions not finite, of the wrong shape or "
                "outside [-pi, pi]")
    fail_unless(lp.shape == (BM_SITES,) and bool(torch.isfinite(lp).all()),
                "autoregressive log_prob not finite or of the wrong shape")
    rot_err = compare("autoregressive log_prob under rotation", lp_rot, lp,
                      1e-4, 1e-4, 1e-3)
    row.update(predict_sites_per_s=BM_SITES * reps / (t1 - t0),
               log_prob_sites_per_s=BM_SITES * reps / (t2 - t1),
               predict_ms=1e3 * (t1 - t0) / reps,
               log_prob_ms=1e3 * (t2 - t1) / reps, serve_launches=counts,
               rotation_max_abs_err=rot_err, predict_busy=busy)
    print(f"backmapping_ar predict {row['predict_sites_per_s']:.1f} sites/s "
          f"({row['predict_ms']:.3f} ms)  log_prob "
          f"{row['log_prob_sites_per_s']:.1f} sites/s "
          f"({row['log_prob_ms']:.3f} ms)  predict device busy "
          f"{busy[1]} of {busy[0]:.3f} ms  rotation max abs err "
          f"{rot_err:.3e}", flush=True)
    return row, bm.decoder.dist.made


def check_slice9_kernels(made, bn_model, gen, dev):
    """Kernel 2 at the autoregressive MADE (3 -> 24 -> 24 tanh, its own
    masked weights) on 10k sites' raw draws, and kernel 3 at the middle
    block of the batch-norm flow (permuted order, batch norm on either
    side) on its own density-pass inputs, both directions: tolerances as
    in check_dense_stack and check_maf_block."""
    ks = [(k * m).detach() for k, m in zip(made.kernels, made.masks)]
    bs = [b.detach() for b in made.biases]
    acts = [made.activation, None]
    x = torch.rand(BM_SITES, 3, generator=gen, device=dev) * 2 * math.pi \
        - math.pi
    got = dense_stack_cuda(x, ks, bs, acts)
    want = dense_stack_plain(x, ks, bs, acts)
    err = compare("autoregressive MADE", got, want, 1e-4, 1e-4)
    ms = timed(lambda: dense_stack_cuda(x, ks, bs, acts))
    plain_ms = timed(lambda: dense_stack_plain(x, ks, bs, acts))
    b_us, b_by = stack_bound(BM_SITES, ks, bs)
    record("dense_stack", f"autoregressive MADE 3->24->24 tanh N={BM_SITES}",
           err, ms, plain_ms, bound_us=b_us, bound_by=b_by,
           regime=stack_regime(BM_SITES, [3] + [k.shape[1] for k in ks],
                               0)[0])
    flow = bn_model.flowed_dist.flow
    layer = flow.blocks[1]
    cond = layer.conditioner
    chain = flow.as_bijector(train=False).bijectors  # block2, BN, block1, ..
    y = gaussian_data(dev)[:TRAIN_BATCH]
    for bij in chain[:2]:
        y = bij.inverse(y)
    params = [p.detach() for p in cond.merged_params() if p is not None]
    D, K = cond.w_net.event_size, cond.num_bins
    deg = cond.w_net.input_order_static
    for inverse in (True, False):
        args = (y, params, None, D, K, cond.bin_min, cond.bin_max, inverse)
        got = maf_fused.maf_block_cuda(*args, degrees=deg)
        want = maf_fused.maf_block_plain(*args)
        err = max(compare("maf_block middle x", got[0], want[0], 1e-4, 1e-4,
                          1e-4),
                  compare("maf_block middle ldj", got[1], want[1], 1e-3,
                          1e-4, 1e-4))
        ms = timed(lambda: maf_fused.maf_block_cuda(*args, degrees=deg))
        plain_ms = timed(lambda: maf_fused.maf_block_plain(*args))
        direction = "inverse" if inverse else "forward"
        record("maf_block", f"{direction} D={D} middle block between batch "
               f"norms, order {deg} N={TRAIN_BATCH}", err, ms, plain_ms)


# ---------------------------------------------------------------------------
# Slice 10: joint backmapping, SchNet, BAT/NeRF and trajectory I/O,
# checkpointed MC, kernel 3's bf16 mode, and the refused-plan routes
# ---------------------------------------------------------------------------


def path_counts(name, expect=()):
    """The launch counts since the last reset, with each kernel's
    named-mode launches as ``<kernel>_<mode>`` (the MAF block's bf16
    mode: ``maf_block_bf16``); fails unless every kernel named in
    ``expect`` launched on this main path."""
    counts = _build.launch_counts()
    for kname, k in _build.KERNELS.items():
        for mode, n in k.mode_launches.items():
            counts[f"{kname}_{mode}"] = n
    RESULTS.setdefault("path_launches", {})[name] = dict(counts)
    fail_unless(all(counts.get(k, 0) > 0 for k in expect),
                f"{name}: expected launches of {expect}, got {counts}")
    return counts


def maf_block_work(cond, n, bf16=False):
    """(bytes, least float32 operations, least bfloat16 operations) of one
    MAF-block call on n rows (the count of ``bounds``): rows, weights and
    outputs once; the products the MADE masks leave (bfloat16 products
    with ``bf16``, at the tensor cores' rate), the softmaxes and the
    spline (float32)."""
    D, H, K = (cond.w_net.event_size, cond.w_net.kernels[0].shape[1],
               cond.num_bins)
    head = H * D * (3 * K - 1)
    nbytes = 4 * (n * (2 * D + 1) + D * 3 * H + 3 * H + head
                  + D * (3 * K - 1))
    masked = sum(int(m.sum()) for net in cond.nets for m in net.masks)
    rest = n * D * (2 * 3 * K + spline_flops(K))
    if bf16:
        return nbytes, rest, 2 * n * masked
    return nbytes, 2 * n * masked + rest, 0


def check_maf_case(label, layer, y, compute_dtype=None, keep=None,
                   allowed=1e-4):
    """Kernel 3 on y (its layer's own weights) against its plain version
    in the same mode, both directions, timed with its bound; rows outside
    ``keep`` (near a knot) left out.  Tolerances as check_maf_block's."""
    cond = layer.conditioner
    params = [p.detach() for p in cond.merged_params() if p is not None]
    D, K = cond.w_net.event_size, cond.num_bins
    deg = cond.w_net.input_order_static
    mode = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
    out = {}
    for inverse in (True, False):
        args = (y, params, None, D, K, cond.bin_min, cond.bin_max, inverse)

        def kernel():
            return maf_fused.maf_block_cuda(*args, degrees=deg, **mode)

        def plain():
            return maf_fused.maf_block_plain(*args, **mode)

        got, want = kernel(), plain()
        sel = slice(None) if keep is None else keep
        err = max(compare(f"maf_block {label} x", got[0][sel], want[0][sel],
                          1e-4, 1e-4, allowed),
                  compare(f"maf_block {label} ldj", got[1][sel],
                          want[1][sel], 1e-3, 1e-4, allowed))
        ms, plain_ms = timed(kernel), timed(plain)
        b_us, b_by = _bound(*maf_block_work(cond, y.shape[0],
                                            compute_dtype == torch.bfloat16))
        direction = "inverse" if inverse else "forward"
        record("maf_block", f"{direction} {label}", err, ms, plain_ms,
               bound_us=b_us, bound_by=b_by)
        out[direction] = (err, ms, plain_ms, b_us, b_by)
    return out


def wf_frames(dev):
    """examples/06's stand-in MD data, made on the card: the 8-atom chain
    with bonds 1.53 +- 0.03, angles 1.91 +- 0.05 and torsions trans (pi,
    with probability 0.7) or gauche (pi / 3), spread 0.15, wrapped."""
    g = torch.Generator(device=dev).manual_seed(0)
    n, A = WF_FRAMES, WF_ATOMS
    bonds = 1.53 + 0.03 * torch.randn(n, A - 1, generator=g, device=dev)
    angles = 1.91 + 0.05 * torch.randn(n, A - 2, generator=g, device=dev)
    trans = torch.rand(n, A - 3, generator=g, device=dev) < 0.7
    tors = (torch.where(trans, math.pi, math.pi / 3.0)
            + 0.15 * torch.randn(n, A - 3, generator=g, device=dev))
    tors = tors - 2 * math.pi * torch.round(tors / (2 * math.pi))
    return coords.cartesian_from_bat(bonds, angles, tors,
                                     coords.chain_zmatrix(A))


def wrapped(d):
    return (d + math.pi) % (2 * math.pi) - math.pi


def molecular_workflow_path(dev):
    """examples/06 at --full: WF_FRAMES frames of the 8-atom chain written
    with ``write_dcd`` and read back with ``DCDReader``; BAT; a 3-block
    periodic MAF (5 torsions, 16 bins, hidden 64, bins on [-pi, pi]) over
    a von Mises base, its base parameters from a FlowModel mapping of a
    constant input, through ``fit`` for WF_EPOCHS epochs at batch
    WF_BATCH (kernels 3 and 2); ``predict`` WF_GEN torsions, NeRF back
    to Cartesian frames, ``write_dcd`` and read back.  Checks: the
    BAT -> Cartesian -> BAT round trip (1e-4), the final NLL (< 1.2),
    the generated trans population (within 0.06 of the data's), the
    files read back equal what was written; kernel 3 at this shape
    against its plain version."""
    z = coords.chain_zmatrix(WF_ATOMS)
    frames = wf_frames(dev).cpu().numpy()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_wf_")
    try:
        path = os.path.join(workdir, "input.dcd")
        data.write_dcd(path, frames)
        reader = data.DCDReader(path)
        read, _ = reader.read()
        backend = reader.backend
        reader.close()
        fail_unless(np.array_equal(read, frames),
                    "DCD read back differs from what was written")
        print(f"workflow: read {read.shape[0]} frames x {read.shape[1]} "
              f"atoms ({backend} backend)", flush=True)
        x = torch.as_tensor(read, device=dev)
        bonds, angles, tors = coords.bat_from_cartesian(x, z)
        again = coords.bat_from_cartesian(
            coords.cartesian_from_bat(bonds, angles, tors, z), z)
        round_trip = max(float((again[0] - bonds).abs().max()),
                         float((again[1] - angles).abs().max()),
                         float(wrapped(again[2] - tors).abs().max()))
        fail_unless(round_trip < 1e-4, f"BAT round trip error {round_trip}")
        n_t = tors.shape[-1]
        gen = torch.Generator(device=dev).manual_seed(1)
        flow = RQSSplineMAF.create(
            gen, n_t, num_blocks=3,
            rqs_params={"num_bins": 16, "hidden_dim": 64,
                        "bin_range": [-math.pi, math.pi]}, device=dev)
        model = FlowModel.create(
            gen, FlowedDistribution(flow, IndependentBlockwise.create(
                n_t, "von_mises")), input_shape=1,
            mapping_kwargs={"hidden_dim": 16}, device=dev)

        def loss_fn(m, batch, g):
            return -m(torch.ones_like(batch[:, :1])).log_prob(batch).mean()

        fit_gen = torch.Generator(device=dev).manual_seed(3)
        torch.cuda.synchronize()
        _build.reset_launches()
        _, hist = fit(model, loss_fn, tors, generator=fit_gen,
                      num_epochs=WF_EPOCHS, batch_size=WF_BATCH,
                      learning_rate=3e-3)
        counts = path_counts("molecular_workflow_train")
        fail_unless(counts["maf_block"] > 0 and counts["dense_stack"] > 0,
                    f"workflow training launch counts {counts}")
        per_epoch = WF_FRAMES // WF_BATCH
        ms_step = 1e3 * sum(hist["epoch_time_s"]) / (WF_EPOCHS * per_epoch)
        nll = hist["loss"]
        fail_unless(all(math.isfinite(v) for v in nll) and nll[-1] < 1.2,
                    f"workflow NLL {nll[0]} -> {nll[-1]} (wanted < 1.2)")
        window_ms, busy_ms, idle = busy_share(lambda: fit(
            model, loss_fn, tors[:PROFILED_STEPS * WF_BATCH],
            generator=fit_gen, num_epochs=1, batch_size=WF_BATCH,
            learning_rate=3e-3), PROFILED_STEPS)
        ones = torch.ones(WF_GEN, 1, device=dev)
        with torch.no_grad():
            _build.reset_launches()
            gen_tors = model.predict(ones, gen)
            predict_counts = path_counts("molecular_workflow_predict")
            fail_unless(predict_counts["maf_block"] > 0,
                        f"workflow predict launch counts {predict_counts}")
            predict_ms = timed(lambda: model.predict(ones, gen), reps=5)
            gen_frames = coords.cartesian_from_bat(
                bonds.mean(0).expand(WF_GEN, -1),
                angles.mean(0).expand(WF_GEN, -1), gen_tors, z)
        fail_unless(bool(torch.isfinite(gen_frames).all()),
                    "generated frames not finite")
        out_path = os.path.join(workdir, "generated.dcd")
        data.write_dcd(out_path, gen_frames.cpu().numpy())
        back = data.DCDReader(out_path)
        fail_unless(back.n_frames == WF_GEN and np.array_equal(
            back.read()[0], gen_frames.cpu().numpy()),
            "generated DCD read back differs")
        back.close()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    data_trans = float((tors.abs() > 2.0).float().mean())
    gen_trans = float((gen_tors.abs() > 2.0).float().mean())
    fail_unless(abs(gen_trans - data_trans) < 0.06,
                f"trans population: data {data_trans}, generated "
                f"{gen_trans}")
    with torch.no_grad():
        layer = flow.blocks[0]
        y = tors[:WF_BATCH].contiguous()
        keep = knot_safe([layer], y).to(dev)
        check_maf_case(f"D={n_t} K=16 H=64 example 06 N={WF_BATCH}", layer,
                       y, keep=keep)
    row = {"path": "molecular_workflow", "frames": WF_FRAMES,
           "dcd_backend": backend, "round_trip_max_abs_err": round_trip,
           "nll": [nll[0], nll[-1]], "ms_per_step": ms_step,
           "profiled_ms_per_step": window_ms, "device_busy_ms_per_step":
           busy_ms, "device_idle_share": idle, "data_trans": data_trans,
           "generated_trans": gen_trans, "predict_ms": predict_ms,
           "launches": counts, "predict_launches": predict_counts}
    RESULTS["molecular_workflow"] = row
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} of {window_ms:.3f} ms/step ({idle:.3f} idle)")
    print(f"workflow: BAT round trip {round_trip:.3e}  NLL {nll[0]:.3f} -> "
          f"{nll[-1]:.3f}  {ms_step:.3f} ms/step  device busy {busy}  "
          f"trans data {data_trans:.3f} generated {gen_trans:.3f}  "
          f"predict {WF_GEN} in {predict_ms:.3f} ms", flush=True)
    return row


def jb_systems(n, dev):
    """examples/16's systems, made on the card: a noisy 6-residue helix of
    CG sites with info t / R, and D = 2 torsions a residue whose mean
    follows the distance to the next site and, with coupling JB_COUPLE,
    the previous residue's torsions, wrapped to [-pi, pi]."""
    g = torch.Generator(device=dev).manual_seed(0)
    R, D = JB_R, JB_D
    t = torch.arange(R, dtype=torch.float32, device=dev)
    helix = torch.stack([torch.cos(0.9 * t), torch.sin(0.9 * t), 0.4 * t], -1)
    cg = helix + 0.25 * torch.randn(n, R, 3, generator=g, device=dev)
    info = (t / R)[None, :, None].expand(n, R, 1).contiguous()
    nbr = (cg[:, 1:] - cg[:, :-1]).norm(dim=-1)
    nbr = torch.cat([nbr, nbr[:, -1:]], 1)
    mu_geo = 1.5 * (nbr - nbr.mean())
    prev, xs = torch.zeros(n, D, device=dev), []
    for r in range(R):
        x_r = (JB_COUPLE * prev.mean(-1, keepdim=True) + mu_geo[:, r:r + 1]
               + 0.3 * torch.randn(n, D, generator=g, device=dev))
        prev = x_r - 2 * math.pi * torch.round(x_r / (2 * math.pi))
        xs.append(prev)
    return cg, info, torch.stack(xs, 1)


def adjacent_correlation(x):
    m = x.mean(-1).double().cpu().numpy()
    return float(np.corrcoef(m[:, :-1].ravel(), m[:, 1:].ravel())[0, 1])


def jb_model(embedding, dev):
    return JointBackmapping.create(
        torch.Generator(device=dev).manual_seed(1), JB_D, 1,
        IndependentBlockwise.create(JB_D, "von_mises"), embed_dim=12,
        prefix_dim=8, cutoff=4.0, max_included=4, mapping_hidden=32,
        embedding=embedding, device=dev)


def jb_train(model, cg, info, x, steps, freeze_prefix=False):
    """Adam 3e-3 on the NLL per DOF, full batch, as the example; with
    ``freeze_prefix`` the residue encoder is zeroed and left out (the
    independent-decoder ablation).  Returns (last step's loss, ms a
    step)."""
    if freeze_prefix:
        with torch.no_grad():
            for p in model.residue_encoder.parameters():
                p.zero_()
                p.requires_grad_(False)
    opt = torch.optim.Adam([p for p in model.parameters()
                            if p.requires_grad], lr=3e-3)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = -model(cg, info).log_prob(x).mean() / (JB_R * JB_D)
        loss.backward()
        opt.step()
        return loss

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step()
    loss = float(loss.detach())
    return loss, 1e3 * (time.perf_counter() - t0) / steps, step


def joint_backmapping_path(dev):
    """examples/16 at --full: JB_SYSTEMS systems of JB_R residues, SchNet
    embeddings (embed 12, prefix 8, cutoff 4, max_included 4, mapping
    hidden 32), JB_STEPS Adam steps; the prefix-zeroed ablation; then
    JB_SAMPLES sampled systems, with the example's own asserts (joint NLL
    below the ablation's by 0.02; sampled adjacent-residue correlation
    within 0.25 of the data's).  Then the same model with the attention
    embedding: ``log_prob`` at the JB_SYSTEMS systems (kernel 5 on
    JB_SYSTEMS x JB_R clouds of 4, kernel 2 in the mapping) against a CPU
    copy, gradients against the CPU copy's, kernel 5 at this shape
    against its plain version, and a timed step of each embedding."""
    cg, info, x = jb_systems(JB_SYSTEMS, dev)
    c_data = adjacent_correlation(x)
    joint = jb_model("schnet", dev)
    _build.reset_launches()
    nll_joint, ms_joint, step = jb_train(joint, cg, info, x, JB_STEPS)
    counts = path_counts("joint_backmapping_schnet_train")
    window_ms, busy_ms, idle = busy_share(lambda: [step() for _ in range(3)],
                                          3)
    ablation = jb_model("schnet", dev)
    nll_indep, _, _ = jb_train(ablation, cg, info, x, JB_STEPS,
                               freeze_prefix=True)
    with torch.no_grad():
        samples = joint(cg[:JB_SAMPLES], info[:JB_SAMPLES]).sample(
            torch.Generator(device=dev).manual_seed(2))
    fail_unless(samples.shape == (JB_SAMPLES, JB_R, JB_D)
                and bool(torch.isfinite(samples).all()),
                "joint samples not finite or of the wrong shape")
    c_model = adjacent_correlation(samples)
    print(f"joint backmapping: NLL/DOF joint {nll_joint:.4f} independent "
          f"{nll_indep:.4f} (advantage {nll_indep - nll_joint:.4f})  "
          f"adjacent correlation sampled {c_model:.3f} data {c_data:.3f}  "
          f"{ms_joint:.3f} ms/step", flush=True)
    fail_unless(nll_joint < nll_indep - 0.02,
                "the joint decoder must beat the ablation by 0.02 nats/DOF")
    fail_unless(abs(c_model - c_data) < 0.25,
                "sampling must reproduce the adjacent-residue coupling")

    att = jb_model("attention", dev)
    plan = pa.kernel_plan(JB_SYSTEMS * JB_R, 4, 40, 12)
    fail_unless(plan["regime"] == "rows", f"kernel 5's plan {plan}")
    with torch.no_grad():
        _build.reset_launches()
        lp = att(cg, info).log_prob(x)
        att_counts = path_counts("joint_backmapping_attention_log_prob",
                                 expect=("pair_attention",))
        fail_unless(att_counts["pair_attention"] > 0
                    and att_counts["dense_stack"] > 0,
                    f"attention log_prob launch counts {att_counts}")
        cpu = copy.deepcopy(att).to("cpu")
        lp_cpu = cpu(cg.cpu(), info.cpu()).log_prob(x.cpu())
    # A CG site within float32 roundoff of the cutoff or of a top-k tie
    # may select otherwise on the two devices (1e-3 of systems allowed).
    lp_err = compare("joint attention log_prob against a CPU copy", lp.cpu(),
                     lp_cpu, 1e-4, 1e-4, 1e-3)
    check_grads("joint attention", att, lambda m, d: -m(
        cg.to(d), info.to(d)).log_prob(x.to(d)).mean(), dev)
    _build.reset_launches()
    _, ms_att, _ = jb_train(att, cg, info, x, 20)
    att_train = path_counts("joint_backmapping_attention_train",
                            expect=("pair_attention",))
    fail_unless(att_train["pair_attention"] > 0,
                f"attention training launch counts {att_train}")
    with torch.no_grad():
        lpd = att.cg_embed
        B, R = JB_SYSTEMS, JB_R
        sel, valid, sel_info = lpd.select(
            cg[:, None].expand(B, R, R, 3).reshape(B * R, R, 3),
            cg.reshape(B * R, 3),
            particle_info=info[:, None].expand(B, R, R, 1).reshape(
                B * R, R, 1))
        values = lpd.embed.info_net(sel_info)
        shape = f"joint N={sel.shape[1]} H=40 Fo=12 B={B * R}"
        pair_attention_case(shape, lpd.embed.blocks[0].attn, sel, values,
                            valid.float(), False, True)
        pair_attention_case(shape, lpd.embed.final_attn, sel, values,
                            valid.float(), True, True)
    row = {"path": "joint_backmapping", "systems": JB_SYSTEMS,
           "nll_joint": nll_joint, "nll_independent": nll_indep,
           "correlation_sampled": c_model, "correlation_data": c_data,
           "ms_per_step_schnet": ms_joint, "ms_per_step_attention": ms_att,
           "profiled_ms_per_step": window_ms,
           "device_busy_ms_per_step": busy_ms, "device_idle_share": idle,
           "attention_log_prob_max_abs_err": lp_err,
           "launches": counts, "attention_launches": att_counts,
           "attention_train_launches": att_train}
    RESULTS["joint_backmapping"] = row
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} of {window_ms:.3f} ms/step ({idle:.3f} idle)")
    print(f"joint backmapping: schnet step {ms_joint:.3f} ms (device busy "
          f"{busy}), attention step {ms_att:.3f} ms, attention log_prob "
          f"against CPU {lp_err:.3e}", flush=True)
    return row


def ml_potential_md_path(dev):
    """bench.py:736's configuration: a SchNetPotential (features 64, 3
    blocks, 32 RBFs, cutoff 2.5) over MLP_REPLICAS replicas of MLP_ATOMS
    atoms at density MLP_RHO in a periodic box, MLP_STEPS BAOAB steps of
    dt 0.002 after as many to equilibrate, forces by autograd; energies
    finite; ``energy_force_loss`` and its gradients against a CPU copy;
    replica-atom-steps/s and the idle share of a profiled window."""
    n, L = MLP_ATOMS, float((MLP_ATOMS / MLP_RHO) ** (1.0 / 3.0))
    gen = torch.Generator(device=dev).manual_seed(0)
    model = SchNetPotential.create(gen, 1, features=MLP_FEATURES,
                                   num_blocks=MLP_BLOCKS, n_rbf=MLP_RBF,
                                   cutoff=MLP_CUTOFF, device=dev)
    species = torch.ones(n, 1, device=dev)
    box = torch.full((3,), L, device=dev)
    pot = model.as_potential(species, box)
    x0, v0 = mlp_start(gen, L, dev)
    for p in model.parameters():
        p.requires_grad_(False)

    def run(x, v, steps):
        return md.baoab(pot, x, v, gen, dt=MLP_DT, n_steps=steps,
                        friction=1.0, kT=1.0)[0]

    st = run(x0, v0, MLP_STEPS)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = run(st.x, st.v, MLP_STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = path_counts("ml_potential_md")
    with torch.no_grad():
        e = pot(out.x)
    fail_unless(bool(torch.isfinite(e).all() and torch.isfinite(out.x).all()),
                "ML-potential MD: non-finite energies or positions")
    kt = float((out.v ** 2).mean())
    rate = MLP_REPLICAS * n * MLP_STEPS / seconds
    window_ms, busy_ms, idle = busy_share(lambda: run(out.x, out.v, 10), 10)
    for p in model.parameters():
        p.requires_grad_(True)
    # Energy and force targets near the model's own, on 32 replicas.
    xs = out.x[:32].detach()
    targets = (e[:32].detach() + 0.1, 0.1 * torch.randn(
        xs.shape, generator=gen, device=dev))
    check_grads("schnet energy_force_loss", model, lambda mod, d: (
        energy_force_loss(mod, xs.to(d), species.to(d), targets[0].to(d),
                          targets[1].to(d), box=box.to(d), w_energy=0.1)),
        dev)
    row = sampling_row("ml_potential_md", seconds, rate,
                       "replica-atom-steps/s", counts,
                       (window_ms, busy_ms, idle),
                       ms_per_step=1e3 * seconds / MLP_STEPS, kT=kt)
    return row


def two_stage_backmapping_path(dev):
    """The notebook's backmapping model (``backmapping_experiment_config``)
    with ``attention="two_stage"`` (plain PyTorch; the decoder on kernels 3
    and 2): ``predict`` and ``log_prob`` of BM_SITES sites, rotation
    invariance of ``log_prob``, and ``fit`` at batch BM_BATCH for one
    epoch of BM_FRAMES frames, with its gradients against a CPU copy."""
    cfg = backmapping_experiment_config()
    cfg.model.embedding.attention = "two_stage"
    bm = cfg.build(dev)
    fail_unless(isinstance(bm.mask_and_embed.embed.final_attn,
                           VectorAttentionTwoStage),
                "attention='two_stage' did not build the two-stage layer")
    ref, crd, info, tors = backmapping_frames(BM_SITES, 22, dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    with torch.no_grad():
        bm.predict(ref, crd, info, gen)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        samples = bm.predict(ref, crd, info, gen)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lp = bm.log_prob(ref, crd, info, tors)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = path_counts("two_stage_backmapping_serve")
        R = torch.tensor(np.linalg.qr(np.random.default_rng(24).normal(
            size=(3, 3)))[0], dtype=torch.float32, device=dev)
        lp_rot = bm.log_prob(ref @ R.T, crd @ R.T, info, tors)
    fail_unless(counts["maf_block"] > 0 and counts["dense_stack"] > 0,
                f"two-stage serving launch counts {counts}")
    fail_unless(samples.shape == (BM_SITES, 3)
                and bool(torch.isfinite(samples).all())
                and bool((samples.abs() <= math.pi + 1e-5).all()),
                "two-stage samples not finite or outside [-pi, pi]")
    fail_unless(bool(torch.isfinite(lp).all()), "two-stage log_prob")
    rot_err = compare("two-stage log_prob under rotation", lp_rot, lp, 1e-4,
                      1e-4, 1e-3)
    data_ = tuple(a[:BM_BATCH * TS_FIT_STEPS] for a in
                  backmapping_frames(BM_FRAMES, 25, dev))
    fit_gen = torch.Generator(device=dev).manual_seed(26)
    _, warm = fit(bm, lambda m, b, g: -m.log_prob(*b).mean(), data_,
                  generator=fit_gen, num_epochs=1, batch_size=BM_BATCH)
    torch.cuda.synchronize()
    _build.reset_launches()
    _, hist = fit(bm, lambda m, b, g: -m.log_prob(*b).mean(), data_,
                  generator=fit_gen, num_epochs=1, batch_size=BM_BATCH)
    train_counts = path_counts("two_stage_backmapping_train")
    ms_step = 1e3 * hist["epoch_time_s"][0] / TS_FIT_STEPS
    fail_unless(math.isfinite(hist["loss"][0])
                and hist["loss"][0] < warm["loss"][0],
                f"two-stage loss {warm['loss']} -> {hist['loss']}")
    window_ms, busy_ms, idle = busy_share(lambda: fit(
        bm, lambda m, b, g: -m.log_prob(*b).mean(),
        tuple(a[:PROFILED_STEPS * BM_BATCH] for a in data_),
        generator=fit_gen, num_epochs=1, batch_size=BM_BATCH),
        PROFILED_STEPS)
    batch = tuple(a[:512] for a in data_)
    with torch.no_grad():
        ctx = bm.embed(*batch[:3])
    keep = rows_off_knots(bm.decoder.dist.flow, batch[3], ctx, 0.95)
    batch = tuple(a[keep] for a in batch)
    check_grads("two-stage backmapping", bm, lambda m, d: -m.log_prob(
        *(a.to(d) for a in batch)).mean(), dev)
    row = {"path": "two_stage_backmapping", "sites": BM_SITES,
           "predict_ms": 1e3 * (t1 - t0), "log_prob_ms": 1e3 * (t2 - t1),
           "rotation_max_abs_err": rot_err, "ms_per_step": ms_step,
           "profiled_ms_per_step": window_ms,
           "device_busy_ms_per_step": busy_ms, "device_idle_share": idle,
           "launches": counts, "train_launches": train_counts}
    RESULTS["two_stage_backmapping"] = row
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} of {window_ms:.3f} ms/step ({idle:.3f} idle)")
    print(f"two-stage backmapping: predict {BM_SITES} sites in "
          f"{row['predict_ms']:.3f} ms, log_prob {row['log_prob_ms']:.3f} "
          f"ms, rotation err {rot_err:.3e}, fit {ms_step:.3f} ms/step "
          f"(device busy {busy})", flush=True)
    return row


def mcmc_checkpoint_path(vae, dev):
    """The flagship's fused step (kernel 4) at CK_CHAINS chains for
    CK_STEPS steps through ``run_mcmc_checkpointed``, a checkpoint every
    CK_EVERY steps; then the same run stopped after CK_STEPS / 2 steps,
    its state dropped, restored from the manager into a fresh template
    and run to the end.  Configurations, energies, counters and the
    generator's state must equal the uninterrupted run's bit for bit,
    and the step ids continue (CK_EVERY, 2 CK_EVERY, ..., CK_STEPS).
    The same once with the generic step (kernels 1 and 2)."""
    rows = {}
    for kind, step in (("fused", make_fused_vae_step(vae, log_target)),
                       ("generic", make_mcmc_step(*vae_proposal_fns(vae),
                                                  log_target))):
        def fresh(seed=2):
            x0 = torch.randn(CK_CHAINS, 2, device=dev,
                             generator=torch.Generator(
                                 device=dev).manual_seed(1))
            return MCMCState.create(x0, log_target(x0), torch.Generator(
                device=dev).manual_seed(seed))

        workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            _build.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            whole = run_mcmc_checkpointed(
                step, fresh(), CK_STEPS, CK_EVERY,
                CheckpointManager(os.path.join(workdir, "a")))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = path_counts(f"mcmc_checkpoint_{kind}")
            manager = CheckpointManager(os.path.join(workdir, "b"),
                                        max_to_keep=CK_STEPS // CK_EVERY)
            run_mcmc_checkpointed(step, fresh(), CK_STEPS // 2, CK_EVERY,
                                  manager)
            resumed = manager.restore(MCMCState.create(
                torch.zeros(CK_CHAINS, 2, device=dev),
                torch.zeros(CK_CHAINS, device=dev),
                torch.Generator(device=dev).manual_seed(99)))
            resumed = run_mcmc_checkpointed(step, resumed,
                                            CK_STEPS - CK_STEPS // 2,
                                            CK_EVERY, manager)
            steps = manager.all_steps()
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        key = "vae_proposal" if kind == "fused" else "rqs"
        fail_unless(counts[key] > 0, f"{kind} checkpointed launches {counts}")
        same = (torch.equal(resumed.configs, whole.configs)
                and torch.equal(resumed.energies, whole.energies)
                and int(resumed.num_trials) == int(whole.num_trials)
                and int(resumed.num_acc) == int(whole.num_acc)
                and torch.equal(resumed.generator.get_state(),
                                whole.generator.get_state()))
        fail_unless(same, f"{kind}: the resumed run differs from the "
                    "uninterrupted one")
        want = list(range(CK_EVERY, CK_STEPS + 1, CK_EVERY))
        fail_unless(steps == want, f"{kind}: checkpoint steps {steps}")
        fail_unless(int(whole.num_trials) == CK_CHAINS * CK_STEPS,
                    f"{kind}: {int(whole.num_trials)} trials")
        acc = float(whole.acceptance_rate)
        fail_unless(0.0 < acc < 1.0, f"{kind}: acceptance {acc}")
        rows[kind] = sampling_row(
            f"mcmc_checkpoint_{kind}", seconds,
            CK_CHAINS * CK_STEPS / seconds, "proposals/s", counts,
            ms_per_step=1e3 * seconds / CK_STEPS, checkpoint_steps=steps,
            acceptance=acc, resumed_bit_for_bit=same)
    return rows


def bf16_flow_path(dev):
    """Under ``set_compute_dtype(torch.bfloat16)``, the 8-D MAF (FLOW_D,
    hidden 200, 32 bins, 2 blocks): kernel 3's bf16 mode against its
    plain bf16 version in both directions at TRAIN_BATCH rows (rows away
    from the knots, and a fraction 1e-2 of them allowed a bfloat16
    rounding step of a hidden unit: the kernel's and cuBLAS's float32
    sums of the same exact products differ in order, and where a tanh
    output lies within that of a bfloat16 rounding boundary the two
    round it a step apart), against the float32 mode's time at the same
    shape; BF_STEPS maximum-likelihood steps at batch TRAIN_BATCH through
    ``fit`` (falling loss, gradients against a CPU copy in the same mode,
    to 1e-3 + 1e-2|g|: see below) and ``predict`` of TRAIN_BATCH
    samples."""
    flow = ExperimentConfig(model=FlowModelConfig(FlowedDistConfig(
        MAFConfig(data_dim=FLOW_D, num_blocks=2, rqs=RQSParams()),
        base=None, static_base_dim=FLOW_D))).build(dev)
    data_ = gaussian_data(dev)
    epochs = -(-BF_STEPS // (data_.shape[0] // TRAIN_BATCH))
    layer = flow.flowed_dist.flow.blocks[0]
    probe = torch.zeros(TRAIN_BATCH, FLOW_D, device=dev)
    set_compute_dtype(torch.bfloat16)
    try:
        y = data_[:TRAIN_BATCH]
        with torch.no_grad():
            keep = knot_safe([layer], y).to(dev)
            fwd_keep = knot_safe([layer], y, inverse=False).to(dev)
            keep &= fwd_keep
            bf = check_maf_case(f"bf16 D={FLOW_D} N={TRAIN_BATCH}", layer, y,
                                torch.bfloat16, keep, 1e-2)
        gen = torch.Generator(device=dev).manual_seed(31)
        _, warm = fit(flow, lambda m, b, g: -m.log_prob(b).mean(),
                      data_[:TRAIN_BATCH], generator=gen, num_epochs=1,
                      batch_size=TRAIN_BATCH)
        torch.cuda.synchronize()
        _build.reset_launches()
        _, hist = fit(flow, lambda m, b, g: -m.log_prob(b).mean(), data_,
                      generator=gen, num_epochs=epochs,
                      batch_size=TRAIN_BATCH)
        counts = path_counts("bf16_flow_train")
        fail_unless(counts.get("maf_block_bf16", 0) > 0,
                    f"bf16 training launch counts {counts}")
        steps = epochs * (data_.shape[0] // TRAIN_BATCH)
        ms_step = 1e3 * sum(hist["epoch_time_s"]) / steps
        fail_unless(all(math.isfinite(v) for v in hist["loss"])
                    and hist["loss"][-1] < warm["loss"][0],
                    f"bf16 flow loss {warm['loss']} -> {hist['loss']}")
        window_ms, busy_ms, idle = busy_share(lambda: fit(
            flow, lambda m, b, g: -m.log_prob(b).mean(),
            data_[:5 * TRAIN_BATCH], generator=gen, num_epochs=1,
            batch_size=TRAIN_BATCH), 5)
        with torch.no_grad():
            _build.reset_launches()
            samples = flow.predict(probe, gen)
            predict_counts = path_counts("bf16_flow_sample")
            predict_ms = timed(lambda: flow.predict(probe, gen), reps=10)
        fail_unless(predict_counts.get("maf_block_bf16", 0) > 0,
                    f"bf16 sampling launch counts {predict_counts}")
        fail_unless(bool(torch.isfinite(samples).all()),
                    "bf16 flow samples not finite")
        x = data_[:TRAIN_BATCH]
        x = x[rows_off_knots(flow.flowed_dist.flow, x)]
        # The backward rounds every gradient that flows into a bfloat16
        # operand to bfloat16 (2^-8 relative, as JAX's transpose of a
        # bfloat16 product does); where the float32 values being rounded
        # differ in their last bits between the card and the CPU, they
        # round a bfloat16 step apart.  So 1e-3 + 1e-2|g|, not the float32
        # paths' 1e-4 + 1e-3|g| (1.25e-3 of one parameter's entries
        # exceeded that by up to 1.2e-4 on an H100).
        check_grads("bf16 flow", flow,
                    lambda m, d: -m.log_prob(x.to(d)).mean(), dev, 1e-3,
                    1e-2)
    finally:
        set_compute_dtype(None)
    with torch.no_grad():
        f32 = check_maf_case(f"D={FLOW_D} N={TRAIN_BATCH} float32 mode, the "
                             "same weights", layer, y)
    row = {"path": "bf16_flow", "steps": steps, "ms_per_step": ms_step,
           "losses": warm["loss"] + hist["loss"],
           "profiled_ms_per_step": window_ms,
           "device_busy_ms_per_step": busy_ms, "device_idle_share": idle,
           "predict_ms": predict_ms, "launches": counts,
           "predict_launches": predict_counts,
           "kernel_ms": {"bf16": {k: v[1] for k, v in bf.items()},
                         "f32": {k: v[1] for k, v in f32.items()}}}
    RESULTS["bf16_flow"] = row
    busy = ("not measured" if busy_ms is None else
            f"{busy_ms:.3f} of {window_ms:.3f} ms/step ({idle:.3f} idle)")
    print(f"bf16 flow: {ms_step:.3f} ms/step (device busy {busy}), predict "
          f"{predict_ms:.3f} ms; kernel 3 inverse bf16 "
          f"{bf['inverse'][1]:.4f} ms against f32 {f32['inverse'][1]:.4f}, "
          f"forward {bf['forward'][1]:.4f} against {f32['forward'][1]:.4f}",
          flush=True)
    return row


def rqs_outliers(dev):
    """The case of test_rqs_kernel_edges (K = 8, a row per element,
    inverse, N = 50 000, seeded as that test) whose log-dets differ from
    the plain version's by more than 1e-4: each one's input, the bin the
    kernel took (from its output's place among the x-knots) and the
    plain version's (from the input among the y-knots), the distance to
    the nearest y-knot, the discriminant the root takes, and the plain
    version's result in float64."""
    K = 8
    gen = torch.Generator(device=dev).manual_seed(K)
    for n in (1, 3, 4097, 50_000):  # the test's draws, in its order
        raw = [torch.randn(n, k, generator=gen, device=dev)
               for k in (K, K, K - 1)]
        w, h, s = (_bin_positions(raw[0], -5.0, 5.0, K),
                   _bin_positions(raw[1], -5.0, 5.0, K), _slopes(raw[2]))
        y = torch.rand(n + 1, generator=gen, device=dev) * 14.0 - 7.0
        kx, ky = rqs._knots(w[:1], h[:1], -5.0)
        on = torch.cat([kx[0], ky[0], torch.tensor(
            [float("nan"), float("inf"), -float("inf")], device=dev)])
        y[1:1 + min(n, on.numel())] = on[:n]
    found = []
    for shift, yin in (("x[:n]", y[:n]), ("x[1:]", y[1:])):
        got = rqs.rqs_cuda(yin, w, h, s, -5.0, True)
        want = rqs.rqs_inverse_plain(yin, w, h, s, -5.0)
        bad = ((got[1] - want[1]).abs() > 1e-4) & torch.isfinite(want[1])
        x_knots, y_knots = rqs._knots(w, h, -5.0)
        for i in torch.nonzero(bad).flatten().tolist():
            yi = float(yin[i])
            plain_bin = int((y_knots[i, 1:-1] <= yi).sum())
            kernel_bin = int((x_knots[i, 1:-1] <= float(got[0][i])).sum())
            dist = float((y_knots[i] - yi).abs().min())
            k = plain_bin
            sl = float(h[i, k] / w[i, k])
            d = torch.cat([torch.ones(1, device=dev), s[i],
                           torch.ones(1, device=dev)])
            dk, dk1 = float(d[k]), float(d[k + 1])
            t = yi - float(y_knots[i, k])
            dsum = dk1 + dk - 2 * sl
            a = float(h[i, k]) * (sl - dk) + t * dsum
            b = float(h[i, k]) * dk - t * dsum
            c = -sl * t
            # The same element in float64: which of the two float32
            # results is nearer.
            ref = rqs.rqs_inverse_plain(yin[i:i + 1].double(),
                                        w[i:i + 1].double(),
                                        h[i:i + 1].double(),
                                        s[i:i + 1].double(), -5.0)
            case = {"input": shift, "i": i, "y": yi,
                    "ldj_kernel": float(got[1][i]),
                    "ldj_plain": float(want[1][i]),
                    "ldj_float64": float(ref[1][0]),
                    "x_float64": float(ref[0][0]),
                    "x_kernel": float(got[0][i]), "x_plain": float(want[0][i]),
                    "bin_kernel": kernel_bin, "bin_plain": plain_bin,
                    "nearest_knot": dist, "disc": b * b - 4 * a * c,
                    "b2": b * b}
            found.append(case)
            print(f"rqs outlier {case}", flush=True)
    RESULTS["rqs_outliers"] = found
    print(f"rqs outliers (K=8 inverse, per element, log-det > 1e-4): "
          f"{len(found)}", flush=True)
    return found


def repairs_path(dev):
    """The shapes whose one-launch plan the kernels refuse, on the card: a
    dense stack of 9 layers (two launches), FCDeepNN(hidden_dim=[1024,
    1024]) at 10k rows (width 1024: a launch of the wide regime a layer,
    timed against the plain layers), a VectorAttention at N = 100 (B =
    2000, H = 40, Fo = 20: a launch of kernel 5's stream regime), an RQS
    broadcast row of 4470 bins (a launch of the walk, on 50 000 elements
    and on one) and a cell-pair block of 27 x 700 neighbour slots (a
    launch for each run of ``cell_lj.neighbour_runs``); each against its
    plain version, with no plain route taken.  Then kernel 1's log-det
    outliers."""
    gen = torch.Generator(device=dev).manual_seed(41)
    out = {}
    _build.reset_launches()
    dims = [4] + [32] * 9
    ks = [torch.randn(a, b, generator=gen, device=dev) / a ** 0.5
          for a, b in zip(dims, dims[1:])]
    bs = [0.1 * torch.randn(b, generator=gen, device=dev) for b in dims[1:]]
    acts = ["tanh"] * 8 + [None]
    x = torch.randn(TRAIN_BATCH, 4, generator=gen, device=dev)
    from vaemolsim_tpu_torch.ops.fused_mlp import fused_dense_stack
    err = compare("9-layer stack", fused_dense_stack(x, ks, bs, acts),
                  dense_stack_plain(x, ks, bs, acts), 1e-4, 1e-4)
    out["dense_stack 9 layers"] = (err, _build.launch_counts()["dense_stack"])
    fc = FCDeepNN.create(gen, 20, 8, hidden_dim=[1024, 1024], device=dev)
    xf = torch.randn(TRAIN_BATCH, 20, generator=gen, device=dev)
    before = _build.KERNELS["dense_stack"].launches
    with torch.no_grad():
        got = fc(xf)
        ws = [l.kernel.detach() for l in fc.layers] + [fc.head.kernel.detach()]
        bb = [l.bias.detach() for l in fc.layers] + [fc.head.bias.detach()]
        want = dense_stack_plain(xf, ws, bb, ["relu", "relu", None])
        err = compare("FCDeepNN 1024", got, want, 1e-4, 1e-4)
    out["FCDeepNN [1024, 1024]"] = (
        err, _build.KERNELS["dense_stack"].launches - before)
    # The wide regime's middle layer, 1024 -> 1024 at 10k rows, timed.
    h = torch.relu(xf @ ws[0] + bb[0])
    one = ([ws[1]], [bb[1]], ["relu"])
    ms = timed(lambda: dense_stack_cuda(h, *one))
    plain_ms = timed(lambda: dense_stack_plain(h, *one))
    lib_ms = timed(lambda: torch.relu(torch.addmm(bb[1], h, ws[1])))
    b_us, b_by = stack_bound(TRAIN_BATCH, one[0], one[1])
    record("dense_stack", f"wide 1024->1024 relu N={TRAIN_BATCH}",
           compare("wide 1024", dense_stack_cuda(h, *one),
                   dense_stack_plain(h, *one), 1e-4, 1e-4), ms, plain_ms,
           bound_us=b_us, bound_by=b_by, library_ms=lib_ms,
           regime=stack_regime(TRAIN_BATCH, [1024, 1024])[0])
    attn = VectorAttention.create(gen, 20, 20, hidden_dim=40, device=dev)
    c = torch.randn(2000, 100, 3, generator=gen, device=dev)
    v = torch.randn(2000, 100, 20, generator=gen, device=dev)
    m = torch.rand(2000, 100, generator=gen, device=dev) < 0.9
    before = pa.KERNEL.launches
    with torch.no_grad():
        err = compare("VectorAttention N=100", attn(c, v, m),
                      attn.plain_call(c, v, m), 1e-5, 1e-5)
    out["VectorAttention N=100"] = (err, pa.KERNEL.launches - before)
    # 4470 bins of at least 1e-2 each: a range of 100.
    K = 4470
    raw = [torch.randn(1, k, generator=gen, device=dev) for k in (K, K, K - 1)]
    params = (_bin_positions(raw[0], -50.0, 50.0, K),
              _bin_positions(raw[1], -50.0, 50.0, K), _slopes(raw[2]))
    xr = torch.rand(50_000, generator=gen, device=dev) * 120.0 - 60.0
    before = rqs.KERNEL.launches
    got = rqs.rqs_forward(xr, *params, -50.0)
    want = rqs.rqs_forward_plain(xr, *params, -50.0)
    err = max(compare("rqs K=4470 y", got[0], want[0], 1e-5, 1e-5, 1e-4),
              compare("rqs K=4470 ldj", got[1], want[1], 1e-4, 0.0, 1e-4))
    one = rqs.rqs_forward(xr[:1], *params, -50.0)
    err = max(err, compare("rqs K=4470 one element y", one[0],
                           rqs.rqs_forward_plain(xr[:1], *params, -50.0)[0],
                           1e-5, 1e-5))
    out["rqs broadcast K=4470"] = (err, rqs.KERNEL.launches - before)
    # Dilute (about 0.09 atoms per unit volume), so that few pairs sit in
    # the linear core, whose energies of ~1e6 would swamp the sums.
    nc, C = 4, 700
    Kn = 27 * C
    L = 60.0
    cxt = torch.rand(nc, 3, C, generator=gen, device=dev) * L
    nxt = torch.rand(nc, 3, Kn, generator=gen, device=dev) * L
    cid = torch.randint(0, 5000, (nc, 1, C), generator=gen, device=dev,
                        dtype=torch.int32)
    nid = torch.randint(0, 5000, (nc, 1, Kn), generator=gen, device=dev,
                        dtype=torch.int32)
    kw = dict(n_atoms=4900, sigma=1.0, epsilon=1.0, cutoff=2.5,
              box=(L, L, L))
    before = cell_lj.KERNEL.launches
    e, g = cell_lj.cell_pair_energy_force(cxt, nxt, cid, nid, **kw)
    e_p, g_p = cell_lj.cell_pair_energy_force_plain(cxt, nxt, cid, nid, **kw)
    err = max(compare("cell_lj K=18900 e", e, e_p, 1e-3, 1e-4),
              compare("cell_lj K=18900 grad", g, g_p, 1e-3, 1e-4))
    out["cell_lj 27 x 700 slots"] = (err, cell_lj.KERNEL.launches - before)
    print(f"repairs: {out}", flush=True)
    fail_unless(out["dense_stack 9 layers"][1] == 2
                and out["FCDeepNN [1024, 1024]"][1] == 3,
                f"dense-stack repair launches {out}")
    runs = len(cell_lj.neighbour_runs(Kn, cell_lj.max_slots(C)))
    fail_unless(out["VectorAttention N=100"][1] == 1
                and out["rqs broadcast K=4470"][1] == 2 and runs > 1
                and out["cell_lj 27 x 700 slots"][1] == runs,
                f"repair launches {out}")
    RESULTS["repairs"] = {k: list(v) if isinstance(v, tuple) else v
                          for k, v in out.items()}
    return out, rqs_outliers(dev)


# ---------------------------------------------------------------------------
# Slice 11: Ewald and the remaining force-field terms, constrained and
# thermostatted MD, observables, NPT / GCMC / Gibbs MC, and kernel 5's
# key-chunked stream regime
# ---------------------------------------------------------------------------

# Example 15 at --full (1728 ions) with its MD cut to MS_STEPS; example 39
# at --full width (512 dimers) with EX_EQUIL + EX_PROD steps; example 22 at
# --full (24 molecules, 8 replicas) with RW_STEPS a run; example 11 at
# --full widths with BG_* cuts; examples 14, 19 and 21 at --full widths
# with NPT_STEPS, GC_SWEEPS and GB_SWEEPS; example 13 at --full width with
# AL_STEPS.  PERF.md section 4 lists every cut beside the example's own.
MS_LAT, MS_STEPS, MS_TOL = 12, 1000, 1e-5
EX_MOL, EX_EQUIL, EX_PROD, EX_CHUNK = 512, 250, 500, 250
RW_MOL, RW_STEPS, RW_REPLICAS, RW_TF32_STEPS = 24, 4000, 8, 200
# BG_MLE_EPOCHS 3 and BG_TUNE_ROUNDS 6: depth cuts of 5 and 10 (PERF.md
# section 4).
BG_CHAINS, BG_HMC, BG_MLE_EPOCHS, BG_RKL_STEPS = 2048, 200, 3, 50
BG_PROPOSALS, BG_TUNE_ROUNDS = 60, 6
NPT_CHAINS, NPT_ATOMS, NPT_STEPS = 256, 32, 200
NPT_PRESSURES = (0.01, 0.02, 0.05, 0.1, 0.2)
GC_REP, GC_SWEEPS, GB_CHAINS, GB_SWEEPS = 256, 500, 96, 2240
AL_REPLICAS, AL_WINDOWS, AL_STEPS = 1024, 11, 1500
# Kernel 5's key-chunked stream regime at the shapes the plans refused
# before it: (B, N, H).
PA_CHUNKED = ((2, 1553, 40), (2, 4096, 40), (2, 400, 300), (2, 1024, 512))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def card_busy(fn, per, dev):
    """busy_share on the card; (None, None, None) on the CPU."""
    return busy_share(fn, per) if dev.type == "cuda" else (None, None, None)


def rock_salt(n_lat, rho, q_abs):
    """Example 15's start: an even rock-salt lattice at density rho,
    charge +-q by site parity (exactly neutral)."""
    n = n_lat ** 3
    L = float((n / rho) ** (1.0 / 3.0))
    g = np.stack(np.meshgrid(*[np.arange(n_lat)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    return L, g * (L / n_lat), np.where(g.sum(-1) % 2 == 0, q_abs, -q_abs)


def first_shell(x, L, sign, r_shell, mol=None):
    """(opposite-charge, like-charge) pair counts within r_shell (minimum
    image; intermolecular only where ``mol`` is given), over the leading
    frames of x (..., n, 3)."""
    xw = x - L * torch.floor(x / L)
    d = xw[..., :, None, :] - xw[..., None, :, :]
    d = d - L * torch.round(d / L)
    r = torch.sqrt((d * d).sum(-1).clamp_min(1e-12))
    n = x.shape[-2]
    s = torch.as_tensor(sign, device=x.device)
    keep = ~torch.eye(n, dtype=torch.bool, device=x.device)
    if mol is not None:
        m = torch.as_tensor(mol, device=x.device)
        keep = keep & (m[:, None] != m[None, :])
    same = (s[:, None] * s[None, :]) > 0
    close = (r < r_shell) & keep
    return int((close & ~same).sum()), int((close & same).sum())


def molten_salt_path(dev):
    """Example 15 at --full: 1728 ions (rho 0.35, q +-1.5, cutoff 2.5, skin
    0.4, capacity 32, Ewald tolerance 1e-5).  The split sum (kernel 6's
    LJ + erfc on the cell list, plus the reciprocal Ewald sum) equals the
    dense ewald_coulomb + lennard_jones at t = 0 within 1e-4|E| + 1e-3;
    the dense sum with TF32 allowed equals the TF32-off one to 1e-5
    relative (the phases are multiply-adds, no product is rounded); then
    MS_STEPS of baoab_neighbor (rebuild every 8, friction 2) and the
    first-shell check (opposite > 1.5 x like).  Records ms/step, the
    device's idle share, kernel-6 launches and the reciprocal sum's
    device time."""
    L, x0_np, q = rock_salt(MS_LAT, 0.35, 1.5)
    n = x0_np.shape[0]
    box = [L] * 3
    x0 = torch.tensor(x0_np, dtype=torch.float32, device=dev)
    recip = potentials.ewald_coulomb(q, box=box, r_cutoff=2.5,
                                     tolerance=MS_TOL,
                                     include_real_space=False, device=dev)
    build, cell_e = potentials.lennard_jones_cell_neighbor(
        box=box, cutoff=2.5, skin=0.4, capacity=32, charges=q,
        coulomb_alpha=recip.ewald_alpha, device=dev)
    dense_ewald = potentials.ewald_coulomb(q, box=box, r_cutoff=2.5,
                                           tolerance=MS_TOL, device=dev)
    dense_lj = potentials.lennard_jones(box=box, cutoff=2.5, device=dev)
    with torch.no_grad():
        e_split = float(cell_e(build(x0), x0) + recip(x0))
        e_ewald = dense_ewald(x0)
        e_dense = float(e_ewald + dense_lj(x0))
        prior = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            e_tf32 = dense_ewald(x0)
            r_tf32 = recip(x0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prior
        r_off = recip(x0)
    fail_unless(abs(e_split - e_dense) <= 1e-4 * abs(e_dense) + 1e-3,
                f"molten salt: split {e_split} against dense {e_dense}")
    tf32_rel = max(float((e_tf32 - e_ewald).abs() / e_ewald.abs()),
                   float((r_tf32 - r_off).abs() / r_off.abs()))
    fail_unless(tf32_rel <= 1e-5, f"ewald with TF32 allowed: rel {tf32_rel}")
    print(f"molten salt: {n} ions, box {L:.3f}, {recip.n_modes} modes; "
          f"split {e_split:.3f} == dense {e_dense:.3f}; TF32 on/off rel "
          f"{tf32_rel:.2e}", flush=True)
    recip_ms = grad_ms = None
    if dev.type == "cuda":
        recip_ms = timed(lambda: recip(x0), reps=10)
        xg = x0.clone().requires_grad_(True)
        grad_ms = timed(lambda: torch.autograd.grad(recip(xg), xg), reps=5)

    def energy_nl(nl, x):
        return cell_e(nl, x) + recip(x)

    gen = torch.Generator(device=dev).manual_seed(15)
    v0 = torch.randn(x0.shape, generator=gen, device=dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    st, _ = md.baoab_neighbor(build, energy_nl, x0, v0, gen, dt=0.002,
                              n_steps=MS_STEPS, rebuild_every=8,
                              friction=2.0, kT=1.0)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("molten_salt", expect=("cell_lj",))
    fail_unless(bool(torch.isfinite(st.x).all()), "molten salt: MD blew up")
    kt = float(md.temperature(st.v))

    def chunk():
        nl = build(st.x)
        md.baoab(lambda x: energy_nl(nl, x), st.x, st.v, gen, dt=0.002,
                 n_steps=8, friction=2.0, kT=1.0, f0=st.force)

    busy = card_busy(chunk, 8, dev)
    if dev.type == "cuda":
        with torch.no_grad():
            check_cell_lj_case("molten salt ex15 erfc", cell_e, build(st.x),
                               st.x, True)
    n_opp, n_same = first_shell(st.x, L, q, 1.6)
    fail_unless(n_opp > 1.5 * max(n_same, 1),
                f"molten salt: no charge ordering ({n_opp}, {n_same})")
    row = sampling_row(
        "molten_salt_ex15", wall, n * MS_STEPS / wall, "ion-steps/s",
        counts, busy, ms_per_step=1e3 * wall / MS_STEPS, steps=MS_STEPS,
        ions=n, e_split=e_split, e_dense=e_dense, tf32_rel=tf32_rel,
        recip_modes=recip.n_modes, recip_ms=recip_ms,
        recip_force_ms=grad_ms, kT=kt, first_shell=[n_opp, n_same])
    print(f"molten salt: {1e3 * wall / MS_STEPS:.3f} ms/step, kT {kt:.3f}, "
          f"first shell opposite {n_opp} like {n_same}; reciprocal sum "
          f"{recip_ms} ms (energy), {grad_ms} ms (energy and forces)",
          flush=True)
    return row


def dimer_salt(n_mol, rho, dev):
    """Example 39's system: n_mol +-1.5 dimers (k 200, r0 1) on a lattice
    at density rho, relaxed on the dense LJ + bonds (400 Adam steps)."""
    n = 2 * n_mol
    L = float((n / rho) ** (1.0 / 3.0))
    bonds = [[2 * k, 2 * k + 1] for k in range(n_mol)]
    charges = np.tile([1.5, -1.5], n_mol)
    excl = potentials.exclusions_from_bonds(n, bonds, through_angles=False)
    side = int(np.ceil(n_mol ** (1.0 / 3.0)))
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n_mol]
    x0 = np.repeat((g + 0.5) * (L / side), 2, axis=0)
    x0[0::2, 0] -= 0.5
    x0[1::2, 0] += 0.5
    bonded = potentials.harmonic_bonds(bonds, k=200.0, r0=1.0, device=dev)
    dense_lj = potentials.lennard_jones(box=[L] * 3, cutoff=2.5,
                                        exclude=excl, device=dev)
    x0 = potentials.minimize_energy(
        potentials.composite(dense_lj, bonded),
        torch.tensor(x0, dtype=torch.float32, device=dev), steps=400,
        lr=0.02)
    return dict(n=n, L=L, bonds=bonds, charges=charges, excl=excl,
                bonded=bonded, dense_lj=dense_lj, x0=x0)


def molecular_exact_path(dev):
    """Example 39 at --full width: 512 charged dimers, bonds + the cell
    list's LJ + erfc with bonded exclusions (kernel 6) + PME's reciprocal
    sum, held against the exact ewald_coulomb with exclusions + the dense
    LJ + bonds (relative error < 3e-4); then EX_EQUIL + EX_PROD steps of
    baoab_neighbor (rebuild every 5) and the example's asserts: the bond
    length's mean and width against the radial Boltzmann law, unlike
    first-shell pairs > 1.15 x like, kinetic kT within 0.05."""
    s = dimer_salt(EX_MOL, 0.6, dev)
    n, L, q, excl = s["n"], s["L"], s["charges"], s["excl"]
    box = [L] * 3
    recip = potentials.pme_coulomb(q, box=box, r_cutoff=2.5, tolerance=1e-4,
                                   exclude=excl, include_real_space=False,
                                   device=dev)
    build, cell_e = potentials.lennard_jones_cell_neighbor(
        box=box, cutoff=2.5, skin=0.4, capacity=32, charges=q,
        coulomb_alpha=recip.ewald_alpha, exclude=excl, device=dev)

    def energy(nl, x):
        return cell_e(nl, x) + recip(x) + s["bonded"](x)

    x0 = s["x0"]
    with torch.no_grad():
        exact = float(potentials.ewald_coulomb(
            q, box=box, r_cutoff=2.5, tolerance=1e-4, exclude=excl,
            device=dev)(x0) + s["dense_lj"](x0) + s["bonded"](x0))
        split = float(energy(build(x0), x0))
    rel = abs(split - exact) / max(abs(exact), 1.0)
    fail_unless(rel < 3e-4, f"example 39: split {split} exact {exact}")
    gen = torch.Generator(device=dev).manual_seed(39)
    v0 = torch.randn(x0.shape, generator=gen, device=dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    st, _ = md.baoab_neighbor(build, energy, x0, v0, gen, dt=0.002,
                              n_steps=EX_EQUIL, rebuild_every=5,
                              friction=2.0, kT=1.0)
    xs, vs = [], []
    for _ in range(EX_PROD // EX_CHUNK):
        st, _ = md.baoab_neighbor(build, energy, st.x, st.v, gen, dt=0.002,
                                  n_steps=EX_CHUNK, rebuild_every=5,
                                  friction=2.0, kT=1.0)
        xs.append(st.x)
        vs.append(st.v)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("molecular_exact", expect=("cell_lj",))
    xs, vs = torch.stack(xs), torch.stack(vs)
    fail_unless(bool(torch.isfinite(xs).all()), "example 39: drift guard")

    def chunk():
        nl = build(st.x)
        md.baoab(lambda x: energy(nl, x), st.x, st.v, gen, dt=0.002,
                 n_steps=5, friction=2.0, kT=1.0, f0=st.force)

    busy = card_busy(chunk, 5, dev)
    d = xs[:, 0::2] - xs[:, 1::2]
    d = d - L * torch.round(d / L)
    r = d.norm(dim=-1).double().cpu().numpy().ravel()
    rg = np.linspace(1.0 - 6 * np.sqrt(1 / 200.0), 1.0 + 6 * np.sqrt(
        1 / 200.0), 4001)
    w = rg ** 2 * np.exp(-0.5 * 200.0 * (rg - 1.0) ** 2)
    w /= np.trapezoid(w, rg)
    mean_exact = np.trapezoid(rg * w, rg)
    sd_exact = np.sqrt(np.trapezoid((rg - mean_exact) ** 2 * w, rg))
    fail_unless(abs(r.mean() - mean_exact) < 0.025
                and abs(r.std() - sd_exact) < 0.01,
                f"example 39: bond {r.mean()} +- {r.std()} against "
                f"{mean_exact} +- {sd_exact}")
    mol = np.repeat(np.arange(EX_MOL), 2)
    sign = np.tile([1, -1], EX_MOL)
    n_unlike = n_like = 0
    for f in xs:
        a, b = first_shell(f, L, sign, 1.3, mol)
        n_unlike, n_like = n_unlike + a, n_like + b
    fail_unless(n_unlike > 1.15 * n_like,
                f"example 39: unlike {n_unlike} like {n_like}")
    t_kin = float((vs.double() ** 2).sum() / (3 * n * len(vs)))
    fail_unless(abs(t_kin - 1.0) < 0.05, f"example 39: kinetic kT {t_kin}")
    steps = EX_EQUIL + EX_PROD
    row = sampling_row(
        "molecular_exact_ex39", wall, n * steps / wall, "atom-steps/s",
        counts, busy, ms_per_step=1e3 * wall / steps, steps=steps, atoms=n,
        split=split, exact=exact, rel_err=rel, bond=[r.mean(), r.std()],
        bond_exact=[mean_exact, sd_exact], shell=[n_unlike, n_like],
        kT=t_kin)
    print(f"example 39: split {split:.4f} exact {exact:.4f} (rel {rel:.2e});"
          f" {1e3 * wall / steps:.3f} ms/step; bond {r.mean():.4f} +- "
          f"{r.std():.4f} (exact {mean_exact:.4f} +- {sd_exact:.4f}); "
          f"unlike {n_unlike} like {n_like}; kT {t_kin:.3f}", flush=True)
    return row


def water_system(M, dev):
    """Example 22's rigid three-site model: charges, species LJ, the
    constraint bonds and lengths, intramolecular exclusions, box."""
    d_oh, ang = 0.40, 1.9106
    box = (M / 0.10) ** (1.0 / 3.0)
    d_hh = float(2 * d_oh * np.sin(ang / 2))
    n = 3 * M
    intra = np.zeros((n, n), bool)
    for m in range(M):
        intra[3 * m:3 * m + 3, 3 * m:3 * m + 3] = True
    return dict(
        M=M, n=n, box=box, d_oh=d_oh, ang=ang, intra=intra,
        charges=np.tile([-8.0, 4.0, 4.0], M).astype(np.float32),
        masses=np.tile([16.0, 1.0, 1.0], M).astype(np.float32),
        sigma=np.tile([1.0, 0.7, 0.7], M).astype(np.float32),
        eps=np.tile([1.0, 0.0, 0.0], M).astype(np.float32),
        bonds=np.concatenate([np.array([[0, 1], [0, 2], [1, 2]]) + 3 * m
                              for m in range(M)]),
        lengths=np.tile([d_oh, d_oh, d_hh], M).astype(np.float32))


def water_start(w, gen, dev):
    """Molecules on a jittered lattice with random orientations (one QR
    rotation each)."""
    M, box, d_oh, ang = w["M"], w["box"], w["d_oh"], w["ang"]
    half = d_oh * np.sin(ang / 2)
    template = torch.tensor([[0.0, 0.0, 0.0], [half, 0.0, d_oh * np.cos(
        ang / 2)], [-half, 0.0, d_oh * np.cos(ang / 2)]], device=dev)
    g = int(np.ceil(M ** (1 / 3)))
    sites = (np.stack(np.meshgrid(*[np.arange(g)] * 3, indexing="ij"),
                      -1).reshape(-1, 3)[:M] + 0.5) * (box / g)
    rot, _ = torch.linalg.qr(torch.randn(M, 3, 3, generator=gen,
                                         device=dev))
    mols = (rot[:, None, :, :] * template[None, :, None, :]).sum(-1)
    x = mols + torch.tensor(sites, dtype=torch.float32, device=dev)[:, None]
    x = x + 0.05 * torch.randn(x.shape, generator=gen, device=dev)
    return x.reshape(w["n"], 3)


def o_h_contacts(frames, w):
    """Median nearest intermolecular O-H distance and the mean number of
    H within 1.0 of an O."""
    n, box = w["n"], w["box"]
    o = list(range(0, n, 3))
    h = [i for i in range(n) if i % 3]
    d = frames[..., o, None, :] - frames[..., None, h, :]
    d = d - box * torch.round(d / box)
    r = torch.sqrt((d * d).sum(-1))
    mask = torch.as_tensor(~w["intra"][np.ix_(o, h)], device=frames.device)
    r = torch.where(mask, r, 1e9)
    return (float(r.amin(-1).median()),
            float((r < 1.0).sum(-1).double().mean()))


def rigid_water_path(dev):
    """Example 22 at --full: 24 rigid three-site molecules (72 sites),
    dense LJ + ewald_coulomb with intramolecular exclusions,
    bond_constraints, RW_STEPS of baoab_constrained, and the example's
    asserts: the largest bond deviation < 2e-3, H pulled toward O against
    the apolar control, and the constrained NVE drift over 1000 steps <
    5e-3.  The polar run and its apolar control (charges off) are one
    batch of 2 x 8 replicas, the Ewald energy scaled by 1 or 0 per
    replica, so both take the same steps at once.  A run of RW_TF32_STEPS
    with TF32 allowed prints its bond deviation beside the TF32-off
    run's."""
    w = water_system(RW_MOL, dev)
    box = [w["box"]] * 3
    R = RW_REPLICAS
    con = md.bond_constraints(w["bonds"], w["lengths"], w["n"], w["masses"],
                              device=dev)
    m_col = torch.tensor(w["masses"], device=dev)[:, None]
    lj = potentials.lennard_jones(sigma=w["sigma"], epsilon=w["eps"],
                                  box=box, cutoff=2.5, exclude=w["intra"],
                                  device=dev)
    ewald = potentials.ewald_coulomb(
        w["charges"], box=box, r_cutoff=min(2.5, w["box"] / 2 - 1e-3),
        exclude=w["intra"], tolerance=1e-4, device=dev)
    polar = torch.tensor([1.0] * R + [0.0] * R, device=dev)

    def pot(x):
        return lj(x) + polar[:x.shape[0]] * ewald(x)

    def run(steps, seed):
        x0 = water_start(w, torch.Generator(device=dev).manual_seed(3),
                         dev)[None].repeat(2 * R, 1, 1)
        return md.baoab_constrained(
            pot, x0, torch.zeros_like(x0),
            torch.Generator(device=dev).manual_seed(seed), dt=1.5e-3,
            n_steps=steps, friction=2.0, kT=1.0, constraints=con,
            masses=m_col, collect_every=100)

    def deviation(x):
        d = x[..., w["bonds"][:, 0], :] - x[..., w["bonds"][:, 1], :]
        return float((d.norm(dim=-1) - con.d0).abs().max())

    _build.reset_launches()
    t0 = time.perf_counter()
    st, traj = run(RW_STEPS, 0)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("rigid_water")
    dev_bond = deviation(st.x)
    busy = card_busy(lambda: md.baoab_constrained(
        pot, st.x, st.v, torch.Generator(device=dev).manual_seed(9),
        dt=1.5e-3, n_steps=2, friction=2.0, kT=1.0, constraints=con,
        masses=m_col), 2, dev)
    half = traj[traj.shape[0] // 2:]
    near_oh, coord_oh = o_h_contacts(half[:, :R].reshape(-1, w["n"], 3), w)
    near0, coord0 = o_h_contacts(half[:, R:].reshape(-1, w["n"], 3), w)
    x_p, v_p = st.x[:R], st.v[:R]
    stn, _ = md.velocity_verlet_constrained(pot, x_p, v_p, dt=5e-4,
                                            n_steps=1000, constraints=con,
                                            masses=m_col)
    with torch.no_grad():
        e0 = float((pot(x_p) + md.kinetic_energy(v_p, w["masses"])).mean())
        e1 = float((pot(stn.x) + md.kinetic_energy(stn.v,
                                                   w["masses"])).mean())
    drift = abs(e1 - e0) / max(1.0, abs(e0))
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        st_tf, _ = run(RW_TF32_STEPS, 5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    st_off, _ = run(RW_TF32_STEPS, 5)
    dev_tf32, dev_off = deviation(st_tf.x), deviation(st_off.x)
    print(f"example 22: {1e3 * wall / RW_STEPS:.3f} ms/step ({2 * R} "
          f"replicas); bond deviation {dev_bond:.2e}; O-H polar "
          f"{near_oh:.3f} / {coord_oh:.2f}, apolar {near0:.3f} / "
          f"{coord0:.2f}; NVE drift {drift:.2e}; after {RW_TF32_STEPS} steps "
          f"bond deviation TF32 on {dev_tf32:.2e} off {dev_off:.2e}",
          flush=True)
    fail_unless(dev_bond < 2e-3, f"example 22: bond deviation {dev_bond}")
    fail_unless(near_oh < near0 - 0.1 and coord_oh > 1.5 * max(coord0, 0.1),
                f"example 22: polar O-H {near_oh} {coord_oh}, apolar "
                f"{near0} {coord0}")
    fail_unless(drift < 5e-3, f"example 22: NVE drift {drift}")
    fail_unless(dev_tf32 < 2e-3, f"example 22 with TF32: {dev_tf32}")
    return sampling_row(
        "rigid_water_ex22", wall, RW_STEPS / wall, "steps/s", counts, busy,
        ms_per_step=1e3 * wall / RW_STEPS, steps=RW_STEPS,
        sites=w["n"], replicas=2 * R, bond_deviation=dev_bond,
        o_h=[near_oh, coord_oh], o_h_apolar=[near0, coord0],
        nve_drift=drift, tf32_bond_deviation=[dev_tf32, dev_off])


BG_A = 5


def bg_force_field(dev):
    """Example 11's chain of 5 atoms: bonds, angles, a bimodal n = 2
    torsion and LJ with bonded exclusions."""
    bonds = [[i, i + 1] for i in range(BG_A - 1)]
    return potentials.composite(
        potentials.harmonic_bonds(bonds, k=200.0, r0=1.0, device=dev),
        potentials.harmonic_angles([[i, i + 1, i + 2]
                                    for i in range(BG_A - 2)],
                                   k=20.0, theta0=1.9, device=dev),
        potentials.periodic_torsions([[i, i + 1, i + 2, i + 3]
                                      for i in range(BG_A - 3)],
                                     k=1.5, n=2, phase=0.0, device=dev),
        potentials.lennard_jones(
            sigma=0.8, epsilon=0.3, device=dev,
            exclude=potentials.exclusions_from_bonds(BG_A, bonds)))


def bg_log_jac(bonds, angles):
    return (torch.log(bonds[..., 1]) + (2.0 * torch.log(bonds[..., 2:])).sum(
        -1) + torch.log(torch.sin(angles[..., 1:])).sum(-1))


def bg_split(bat):
    return bat[..., :4], bat[..., 4:7], bat[..., 7:]


def bg_q(flow, dev):
    """Uniform(-1, 1)^9 base -> the MAF -> the per-DOF affine map to the
    physical intervals (example 11's make_q)."""
    lo = torch.full((9,), -1.0, device=dev)
    base = dist.Independent(dist.Uniform(lo, -lo), 1)
    domains = [(0.5, 1.5)] * 4 + [(0.8, 3.0)] * 3 + [(-np.pi, np.pi)] * 2
    to_phys = bj.Block(bj.make_domain_transform(domains, from_target=True,
                                                device=dev), 1)
    return dist.TransformedDistribution(flow(base), to_phys)


def boltzmann_generator_path(dev):
    """Example 11 at --full widths: the bonded force field, minimize_energy,
    tuned HMC on 2048 chains (BG_HMC steps, every 10th kept), the 3-block
    MAF (D = 9, K = 12, H = 64; kernel 3, and kernel 2 where a block takes
    the unfused route) trained by MLE (BG_MLE_EPOCHS at batch 1024) then
    reverse KL (BG_RKL_STEPS at batch 1024), the example's four asserts,
    and the flow's gradients against a CPU copy on rows off the knots."""
    zmat = coords.chain_zmatrix(BG_A)
    ff = bg_force_field(dev)
    lp_cart = potentials.as_log_prob(ff)
    gen = torch.Generator(device=dev).manual_seed(11)
    x0 = torch.randn(BG_CHAINS, BG_A, 3, generator=gen, device=dev)
    x0[:, :, 0] += torch.arange(BG_A, device=dev)
    x0 = potentials.minimize_energy(ff, x0, steps=1000, lr=0.05)
    with torch.no_grad():
        st = MCMCState.create(x0, lp_cart(x0), gen)
        eps, st = tune_scale(lp_cart, st, kind="hmc", init_scale=0.02,
                             n_leapfrog=8, rounds=BG_TUNE_ROUNDS)
        st, traj = run_mcmc(make_hmc_step(lp_cart, step_size=eps,
                                          n_leapfrog=8), st, BG_HMC,
                            collect_every=10)
    tors_md = coords.bat_from_cartesian(st.configs, zmat)[2]
    obs_md = float(torch.cos(2.0 * tors_md).mean())
    b_md, a_md, t_md = coords.bat_from_cartesian(traj.reshape(-1, BG_A, 3),
                                                 zmat)
    lo = torch.tensor([0.5] * 4 + [0.8] * 3 + [-np.pi] * 2, device=dev)
    hi = torch.tensor([1.5] * 4 + [3.0] * 3 + [np.pi] * 2, device=dev)
    bat_data = torch.minimum(torch.maximum(
        torch.cat([b_md, a_md, t_md], -1), lo + 1e-3), hi - 1e-3)
    flow = RQSSplineMAF.create(
        gen, 9, num_blocks=3, rqs_params={"num_bins": 12, "hidden_dim": 64,
                                          "bin_range": [-1.0, 1.0]},
        device=dev)

    def nll(f, batch, d):
        return -bg_q(f, d).log_prob(batch).mean()

    def mle_loss(f, batch, g):
        return nll(f, batch, dev)

    def rkl_loss(f, batch, g):
        bat, lq = bg_q(f, dev).sample_and_log_prob(g, (1024,))
        bonds, angles, tors = bg_split(bat)
        x = coords.cartesian_from_bat(bonds, angles, tors, zmat)
        return (lq - (-ff(x) + bg_log_jac(bonds, angles))).mean()

    fit_gen = torch.Generator(device=dev).manual_seed(13)
    _build.reset_launches()
    t0 = time.perf_counter()
    flow, hist = fit(flow, mle_loss, bat_data, generator=fit_gen,
                     num_epochs=BG_MLE_EPOCHS, batch_size=1024)
    flow, hist_r = fit(flow, rkl_loss,
                       torch.zeros(BG_RKL_STEPS, 1, device=dev),
                       generator=fit_gen, num_epochs=1, batch_size=1,
                       shuffle=False, learning_rate=2e-4)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("boltzmann_generator_train", expect=("maf_block",))
    _build.reset_launches()
    steps = BG_MLE_EPOCHS * (bat_data.shape[0] // 1024) + BG_RKL_STEPS
    with torch.no_grad():
        q = bg_q(flow, dev)
        bat, lq = q.sample_and_log_prob(fit_gen, (8192,))
        bonds, angles, tors = bg_split(bat)
        x = coords.cartesian_from_bat(bonds, angles, tors, zmat)
        logw = (-ff(x) + bg_log_jac(bonds, angles)) - lq
        wts = torch.softmax(logw, 0)
        ess = float(1.0 / (wts ** 2).sum())
        obs_q = float((wts * torch.cos(2.0 * tors).mean(-1)).sum())

        def lp_bat(b):
            bo, an, to = bg_split(b)
            return (-ff(coords.cartesian_from_bat(bo, an, to, zmat))
                    + bg_log_jac(bo, an))

        cur, lq_cur = q.sample_and_log_prob(fit_gen, (1024,))
        e_cur = lp_bat(cur)
        acc = torch.zeros((), device=dev)
        for _ in range(BG_PROPOSALS):
            prop, lq_prop = q.sample_and_log_prob(fit_gen, (1024,))
            e_prop = lp_bat(prop)
            take = ((e_prop - e_cur) + (lq_cur - lq_prop)) >= \
                torch.log(torch.rand(1024, generator=fit_gen, device=dev)
                          .clamp_min(1e-38))
            cur = torch.where(take[:, None], prop, cur)
            lq_cur = torch.where(take, lq_prop, lq_cur)
            e_cur = torch.where(take, e_prop, e_cur)
            acc = acc + take.float().mean()
        acc = float(acc) / BG_PROPOSALS
        tors_f = bg_split(cur)[2]
        obs_f = float(torch.cos(2.0 * tors_f).mean())
        frac_pos = float((tors_f > 0).float().mean())
    sample_counts = path_counts("boltzmann_generator_sample",
                                expect=("maf_block",))
    print(f"example 11: HMC acc {float(st.acceptance_rate):.2f} <cos 2phi> "
          f"{obs_md:+.4f}; MLE NLL {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f}; reverse KL {hist_r['loss'][0]:.3f} -> "
          f"{hist_r['loss'][-1]:.3f}; {1e3 * wall / steps:.3f} ms/train step;"
          f" reweighted {obs_q:+.4f} (ESS {ess:.0f}); flow-MC acc {acc:.2f} "
          f"{obs_f:+.4f} balance {frac_pos:.2f}; launches {counts}",
          flush=True)
    fail_unless(acc > 0.2, f"example 11: flow acceptance {acc}")
    fail_unless(0.2 < frac_pos < 0.8, f"example 11: well balance {frac_pos}")
    fail_unless(abs(obs_q - obs_md) < 0.08 and abs(obs_f - obs_md) < 0.08,
                f"example 11: <cos 2 phi> {obs_q} {obs_f} against {obs_md}")
    rows = bat_data[:2048]
    if dev.type == "cuda":
        with torch.no_grad():
            y = bg_q(flow, dev).bijector.inverse_and_log_det(
                bat_data[:1024])[0]
            for i, layer in enumerate(flow.blocks):
                check_maf_case(f"ex11 block {i} D=9 K=12 H=64 N=1024", layer,
                               y.contiguous(), allowed=1e-3)
        with torch.no_grad():
            y = bg_q(flow, dev).bijector.inverse_and_log_det(rows)[0]
        rows = rows[rows_off_knots(flow, y, min_share=0.9)]
        check_grads("boltzmann_generator", flow,
                    lambda f, d: nll(f, rows.to(d), d), dev)
    row = {"path": "boltzmann_generator_ex11", "seconds": wall,
           "ms_per_step": 1e3 * wall / steps, "steps": steps,
           "nll": [hist["loss"][0], hist["loss"][-1]],
           "reverse_kl": [hist_r["loss"][0], hist_r["loss"][-1]],
           "obs_hmc": obs_md, "obs_reweighted": obs_q, "obs_flow_mc": obs_f,
           "ess": ess, "acceptance": acc, "well_balance": frac_pos,
           "hmc_acceptance": float(st.acceptance_rate), "launches": counts,
           "sample_launches": sample_counts}
    RESULTS["train"].append(row)
    return row


def npt_gcmc_gibbs_path(dev):
    """Examples 14, 19 and 21 at --full widths, sweeps cut: NPT LJ gas
    (256 chains x 32 atoms, kT 2, five pressures, NPT_STEPS each): the
    mean virial pressure (observables.virial_pressure, per chain's box by
    torch.func.vmap) within 25% of the set pressure and volume acceptance
    in (0.2, 0.98); GCMC isotherm (5 mu x 256 replicas, capacity 128,
    GC_SWEEPS): the capacity never binds, rho(mu) increases, the dilute
    point near the ideal gas, the Widom cross-check at the middle point;
    Gibbs ensemble (96 chains, N = 96, kT 0.95, GB_SWEEPS): the boxes
    phase-separate and the two phases' Widom chemical potentials agree."""
    from vaemolsim_tpu_torch import observables
    from vaemolsim_tpu_torch.mcmc import (gcmc_init, gibbs_init, lj_pair_u,
                                          make_gcmc_step, make_gibbs_step,
                                          make_npt_step, npt_init, run_gcmc,
                                          run_gibbs, run_npt)
    from vaemolsim_tpu_torch.mcmc.gcmc import _one_particle_energy
    out = {}
    gen = torch.Generator(device=dev).manual_seed(14)
    kt = 2.0
    _build.reset_launches()

    def factory(b):
        return potentials.lennard_jones(box=b, cutoff=2.5, device=dev)

    def p_virial(x, b):
        return observables.virial_pressure(factory, x, box=b, kt=kt)

    t0 = time.perf_counter()
    npt_rows = []
    for p_set in NPT_PRESSURES:
        L0 = (NPT_ATOMS * kt / p_set) ** (1.0 / 3.0)
        x0 = torch.rand(NPT_CHAINS, NPT_ATOMS, 3, generator=gen,
                        device=dev) * L0
        state = npt_init(factory, x0, [L0] * 3, gen)
        step = make_npt_step(factory, pressure=p_set, beta=1.0 / kt,
                             dx_scale=0.25, dlnv_scale=0.08)
        state, (xs, boxes) = run_npt(step, state, NPT_STEPS,
                                     collect_every=20)
        burn = xs.shape[0] // 4
        xs, boxes = xs[burn:], boxes[burn:]
        rho = float((NPT_ATOMS / boxes.prod(-1)).mean())
        pv = torch.func.vmap(torch.func.vmap(p_virial))(xs, boxes)
        p_vir = float(pv.mean())
        acc = float(state.vol_acceptance_rate)
        npt_rows.append([p_set, rho, p_vir, acc])
        fail_unless(abs(p_vir - p_set) < 0.25 * p_set + 1e-3,
                    f"example 14: virial {p_vir} against {p_set}")
        fail_unless(0.2 < acc < 0.98, f"example 14: volume acceptance {acc}")
    sync(dev)
    out["npt_seconds"] = time.perf_counter() - t0
    out["npt"] = npt_rows
    print("example 14 (P_set, rho, P_virial, volume acceptance): "
          + "; ".join(f"{p:.3f} {r:.4f} {v:.4f} {a:.3f}"
                      for p, r, v, a in npt_rows), flush=True)

    t0 = time.perf_counter()
    box_l, n_max, kt = 6.0, 128, 2.0
    vol = box_l ** 3
    mus = kt * np.log(np.array([0.002, 0.01, 0.04, 0.1, 0.2]))
    n_mu = len(mus)
    mu_grid = torch.tensor(mus, dtype=torch.float32,
                           device=dev).repeat_interleave(GC_REP)
    x0 = box_l * torch.rand(n_mu * GC_REP, n_max, 3, generator=gen,
                            device=dev)
    n0 = (torch.exp(mu_grid / kt) * vol).long().clamp(1, n_max // 2)
    active0 = torch.arange(n_max, device=dev)[None, :] < n0[:, None]
    pair = lj_pair_u(cutoff=2.5)
    state = gcmc_init(x0, active0, gen)
    step = make_gcmc_step(pair, box=box_l, mu=mu_grid, beta=1.0 / kt,
                          dx_scale=0.35, n_disp=2)
    state, ns = run_gcmc(step, state, GC_SWEEPS, collect_every=10)
    burn = ns.shape[0] // 3
    rho = ns[burn:].double().reshape(-1, n_mu, GC_REP).mean((0, 2)).cpu() \
        .numpy() / vol
    n_high = int(state.n.max())
    fail_unless(n_high < n_max, f"example 19: capacity binds ({n_high})")
    fail_unless(bool(np.all(np.diff(rho) > 0)), f"example 19: rho {rho}")
    z0 = np.exp(mus[0] / kt)
    fail_unless(abs(rho[0] / z0 - 1.0) < 0.15,
                f"example 19: dilute rho {rho[0]} against z {z0}")
    i_mid = n_mu // 2
    n_final = state.n.reshape(n_mu, GC_REP)[i_mid].cpu().numpy()
    n_star = int(np.bincount(n_final).argmax())
    sel = np.nonzero(n_final == n_star)[0]
    x_mid = state.x.reshape(n_mu, GC_REP, n_max, 3)[i_mid]
    a_mid = state.active.reshape(n_mu, GC_REP, n_max)[i_mid]
    xs = torch.stack([x_mid[c][a_mid[c]][:n_star] for c in sel])
    mu_ex, stderr = observables.widom_insertion(
        potentials.lennard_jones(box=[box_l] * 3, cutoff=2.5, device=dev),
        xs, box=[box_l] * 3, generator=gen, n_insertions=4000, kT=kt)
    mu_pred = kt * np.log(rho[i_mid]) + float(mu_ex)
    fail_unless(abs(mu_pred - mus[i_mid]) < max(4.0 * float(stderr), 0.3),
                f"example 19: Widom mu {mu_pred} against {mus[i_mid]}")
    sync(dev)
    out["gcmc_seconds"] = time.perf_counter() - t0
    out["gcmc"] = dict(rho=rho.tolist(), high_water=n_high,
                       mu_widom=mu_pred, mu_set=float(mus[i_mid]),
                       exchange_acceptance=float(
                           state.exchange_acceptance_rate))
    print(f"example 19: rho {np.round(rho, 5).tolist()}, high water "
          f"{n_high}/{n_max}, Widom mu {mu_pred:.3f} against "
          f"{mus[i_mid]:.3f} ({out['gcmc_seconds']:.1f} s)", flush=True)

    t0 = time.perf_counter()
    kt, n_max, n_tot, L0 = 0.95, 88, 96, 6.2
    pair = lj_pair_u(cutoff=2.5)
    x_a = L0 * torch.rand(GB_CHAINS, n_max, 3, generator=gen, device=dev)
    x_b = L0 * torch.rand(GB_CHAINS, n_max, 3, generator=gen, device=dev)
    act = (torch.arange(n_max, device=dev)[None, :] < n_tot // 2).expand(
        GB_CHAINS, n_max)
    st = gibbs_init(x_a, act, x_b, act, L0, L0, gen)
    step = make_gibbs_step(pair, beta=1.0 / kt, dx_scale=0.25,
                           dlnv_scale=0.03, n_disp=6, min_box=5.0)
    st, (ra, rb) = run_gibbs(step, st, GB_SWEEPS, collect_every=20)
    tail = ra.shape[0] // 3
    r_a, r_b = ra[-tail:].mean(0), rb[-tail:].mean(0)
    rl = float(torch.maximum(r_a, r_b).median())
    rv = float(torch.minimum(r_a, r_b).median())
    fail_unless(rl / max(rv, 1e-6) > 5.0 and rl > 0.45 and rv < 0.2,
                f"example 21: rho_liq {rl} rho_vap {rv}")
    a_liq = r_a >= r_b

    def pick(a, b):
        shape = (-1,) + (1,) * (a.dim() - 1)
        return torch.where(a_liq.reshape(shape), a, b)

    def mu_phase(x, act_, box, seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        n_ins = 4000 // GB_CHAINS
        pos = torch.rand(n_ins, GB_CHAINS, 3, generator=g,
                         device=dev) * box[None, :, None]
        none = torch.full((n_ins, GB_CHAINS), n_max, dtype=torch.long,
                          device=dev)
        du = _one_particle_energy(pair, x[None], act_[None], pos,
                                  box[None, :, None, None], none)
        wts = torch.exp(-du / kt).double().reshape(-1)
        mu_ex = -kt * float(torch.log(wts.mean()))
        err = kt * float(wts.std() / (wts.mean() * math.sqrt(wts.numel())))
        rho_p = float((act_.sum(1) / box ** 3).mean())
        return kt * math.log(rho_p) + mu_ex, err

    mu_l, e_l = mu_phase(pick(st.x_a, st.x_b), pick(st.act_a, st.act_b),
                         pick(st.box_a, st.box_b), 11)
    mu_v, e_v = mu_phase(pick(st.x_b, st.x_a), pick(st.act_b, st.act_a),
                         pick(st.box_b, st.box_a), 12)
    tol = max(4.0 * math.hypot(e_l, e_v), 0.4)
    fail_unless(abs(mu_l - mu_v) < tol,
                f"example 21: mu_liq {mu_l} mu_vap {mu_v} (tol {tol})")
    sync(dev)
    out["gibbs_seconds"] = time.perf_counter() - t0
    out["gibbs"] = dict(rho_liq=rl, rho_vap=rv, mu_liq=mu_l, mu_vap=mu_v,
                        xfer_acceptance=float(st.xfer_acceptance_rate))
    print(f"example 21: rho_liq {rl:.3f} rho_vap {rv:.4f}, mu_liq {mu_l:+.3f}"
          f" mu_vap {mu_v:+.3f} (tol {tol:.2f}) ({out['gibbs_seconds']:.1f}"
          f" s)", flush=True)
    out["launches"] = path_counts("npt_gcmc_gibbs")
    RESULTS["npt_gcmc_gibbs"] = out
    return out


def alchemical_path(dev):
    """Example 13 at --full width: LJ7 at kT 0.2, atom 0 decoupled by the
    soft core over 11 windows of 1024 replicas (AL_STEPS BAOAB steps,
    every window in one batch), MBAR against TI with dU/dlambda by
    autograd, within the example's --full tolerance max(6 se, 0.35), and
    dF > 1."""
    from vaemolsim_tpu_torch.mcmc import mbar_free_energy
    n, kt = 7, 0.2
    alch = np.asarray([True] + [False] * (n - 1))
    u_sc = potentials.lennard_jones_softcore(sigma=1.0, epsilon=1.0,
                                             alchemical=alch, device=dev)
    u_rest = potentials.composite(
        potentials.com_restraint(2.0),
        potentials.harmonic_bonds([[0, 1]], k=2.0, r0=1.2, device=dev))

    def u_total(x, lam):
        return u_sc(x, lam) + u_rest(x)

    lams = np.linspace(1.0, 0.0, AL_WINDOWS)
    gen = torch.Generator(device=dev).manual_seed(13)
    full = potentials.composite(potentials.lennard_jones(device=dev),
                                potentials.com_restraint(2.0))
    x0 = potentials.minimize_energy(
        full, 0.7 * torch.randn(AL_REPLICAS, n, 3, generator=gen,
                                device=dev), steps=1500, lr=0.1)
    # Every window's replicas in one batch (AL_WINDOWS, AL_REPLICAS, n, 3),
    # lambda per window: the windows are independent, so this samples
    # what the example's window-by-window loop does, in one run.
    lam_w = torch.tensor(lams, dtype=torch.float32, device=dev)[:, None]
    xw = x0[None].repeat(AL_WINDOWS, 1, 1, 1)
    _build.reset_launches()
    t0 = time.perf_counter()
    st, _ = md.baoab(lambda x: u_total(x, lam_w), xw, torch.zeros_like(xw),
                     gen, dt=0.004, n_steps=AL_STEPS, friction=1.0, kT=kt)
    lg = lam_w.clone().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(u_sc(st.x, lg).sum(), lg)
    dudl = (g[:, 0] / AL_REPLICAS).tolist()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("alchemical")
    pooled = st.x.reshape(-1, n, 3)
    with torch.no_grad():
        L = torch.stack([-u_total(pooled, torch.tensor(
            lam, dtype=torch.float32, device=dev)) / kt for lam in lams])
    res = mbar_free_energy(L, [AL_REPLICAS] * AL_WINDOWS)
    df_mbar = float(res.free_energies[-1])
    se = float(res.stderrs[-1])
    df_ti = float(np.trapezoid(dudl, lams)) / kt
    tol = max(6 * se, 0.35)
    print(f"example 13: dF MBAR {df_mbar:+.3f} +- {se:.3f}, TI {df_ti:+.3f} "
          f"(tol {tol:.2f}); {1e3 * wall / AL_STEPS:.3f} ms a step of "
          f"{AL_WINDOWS} x {AL_REPLICAS} replicas", flush=True)
    fail_unless(abs(df_mbar - df_ti) < tol and df_mbar > 1.0,
                f"example 13: MBAR {df_mbar} +- {se}, TI {df_ti}")
    return sampling_row(
        "alchemical_ex13", wall, AL_WINDOWS * AL_REPLICAS * AL_STEPS / wall,
        "replica-steps/s", counts, None, ms_per_step=1e3 * wall / AL_STEPS,
        steps=AL_STEPS, df_mbar=df_mbar, se_mbar=se, df_ti=df_ti)


def timed_once(fn):
    """Device milliseconds of one fn() after one warm-up call, by CUDA
    events: for calls of 0.1 s and more, where ``timed``'s repeats and
    device spin buy nothing."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def chunked_stream_path(dev):
    """Kernel 5's key-chunked stream regime on the card, at the shapes the
    plans refused before it: N = 1553 and 4096 (B = 2, H = 40, Fo = 20),
    H = 300 at N = 400 and H = 512 at N = 1024 (B = 2; 12 and 16 units a
    lane), both modes, against the plain version
    (1e-5 + 1e-5|v|) with device ms of each by ``timed_once`` and the
    bound;
    at N = 8192 (B = 1), where the plain pair grid would be 10.7 GB a
    trunk, the valid rows equal the kernel's own N = 4096 output with the
    extra 4096 particles masked out.  A VectorAttention of each shape
    launches the kernel once (its launches are this path's)."""
    gen = torch.Generator(device=dev).manual_seed(12)
    launches = 0
    for B, N, H in PA_CHUNKED:
        for reduce in (False, True):
            attn = VectorAttention.create(gen, 20, 20, hidden_dim=H,
                                          reduce=reduce, device=dev)
            c = 1.5 * torch.randn(B, N, 3, generator=gen, device=dev)
            v = torch.randn(B, N, 20, generator=gen, device=dev)
            m = (torch.rand(B, N, generator=gen, device=dev) > 0.3).float()
            m[-1, :7] = 0.0
            (c_, *nodes, mf_, weights), kw = attn.pair_args(c, v, m)
            args = (c_, *[t.detach() for t in nodes], mf_,
                    *[t.detach() for t in weights])
            plan = pa.kernel_plan(B, N, H, 20)
            fail_unless(plan["regime"] == "stream" and not plan["refused"],
                        f"kernel 5 plan at {(B, N, H)}: {plan}")
            _build.reset_launches()
            with torch.no_grad():
                got = attn(c, v, m)
            launches += pa.KERNEL.launches
            fail_unless(pa.KERNEL.launches == 1,
                        f"VectorAttention {(B, N, H)}: launches "
                        f"{pa.KERNEL.launches}")
            with torch.no_grad():
                want = pa.pair_attention_plain(*args, **kw)
                err = compare(f"pair_attention stream {(B, N, H, reduce)}",
                              got, want, 1e-5, 1e-5)
                ms = timed_once(lambda: pa.pair_attention_cuda(*args, **kw))
                plain_ms = timed_once(lambda: pa.pair_attention_plain(
                    *args, **kw))
            del want
            nbytes, flops, head_flops = pair_attention_work(B, N, H, 20, m,
                                                            reduce)
            bound_us, by = _bound(nbytes, flops)
            shape = (f"chunked stream N={N} H={H} B={B} "
                     f"{'reduce' if reduce else 'rows'}")
            RESULTS.setdefault("pair_attention_bound_by", {})[shape] = by
            record("pair_attention", shape, err, ms, plain_ms,
                   bound_us=bound_us, bound_by=by,
                   per_pair_head_bound_us=_bound(nbytes, head_flops)[0],
                   units=plan["units"], lanes=plan["lanes"])
            torch.cuda.empty_cache()
    attn = VectorAttention.create(gen, 20, 20, hidden_dim=40, device=dev)
    c = 1.5 * torch.randn(1, 8192, 3, generator=gen, device=dev)
    v = torch.randn(1, 8192, 20, generator=gen, device=dev)
    m = torch.zeros(1, 8192, device=dev)
    m[:, :4096] = 1.0
    with torch.no_grad():
        _build.reset_launches()
        big = attn(c, v, m)
        launches += pa.KERNEL.launches
        small = attn(c[:, :4096], v[:, :4096], m[:, :4096])
        err = compare("pair_attention N=8192 masked", big[:, :4096], small,
                      1e-5, 1e-5)
        fail_unless(float(big[:, 4096:].abs().max()) == 0.0,
                    "pair_attention N=8192: masked rows not zero")
        (c_, *nodes, mf_, weights), kw = attn.pair_args(c, v, m)
        args = (c_, *nodes, mf_, *weights)
        ms = timed_once(lambda: pa.pair_attention_cuda(*args, **kw))
    nbytes, flops, head_flops = pair_attention_work(1, 8192, 40, 20, m, False)
    bound_us, by = _bound(nbytes, flops)
    shape = "chunked stream N=8192 H=40 B=1 rows (masked half)"
    RESULTS.setdefault("pair_attention_bound_by", {})[shape] = by
    record("pair_attention", shape, err, None, None, kernel_ms=ms,
           bound_us=bound_us, bound_by=by,
           per_pair_head_bound_us=_bound(nbytes, head_flops)[0])
    counts = {name: 0 for name in _build.KERNELS}
    counts["pair_attention"] = launches
    RESULTS.setdefault("path_launches", {})["chunked_stream"] = counts
    return counts


# ---------------------------------------------------------------------------
# Slice 12: triclinic cells and PME, the L-BFGS polish, REMD, HREX,
# temperature extrapolation, path-integral, Brownian, GLE and DPD dynamics,
# flow matching
# ---------------------------------------------------------------------------

# Examples 41, 42, 24, 26, 38 and 34 at their --full widths, with fewer
# sweeps, rounds, epochs or steps where a CPU rehearsal of the port at that
# count held every assert (PERF.md section 4 lists each cut beside the
# example's own count); the dynamics phase at the sizes its docstring gives.
TN_CHAINS, TN_ATOMS, TN_EQUIL, TN_BLOCKS, TN_BLOCK = 256, 48, 1500, 10, 100
CC_CHAINS, CC_EQUIL, CC_BLOCKS, CC_BLOCK = 128, 1000, 4, 150
RF_WALK, RF_ROUNDS, RF_EPOCHS, RF_PROPOSALS = 128, 300, 150, 6
EXT_WALK, EXT_ROUNDS = 64, 600
# Example 26's thresholds (the midpoint disagreement below 0.04 at --full,
# 0.08 by default; the reweighting error below 0.02) are what one seed of
# the JAX package's example meets.  At --full depth that example misses
# its own 0.04 (0.0990 on the CPU: the top rungs evaporate, and an order-3
# expansion does not bridge the jump).  Over five seeds of the port on the
# CPU the disagreement ran 0.011-0.089 and the reweighting error
# 0.002-0.021 at 999 rounds, and 0.012-0.064 and 0.006-0.021 at 600, so
# the phase holds the port to the reference's --full level with room for
# that spread.
EXT_MIDPOINT_TOL, EXT_REWEIGHT_TOL = 0.15, 0.04
HX_CHAINS, HX_EQUIL, HX_PROD = 16, 1500, 2400
PI_REPLICAS, PI_STEPS = 512, 3000
DYN_BD_N, DYN_RPY_N, DYN_DPD_L, DYN_STEPS, DYN_RPY_STEPS = (
    4096, 1000, 10, 400, 600)


def triclinic_npt_path(dev):
    """Example 41 at --full width: 256 chains x 48 LJ atoms (kT 2, P 0.5,
    cutoff 2), anisotropic NPT MC from a sheared cell (TN_EQUIL sweeps,
    then TN_BLOCKS blocks of TN_BLOCK); the strain-derivative pressure
    tensor: isotropic part within 0.1 max(1, P) + 0.05 of P and
    off-diagonal means below 0.06; the final cells legal; and the
    fractional-space cell list against the dense energy on a 1000-atom
    sheared cell to 1e-3."""
    from vaemolsim_tpu_torch import triclinic as tc
    kt, p_set, L = 2.0, 0.5, 5.8
    cell0 = np.array([[L, 0.0, 0.0], [0.35 * L, L, 0.0],
                      [-0.3 * L, 0.25 * L, L]])
    tc.validate_cell(cell0)
    energy = tc.lennard_jones_triclinic(cutoff=2.0, shift=True)
    gen = torch.Generator(device=dev).manual_seed(41)
    x0 = tc.lattice_in_cell(TN_ATOMS, cell0, device=dev).expand(
        TN_CHAINS, TN_ATOMS, 3).contiguous()
    _build.reset_launches()
    t0 = time.perf_counter()
    st = tc.npt_triclinic_init(energy, x0, cell0, gen)
    step = tc.make_npt_triclinic_step(energy, beta=1.0 / kt,
                                      pressure=p_set, dx_scale=0.02,
                                      dh_scale=0.08, min_perp=4.0)
    st, _ = tc.run_npt_triclinic(step, st, TN_EQUIL)
    blocks = []
    for _ in range(TN_BLOCKS):
        st, _ = tc.run_npt_triclinic(step, st, TN_BLOCK)
        blocks.append(tc.pressure_tensor(energy, st.x, st.cell, kT=kt))
    p = torch.cat(blocks).double()
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("triclinic_npt")
    sweeps = TN_EQUIL + TN_BLOCKS * TN_BLOCK
    p_iso = float(p.diagonal(dim1=-2, dim2=-1).sum(-1).mean() / 3.0)
    off = [float(p[..., i, j].mean()) for i, j in ((0, 1), (0, 2), (1, 2))]
    print(f"example 41: <P_virial> {p_iso:.4f} (set {p_set}), off-diagonal "
          f"{np.round(off, 4).tolist()}, disp acc "
          f"{float(st.disp_acceptance_rate):.3f}, cell acc "
          f"{float(st.cell_acceptance_rate):.3f}, <V> "
          f"{float(st.volume.mean()):.1f}", flush=True)
    fail_unless(abs(p_iso - p_set) < 0.1 * max(1.0, p_set) + 0.05,
                f"example 41: pressure {p_iso} against {p_set}")
    fail_unless(max(abs(o) for o in off) < 0.06,
                f"example 41: off-diagonal stress {off}")
    for h in st.cell[:16].cpu().double().numpy():
        tc.validate_cell(h)
    big = 3.0 * cell0
    rng = np.random.default_rng(0)
    xs = (tc.lattice_in_cell(1000, big, device=dev) + torch.as_tensor(
        0.15 * rng.normal(size=(1000, 3)), dtype=torch.float32, device=dev))
    build, e_cell = tc.lennard_jones_cell_triclinic(
        big, cutoff=2.0, skin=0.4, capacity=32, device=dev)
    with torch.no_grad():
        got = float(e_cell(build(xs), xs))
        want = float(energy(xs, torch.as_tensor(big, dtype=torch.float32,
                                                device=dev)))
    print(f"example 41: cell list {got:.4f} against dense {want:.4f}",
          flush=True)
    fail_unless(abs(got - want) < 1e-3 * max(1.0, abs(want)),
                f"example 41: cell list {got} against dense {want}")
    busy = card_busy(lambda: tc.run_npt_triclinic(step, st, 20), 20, dev)
    return sampling_row(
        "triclinic_npt_ex41", wall, TN_CHAINS * sweeps / wall,
        "chain-sweeps/s", counts, busy, ms_per_step=1e3 * wall / sweeps,
        sweeps=sweeps, p_iso=p_iso, off_diagonal=off, cell_list=got,
        dense=want)


def charged_crystal_path(dev):
    """Example 42 at --full width: a 64-ion rock-salt crystal (LJ core +
    triclinic Ewald, tolerance 1e-5, cutoff 1.9).  The perfect-lattice
    enthalpy scan (31 spacings in one batch) and the Madelung energy at
    its minimum within 1%; triclinic PME against ewald_coulomb_triclinic
    on the sheared start crystal (2e-4, the JAX package's own tolerance),
    energy and forces; then anisotropic NPT MC of 128 chains from the
    sheared cell (kT 0.08, P 0.2; CC_EQUIL sweeps, CC_BLOCKS blocks of
    CC_BLOCK) for the charged crystal and its q = 0 control: off-diagonal
    pressure below 0.35, the isotropic pressure within 0.35 of P, the
    charged volume below the control's by 0.5, the final cells legal."""
    from vaemolsim_tpu_torch import triclinic as tc
    madelung, n_side = 1.7475645946331822, 4
    n_ions = n_side ** 3
    kt, p_set, r_cut = 0.08, 0.2, 1.9
    g = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float64)
    q = np.asarray([(-1.0) ** int(s.sum()) for s in g])
    lj = tc.lennard_jones_triclinic(sigma=1.0, epsilon=0.15, cutoff=r_cut)
    _build.reset_launches()
    t0 = time.perf_counter()
    coul_ref = tc.ewald_coulomb_triclinic(
        q, reference_cell=np.diag([float(n_side)] * 3), r_cutoff=r_cut,
        tolerance=1e-6, device=dev)
    scales = np.linspace(1.0, 1.3, 31)
    s_t = torch.as_tensor(scales, dtype=torch.float32, device=dev)
    x0 = torch.as_tensor(g, dtype=torch.float32, device=dev)
    eye = torch.eye(3, device=dev)
    with torch.no_grad():
        xb = s_t[:, None, None] * x0
        hb = s_t[:, None, None] * eye * n_side
        hv = (lj(xb, hb) + coul_ref(xb, hb)
              + p_set * tc.cell_volume(hb)).cpu().numpy()
        d_eq = float(scales[hv.argmin()])
        u_coul = float(coul_ref(d_eq * x0, d_eq * eye * n_side)) / n_ions
    want = -madelung / (2.0 * d_eq)
    print(f"example 42: spacing {d_eq:.3f}, Coulomb energy per ion "
          f"{u_coul:.5f} against Madelung {want:.5f}", flush=True)
    fail_unless(abs(u_coul - want) < 0.01 * abs(want),
                f"example 42: Madelung {u_coul} against {want}")
    L = n_side * d_eq
    cell0 = np.array([[L, 0.0, 0.0], [0.45 * d_eq, L, 0.0],
                      [-0.40 * d_eq, 0.35 * d_eq, L]])
    tc.validate_cell(cell0)
    x_start = torch.as_tensor(g @ (cell0 / n_side), dtype=torch.float32,
                              device=dev)
    # Triclinic PME against the classic sum on the same sheared crystal,
    # displaced off the lattice so that the forces are not zero.
    xd = (x_start + 0.05 * torch.randn(x_start.shape, generator=torch
                                       .Generator(device=dev).manual_seed(3),
                                       device=dev)).requires_grad_(True)
    pme = potentials.pme_coulomb(q, cell=cell0, r_cutoff=r_cut,
                                 tolerance=1e-5, device=dev)
    ewald = tc.ewald_coulomb_triclinic(q, reference_cell=cell0,
                                       r_cutoff=r_cut, tolerance=1e-5,
                                       device=dev)
    h0 = torch.as_tensor(cell0, dtype=torch.float32, device=dev)
    e_pme, e_ew = pme(xd), ewald(xd, h0)
    (f_pme,) = torch.autograd.grad(e_pme, xd)
    (f_ew,) = torch.autograd.grad(e_ew, xd)
    pme_err = abs(float(e_pme) - float(e_ew)) / abs(float(e_ew))
    f_err = float((f_pme - f_ew).abs().max() / f_ew.abs().max())
    print(f"example 42: triclinic PME {float(e_pme):.6f} against Ewald "
          f"{float(e_ew):.6f} (rel {pme_err:.2e}; forces {f_err:.2e} of the "
          f"largest; grid {pme.grid_shape})", flush=True)
    fail_unless(pme_err < 2e-4 and f_err < 2e-3,
                f"example 42: PME {float(e_pme)} against {float(e_ew)}, "
                f"forces {f_err}")
    ref = np.diag([n_side * d_eq] * 3)
    coul = tc.ewald_coulomb_triclinic(q, reference_cell=ref,
                                      r_cutoff=r_cut, tolerance=1e-5,
                                      device=dev)

    def charged(x, cell):
        return lj(x, cell) + coul(x, cell)

    out = {}
    sweeps = CC_EQUIL + CC_BLOCKS * CC_BLOCK
    for name, energy, seed in (("charged", charged, 1), ("control", lj, 2)):
        gen = torch.Generator(device=dev).manual_seed(42 + seed)
        st = tc.npt_triclinic_init(
            energy, x_start.expand(CC_CHAINS, n_ions, 3).contiguous(),
            cell0, gen)
        step = tc.make_npt_triclinic_step(
            energy, beta=1.0 / kt, pressure=p_set, dx_scale=0.006,
            dh_scale=0.03, min_perp=2.0 * r_cut)
        st, _ = tc.run_npt_triclinic(step, st, CC_EQUIL)
        vols, ptens = [], []
        for _ in range(CC_BLOCKS):
            st, _ = tc.run_npt_triclinic(step, st, CC_BLOCK)
            vols.append(st.volume)
            ptens.append(tc.pressure_tensor(energy, st.x, st.cell, kT=kt))
        p = torch.cat(ptens).double()
        out[name] = dict(
            v=float(torch.stack(vols).double().mean()),
            p=float(p.diagonal(dim1=-2, dim2=-1).sum(-1).mean() / 3.0),
            off=[float(p[..., i, j].mean())
                 for i, j in ((0, 1), (0, 2), (1, 2))],
            disp_acc=float(st.disp_acceptance_rate),
            cell_acc=float(st.cell_acceptance_rate),
            cells=st.cell[:8].cpu().double().numpy())
        print(f"example 42 {name}: <V> {out[name]['v']:.2f}, <P> "
              f"{out[name]['p']:.4f} (set {p_set}), off-diagonal "
              f"{np.round(out[name]['off'], 4).tolist()}, disp acc "
              f"{out[name]['disp_acc']:.2f}, cell acc "
              f"{out[name]['cell_acc']:.2f}", flush=True)
        if name == "charged":
            charged_step, charged_state = step, st
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("charged_crystal")
    ch, ctl = out["charged"], out["control"]
    fail_unless(max(abs(o) for o in ch["off"]) < 0.35,
                f"example 42: off-diagonal {ch['off']}")
    fail_unless(abs(ch["p"] - p_set) < 0.35,
                f"example 42: pressure {ch['p']} against {p_set}")
    fail_unless(ch["v"] < ctl["v"] - 0.5,
                f"example 42: volume {ch['v']} against control {ctl['v']}")
    for h in ch["cells"]:
        tc.validate_cell(h)
    busy = card_busy(lambda: tc.run_npt_triclinic(
        charged_step, charged_state, 20), 20, dev)
    for row in out.values():
        del row["cells"]
    return sampling_row(
        "charged_crystal_ex42", wall, 2 * CC_CHAINS * sweeps / wall,
        "chain-sweeps/s", counts, busy,
        ms_per_step=1e3 * wall / (2 * sweeps), sweeps=sweeps,
        madelung=u_coul, madelung_want=want, pme_rel_err=pme_err,
        pme_force_err=f_err, **out)


def _tilted_well(q):
    """Example 24's U(x, y) = 8 (x^2 - 1)^2 + 0.5 x + 2 y^2 on (..., 2)."""
    x, y = q[..., 0], q[..., 1]
    return 8.0 * (x * x - 1.0) ** 2 + 0.5 * x + 2.0 * y * y


def check_velocity_field_kernel(fm, gen, dev):
    """Kernel 2 at example 24's velocity field (11 -> 128 -> 128 -> 2,
    gelu in its tanh form, the field's own weights) at the CFM batch
    (1024 rows) and at the divergence's two stacked copies of 1024 chains,
    against its plain version (1e-4 + 1e-4|y|); timed at 1024 rows
    against the plain version, which is the library chain (addmm, gelu,
    addmm, gelu, addmm), with its bound."""
    net = fm.velocity.net
    ks = [l.kernel.detach() for l in net.layers] + [net.head.kernel.detach()]
    bs = [l.bias.detach() for l in net.layers] + [net.head.bias.detach()]
    acts = [l.activation for l in net.layers] + [None]
    dims = [ks[0].shape[0]] + [k.shape[1] for k in ks]
    shape = "->".join(map(str, dims))
    for n in (1024, 2048):
        x = torch.randn(n, dims[0], generator=gen, device=dev)
        got = dense_stack_cuda(x, ks, bs, acts)
        want = dense_stack_plain(x, ks, bs, acts)
        err = compare(f"velocity field {shape} N={n}", got, want, 1e-4, 1e-4)
        extra = {"regime": stack_regime(n, dims)[0]}
        ms = plain_ms = None
        if n == 1024:
            ms = timed(lambda: dense_stack_cuda(x, ks, bs, acts))
            plain_ms = timed(lambda: dense_stack_plain(x, ks, bs, acts))
            extra["library_ms"] = plain_ms
            _, extra["device_us"] = device_us(
                lambda: dense_stack_cuda(x, ks, bs, acts), "dense_")
            extra["plain_device_us"], _ = device_us(
                lambda: dense_stack_plain(x, ks, bs, acts), "")
            extra["bound_us"], extra["bound_by"] = stack_bound(n, ks, bs)
        record("dense_stack", f"velocity field {shape} gelu N={n}", err, ms,
               plain_ms, **extra)


def remd_flow_matching_path(dev):
    """Example 24 at --full widths: REMD on the tilted double well (6
    rungs x 128 walkers, 20 BAOAB steps a round, RF_ROUNDS rounds), the
    cold rung's p(right) against quadrature within 0.12 and a plain-MD
    control (20 x RF_ROUNDS steps) stuck below 0.1; then a FlowMatching
    CNF (hidden (128, 128), gelu: kernel 2) by CFM through train.fit
    (RF_EPOCHS epochs at batch 1024, lr 2e-3) on the cold samples; 8192
    generated samples (64 RK4 steps) with p(right) within 0.1; and the CNF
    as a Metropolized independence proposal (1024 chains, RF_PROPOSALS
    proposals of 48 RK4 steps with the exact divergence): acceptance > 0.3
    and <x> within 0.15 of quadrature."""
    from vaemolsim_tpu_torch.flows import FlowMatching
    from vaemolsim_tpu_torch.parallel import (REMDState, make_remd_step,
                                              run_remd)

    def potential(conf):
        return _tilted_well(conf[..., 0, :])

    xs = np.linspace(-3.0, 3.0, 20001)
    w = np.exp(-(8.0 * (xs * xs - 1.0) ** 2 + 0.5 * xs))
    w /= w.sum()
    p_true, mean_true = float(w[xs > 0].sum()), float((w * xs).sum())
    gen = torch.Generator(device=dev).manual_seed(24)
    _build.reset_launches()
    t0 = time.perf_counter()
    betas = temperature_ladder(6, beta_min=0.15, device=dev)
    x0 = (-torch.ones(6, RF_WALK, 1, 2, device=dev)
          * torch.tensor([1.0, 0.0], device=dev))
    state = REMDState.create(potential, x0, betas, gen)
    step = make_remd_step(potential, dt=0.01, friction=2.0,
                          md_steps_per_exchange=20)
    state, traj = run_remd(step, state, RF_ROUNDS, collect_every=5)
    burn = traj.shape[0] // 4
    cold = traj[burn:, 0].reshape(-1, 2).contiguous()
    frac_remd = float((cold[:, 0] > 0).float().mean())
    swap = float(state.swap_acceptance_rate)
    sync(dev)
    remd_s = time.perf_counter() - t0
    # The control run replays md's shared runner: the same steps and draws
    # as md.baoab's eager loop.
    ctrl_md = md._BAOAB(potential, dt=0.01, kt=1.0, friction=2.0, masses=1.0)
    ctrl, _ = ctrl_md.scan(ctrl_md.start(x0[0], torch.zeros_like(x0[0])),
                           20 * RF_ROUNDS, gen)
    frac_ctrl = float((ctrl.x[:, 0, 0] > 0).float().mean())
    print(f"example 24: REMD swap acceptance {swap:.2f}, cold p_right "
          f"{frac_remd:.3f} ({cold.shape[0]} samples) against {p_true:.3f}; "
          f"plain MD {frac_ctrl:.3f}", flush=True)
    fail_unless(abs(frac_remd - p_true) < 0.12,
                f"example 24: REMD p_right {frac_remd} against {p_true}")
    fail_unless(frac_ctrl < 0.1, f"example 24: plain MD {frac_ctrl}")
    fm = FlowMatching.create(gen, 2, hidden_dim=(128, 128), device=dev)
    t1 = time.perf_counter()
    fm, hist = fit(fm, lambda m, b, g: m.loss(g, b), cold, generator=gen,
                   num_epochs=RF_EPOCHS, batch_size=1024,
                   learning_rate=2e-3, scan_epochs=True)
    sync(dev)
    fit_s = time.perf_counter() - t1
    n_fit = RF_EPOCHS * (cold.shape[0] // 1024)
    with torch.no_grad():
        s = fm.sample(gen, (8192,), n_steps=64)
        p_gen = float((s[:, 0] > 0).float().mean())
        print(f"example 24: CFM loss {hist['loss'][0]:.3f} -> "
              f"{hist['loss'][-1]:.3f} ({1e3 * fit_s / n_fit:.3f} ms a step); "
              f"generated p_right {p_gen:.3f}", flush=True)
        fail_unless(abs(p_gen - p_true) < 0.1,
                    f"example 24: generated p_right {p_gen}")
        t2 = time.perf_counter()
        n_chains = 1024
        cur, lq_cur = fm.sample_and_log_prob(gen, (n_chains,), n_steps=48)
        e_cur = -_tilted_well(cur)
        acc = torch.zeros((), device=dev)
        for _ in range(RF_PROPOSALS):
            prop, lq_prop = fm.sample_and_log_prob(gen, (n_chains,),
                                                   n_steps=48)
            e_prop = -_tilted_well(prop)
            log_a = (e_prop - e_cur) + (lq_cur - lq_prop)
            u = torch.log(torch.rand(n_chains, generator=gen, device=dev)
                          .clamp_min(1e-38))
            take = log_a >= u
            cur = torch.where(take[:, None], prop, cur)
            lq_cur = torch.where(take, lq_prop, lq_cur)
            e_cur = torch.where(take, e_prop, e_cur)
            acc = acc + take.float().mean()
        acc = float(acc) / RF_PROPOSALS
        mean_x = float(cur[:, 0].mean())
    sync(dev)
    mc_s = time.perf_counter() - t2
    wall = time.perf_counter() - t0
    counts = path_counts("remd_flow_matching", expect=("dense_stack",))
    print(f"example 24: flow MC acceptance {acc:.3f}, <x> {mean_x:+.4f} "
          f"against {mean_true:+.4f} ({1e3 * mc_s / RF_PROPOSALS:.1f} ms a "
          f"proposal of {n_chains} chains)", flush=True)
    fail_unless(acc > 0.3, f"example 24: proposal acceptance {acc}")
    fail_unless(abs(mean_x - mean_true) < 0.15,
                f"example 24: <x> {mean_x} against {mean_true}")
    busy = card_busy(lambda: fm.loss(gen, cold[:1024]).backward(), 1, dev)
    if dev.type == "cuda":
        with torch.no_grad():
            check_velocity_field_kernel(fm, gen, dev)
    return sampling_row(
        "remd_flow_matching_ex24", wall, 6 * RF_WALK * 20 * RF_ROUNDS / remd_s,
        "replica-MD-steps/s", counts, busy,
        ms_per_step=1e3 * remd_s / RF_ROUNDS, fit_ms_per_step=1e3 * fit_s
        / n_fit, proposal_ms=1e3 * mc_s / RF_PROPOSALS, remd_seconds=remd_s,
        fit_seconds=fit_s, swap_acceptance=swap, p_right_remd=frac_remd,
        p_right_control=frac_ctrl, p_right_generated=p_gen,
        p_right_true=p_true, acceptance=acc, mean_x=mean_x,
        cfm_loss=[hist["loss"][0], hist["loss"][-1]])


def extrapolation_path(dev):
    """Example 26 at --full widths: LJ7 (+ a COM restraint) minimised by
    400 clipped-Adam steps and a 30-step L-BFGS polish; REMD over 8 rungs
    (T 0.12-0.45) x 64 walkers, 10 BAOAB steps a round, EXT_ROUNDS rounds;
    <U> rising with T, the order-3 two-sided midpoint extrapolations
    within EXT_MIDPOINT_TOL of the energy range and between the rung
    means, reweighting from the middle rung within EXT_REWEIGHT_TOL at the
    next rung with its ESS peaked there, and the heat capacity's peak in
    (0.1, 0.4).  Also the polish's LJ7 golden (tests/test_potentials.py): 16
    starts, 200 Adam steps + 40 L-BFGS steps, the best energy within 1e-3
    of -16.505384."""
    from vaemolsim_tpu_torch.extrapolation import (beta_extrapolate,
                                                   beta_reweight)
    from vaemolsim_tpu_torch.parallel import (REMDState, make_remd_step,
                                              run_remd)
    R = 8
    temps = np.geomspace(0.12, 0.45, R)
    betas = 1.0 / temps
    lj7 = potentials.composite(potentials.lennard_jones(device=dev),
                               potentials.com_restraint(k=2.0))
    gen = torch.Generator(device=dev).manual_seed(26)
    _build.reset_launches()
    t0 = time.perf_counter()
    golden = potentials.minimize_energy(
        lj7, 0.7 * torch.randn(16, 7, 3, generator=gen, device=dev),
        steps=200, lr=0.02, polish_lbfgs=40)
    with torch.no_grad():
        best = float(lj7(golden).min())
    print(f"example 26: L-BFGS polish golden {best:.6f} against -16.505384",
          flush=True)
    fail_unless(abs(best + 16.505384) < 1e-3,
                f"L-BFGS polish golden {best}")
    x_min = potentials.minimize_energy(
        lj7, 0.8 * torch.randn(7, 3, generator=gen, device=dev), steps=400,
        lr=0.02, polish_lbfgs=30)
    x0 = x_min.expand(R, EXT_WALK, 7, 3).contiguous()
    state = REMDState.create(lj7, x0, betas, gen)
    step = make_remd_step(lj7, dt=0.004, friction=2.0,
                          md_steps_per_exchange=10)
    t1 = time.perf_counter()
    state, traj = run_remd(step, state, EXT_ROUNDS, collect_every=3)
    sync(dev)
    remd_s = time.perf_counter() - t1
    burn = EXT_ROUNDS // 3
    frames = traj[burn // 3:]
    with torch.no_grad():
        u = lj7(frames)
    u_flat = u.movedim(1, 0).reshape(R, -1)
    u_mean = u_flat.double().mean(1).cpu().numpy()
    swap = float(state.swap_acceptance_rate)
    print(f"example 26: swap acceptance {swap:.2f}; <U>(T) "
          f"{np.round(u_mean, 3).tolist()}", flush=True)
    fail_unless(bool((np.diff(u_mean) > 0).all()), f"example 26: {u_mean}")
    scale = u_mean.max() - u_mean.min()
    worst = 0.0
    for r in range(R - 1):
        b_mid = 0.5 * (betas[r] + betas[r + 1])
        lo = float(beta_extrapolate(u_flat[r], u_flat[r], float(betas[r]),
                                    b_mid, order=3))
        hi = float(beta_extrapolate(u_flat[r + 1], u_flat[r + 1],
                                    float(betas[r + 1]), b_mid, order=3))
        worst = max(worst, abs(lo - hi) / scale)
        mid = 0.5 * (lo + hi)
        fail_unless(min(u_mean[r], u_mean[r + 1]) - 0.05 * scale <= mid
                    <= max(u_mean[r], u_mean[r + 1]) + 0.05 * scale,
                    f"example 26: midpoint {mid} between rungs {r}, {r + 1}")
    mid = R // 2
    est, ess = beta_reweight(u_flat[mid], u_flat[mid], float(betas[mid]),
                             betas)
    ess = ess.cpu().double().numpy()
    near = abs(float(est[mid + 1]) - u_mean[mid + 1]) / scale
    cv = u_flat.double().var(1).cpu().numpy() / temps ** 2
    peak_t = float(temps[int(cv.argmax())])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("extrapolation")
    print(f"example 26: midpoint disagreement {100 * worst:.2f}% of the range"
          f", reweighting error {near:.4f}, ESS {np.round(ess).tolist()}, "
          f"Cv peak at T {peak_t:.3f}", flush=True)
    fail_unless(worst < EXT_MIDPOINT_TOL,
                f"example 26: extrapolation {worst}")
    fail_unless(near < EXT_REWEIGHT_TOL, f"example 26: reweighting {near}")
    fail_unless(ess[mid] > ess[0] and ess[mid] > ess[-1],
                f"example 26: ESS {ess}")
    fail_unless(bool((cv > 0).all()) and 0.1 < peak_t < 0.4,
                f"example 26: Cv {cv}")
    busy = card_busy(lambda: run_remd(step, state, 5), 5, dev)
    return sampling_row(
        "extrapolation_ex26", wall, R * EXT_WALK * 10 * EXT_ROUNDS / remd_s,
        "replica-MD-steps/s", counts, busy,
        ms_per_step=1e3 * remd_s / EXT_ROUNDS, remd_seconds=remd_s,
        polish_golden=best, swap_acceptance=swap, u_mean=u_mean.tolist(),
        extrapolation_error=worst, reweight_error=near, cv_peak_t=peak_t)


def hrex_path(dev):
    """Example 38 at --full widths: one soft-core solute in 15 LJ atoms (L
    4, kT 2), HREX over an 8-point Gauss-Legendre lambda ladder x 16
    chains (random walk 0.05, a swap every 4 steps; HX_EQUIL + HX_PROD
    steps, every 10th kept): swap acceptance in (0.10, 0.98); TI against
    MBAR (perturbed to lambda 0 and 1) within 4 combined errors + 0.05;
    and an independent Widom run (the 15-atom fluid, 128 chains,
    HX_EQUIL + HX_PROD steps, 128 insertions a frame) within 5 (TI +
    Widom) errors + 0.10 (the --full tolerances); both negative."""
    from vaemolsim_tpu_torch import observables
    from vaemolsim_tpu_torch.mcmc import (gauss_legendre_lambdas,
                                          mbar_free_energy,
                                          mbar_perturbed_free_energy,
                                          ti_free_energy)
    from vaemolsim_tpu_torch.parallel import (HREXState, make_hrex_step,
                                              run_hrex)
    kt, n_env, L, R = 2.0, 15, 4.0, 8
    n, beta = n_env + 1, 1.0 / kt
    alch = np.zeros(n, bool)
    alch[0] = True
    u_soft = potentials.lennard_jones_softcore(alchemical=alch, box=[L] * 3,
                                               device=dev)
    lambdas, gl_w = gauss_legendre_lambdas(R)

    def log_prob(x, lam):
        return -beta * u_soft(x, lam)

    gen = torch.Generator(device=dev).manual_seed(38)
    _build.reset_launches()
    t0 = time.perf_counter()
    x0 = L * torch.rand(R * HX_CHAINS, n, 3, generator=gen, device=dev)
    x0 = potentials.minimize_energy(lambda x: u_soft(x, 1.0), x0, steps=150)
    state = HREXState.create(x0.reshape(R, HX_CHAINS, n, 3), log_prob,
                             lambdas, gen)
    step = make_hrex_step(log_prob, scale=0.05, exchange_every=4)
    state, _ = run_hrex(step, state, HX_EQUIL)
    state, samples = run_hrex(step, state, HX_PROD, collect_every=10)
    sync(dev)
    hrex_s = time.perf_counter() - t0
    swap = float(state.swap_acceptance_rate)
    local = float(state.acceptance_rate)
    xs = samples.movedim(1, 0).reshape(R, -1, n, 3)
    lam_t = torch.tensor(lambdas, dtype=torch.float32, device=dev)
    dudl = []
    for lam, x in zip(lam_t, xs):
        lg = lam.expand(x.shape[0]).clone().requires_grad_(True)
        with torch.enable_grad():
            (g,) = torch.autograd.grad((beta * u_soft(x, lg)).sum(), lg)
        dudl.append(g)
    df_ti, err_ti = ti_free_energy(torch.stack(dudl), weights=gl_w)
    df_ti, err_ti = float(df_ti), float(err_ti)
    flat = xs.reshape(-1, n, 3)
    with torch.no_grad():
        chunks = flat.chunk(8)
        log_probs = torch.cat([torch.stack([log_prob(c, l) for l in lam_t])
                               for c in chunks], 1)
        res = mbar_free_energy(log_probs, [xs.shape[1]] * R)
        lp0 = torch.cat([log_prob(c, torch.zeros((), device=dev))
                         for c in chunks])
        lp1 = torch.cat([log_prob(c, torch.ones((), device=dev))
                         for c in chunks])
    df0, e0 = mbar_perturbed_free_energy(res, lp0)
    df1, e1 = mbar_perturbed_free_energy(res, lp1)
    df_mbar = float(df1 - df0)
    err_mbar = math.hypot(float(e0), float(e1))
    u_env = potentials.lennard_jones(box=[L] * 3, device=dev)
    log_prob_env = potentials.as_log_prob(u_env, beta=beta)
    xe0 = L * torch.rand(HX_CHAINS * R, n_env, 3, generator=gen, device=dev)
    xe0 = potentials.minimize_energy(u_env, xe0, steps=150)
    env = MCMCState.create(xe0, log_prob_env(xe0), gen)
    env_step = make_random_walk_step(log_prob_env, scale=0.05)
    env, _ = run_mcmc(env_step, env, HX_EQUIL)
    env, env_xs = run_mcmc(env_step, env, HX_PROD, collect_every=40)
    env_flat = env_xs.reshape(-1, n_env, 3)
    stride = max(1, env_flat.shape[0] // 3000)
    mu_ex, err_w = observables.widom_insertion(
        u_env, env_flat[::stride], box=[L] * 3, generator=gen,
        n_insertions=128, kT=kt)
    df_widom, err_widom = float(mu_ex) / kt, float(err_w) / kt
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("hrex")
    tol_mbar = 4.0 * math.hypot(err_ti, err_mbar) + 0.05
    tol_w = 5.0 * (err_ti + err_widom) + 0.10
    print(f"example 38: local acceptance {local:.3f}, swap acceptance "
          f"{swap:.3f}; dF TI {df_ti:+.3f} +- {err_ti:.3f}, MBAR "
          f"{df_mbar:+.3f} +- {err_mbar:.3f} (tol {tol_mbar:.3f}), Widom "
          f"{df_widom:+.3f} +- {err_widom:.3f} (tol {tol_w:.3f})", flush=True)
    fail_unless(0.10 < swap < 0.98, f"example 38: swap acceptance {swap}")
    fail_unless(abs(df_ti - df_mbar) < tol_mbar,
                f"example 38: TI {df_ti} against MBAR {df_mbar}")
    fail_unless(abs(df_ti - df_widom) < tol_w,
                f"example 38: TI {df_ti} against Widom {df_widom}")
    fail_unless(df_ti < 0.0 and df_widom < 0.0,
                f"example 38: TI {df_ti}, Widom {df_widom}")
    steps = HX_EQUIL + HX_PROD
    busy = card_busy(lambda: run_hrex(step, state, 20), 20, dev)
    return sampling_row(
        "hrex_ex38", wall, R * HX_CHAINS * steps / hrex_s, "replica-steps/s",
        counts, busy, ms_per_step=1e3 * hrex_s / steps, hrex_seconds=hrex_s,
        swap_acceptance=swap, local_acceptance=local, df_ti=df_ti,
        err_ti=err_ti, df_mbar=df_mbar, err_mbar=err_mbar,
        df_widom=df_widom, err_widom=err_widom)


def pimd_path(dev):
    """Example 34 at --full widths: the quartic double well V0 (r^2 - 1)^2
    (V0 2, kT 0.3) by PILE-thermostatted PIMD, 512 replicas x 32 beads and
    the classical P = 1 control, PI_STEPS steps of 0.01, every 20th kept
    after 40 frames: the virial energy within 5% of the exact (grid
    diagonalisation) quantum energy, the classical within 8% of
    quadrature, the quantum energy above 1.5x the classical (zero-point
    energy) and the barrier region's bead density above 1.5x the
    classical (tunnelling)."""
    from vaemolsim_tpu_torch import pimd
    v0, a, kt = 2.0, 1.0, 0.3

    def potential(x):
        r2 = (x * x).sum((-2, -1))
        return v0 * (r2 / a ** 2 - 1.0) ** 2

    def v_np(x):
        return v0 * ((x / a) ** 2 - 1.0) ** 2

    xg = np.linspace(-3.0, 3.0, 400)
    dx = xg[1] - xg[0]
    t_mat = (np.diag(np.full(400, 1.0 / dx ** 2))
             - 0.5 * np.diag(np.full(399, 1.0 / dx ** 2), 1)
             - 0.5 * np.diag(np.full(399, 1.0 / dx ** 2), -1))
    levels, psi = np.linalg.eigh(t_mat + np.diag(v_np(xg)))
    wq = np.exp(-(levels - levels[0]) / kt)
    wq /= wq.sum()
    e_quantum = float(np.sum(wq * levels))
    rho_q = (psi ** 2 * wq).sum(1) / dx
    xc = np.linspace(-3.0, 3.0, 4001)
    bc = np.exp(-v_np(xc) / kt)
    z = np.trapezoid(bc, xc)
    e_classical = float(np.trapezoid(v_np(xc) * bc, xc) / z + 0.5 * kt)

    def barrier(xs, dens):
        return float(np.trapezoid(np.where(np.abs(xs) < 0.3 * a, dens, 0.0),
                                  xs))

    gen = torch.Generator(device=dev).manual_seed(34)
    _build.reset_launches()
    t0 = time.perf_counter()
    out = {}
    for p in (32, 1):
        x0 = torch.where(torch.rand(PI_REPLICAS, 1, 1, generator=gen,
                                    device=dev) < 0.5, a, -a)
        xb, vb = pimd.init_thermal_ring(gen, x0, n_beads=p, kT=kt)
        _, traj = pimd.pimd_pile(potential, xb, vb, gen, dt=0.01,
                                 n_steps=PI_STEPS, kT=kt, tau0=1.0,
                                 collect_every=20)
        frames = traj[40:]
        e_vir = float(pimd.energy_virial(potential, frames, kT=kt).double()
                      .mean())
        rg2 = float(pimd.radius_of_gyration2(frames).double().mean())
        hist, edges = np.histogram(frames.reshape(-1).cpu().numpy(), bins=80,
                                   range=(-3, 3), density=True)
        out[p] = (e_vir, rg2, barrier(0.5 * (edges[1:] + edges[:-1]), hist))
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("pimd")
    (eq, rg2q, wq_sim), (ec, _, wc_sim) = out[32], out[1]
    err_q = abs(eq - e_quantum) / abs(e_quantum)
    err_c = abs(ec - e_classical) / abs(e_classical)
    ratio = wq_sim / max(wc_sim, 1e-12)
    print(f"example 34: quantum <E> {eq:.4f} against {e_quantum:.4f} "
          f"({100 * err_q:.2f}%), classical {ec:.4f} against "
          f"{e_classical:.4f} ({100 * err_c:.2f}%), barrier density ratio "
          f"{ratio:.2f} (exact quantum {barrier(xg, rho_q):.4f}), sqrt<rg2> "
          f"{math.sqrt(max(rg2q, 0.0)):.3f}", flush=True)
    fail_unless(err_q < 0.05, f"example 34: quantum energy {eq}")
    fail_unless(err_c < 0.08, f"example 34: classical energy {ec}")
    fail_unless(eq > 1.5 * ec, f"example 34: zero-point {eq} vs {ec}")
    fail_unless(ratio > 1.5, f"example 34: barrier ratio {ratio}")
    xb, vb = pimd.init_thermal_ring(gen, x0, n_beads=32, kT=kt)
    busy = card_busy(lambda: pimd.pimd_pile(
        potential, xb, vb, gen, dt=0.01, n_steps=20, kT=kt), 20, dev)
    return sampling_row(
        "pimd_ex34", wall, PI_REPLICAS * 33 * PI_STEPS / wall,
        "bead-steps/s", counts, busy, ms_per_step=1e3 * wall
        / (2 * PI_STEPS), e_quantum=eq, e_quantum_exact=e_quantum,
        e_classical=ec, e_classical_exact=e_classical, barrier_ratio=ratio)


def dynamics_path(dev):
    """Brownian, generalized-Langevin and DPD dynamics at kT 1, DYN_STEPS
    steps each: free Brownian diffusion of 4096 particles (D 1, dt 0.01),
    the mean squared displacement within 5% of 6 D t; Brownian dynamics
    with RPY hydrodynamics (1000 particles of radius 1, harmonic traps of
    stiffness 20 on a cubic lattice of spacing 3, dt 0.02, DYN_RPY_STEPS
    steps, about 13 relaxation times, from Boltzmann draws), the
    configurational kT (k <dx^2> per dof over the last three quarters)
    within 3%; GLE with one exponential-memory auxiliary
    momentum (1000 particles in harmonic traps, dt 0.05), the kinetic kT
    within 3%; DPD at Groot-Warren density 3 (10^3 box, 3000 particles,
    a 25, gamma 4.5, dt 0.04 with Groot and Warren's velocity-prediction
    factor 0.65), the kinetic kT over the last three
    quarters within 3% and the total momentum kept to 1e-3 of the summed
    |p|."""
    from vaemolsim_tpu_torch import bd, dpd, gle
    gen = torch.Generator(device=dev).manual_seed(99)
    kt, n_steps = 1.0, DYN_STEPS
    rows = {}
    _build.reset_launches()
    t0 = time.perf_counter()

    def free(x):
        return torch.zeros(x.shape[:-2], device=x.device) + 0.0 * x.sum(
            (-2, -1))

    x0 = torch.zeros(DYN_BD_N, 3, device=dev)
    s, _ = bd.brownian(free, x0, gen, dt=0.01, n_steps=n_steps, kT=kt,
                       diffusion=1.0)
    msd = float((s.x ** 2).sum(-1).double().mean())
    msd_want = 6.0 * 1.0 * 0.01 * n_steps
    rows["bd_free"] = dict(msd=msd, msd_want=msd_want)

    k_trap, side = 20.0, 10
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:DYN_RPY_N] * 3.0
    sites = torch.as_tensor(g, dtype=torch.float32, device=dev)

    def trap(x):
        return 0.5 * k_trap * ((x - sites) ** 2).sum((-2, -1))

    xr0 = sites + math.sqrt(kt / k_trap) * torch.randn(
        sites.shape, generator=gen, device=dev)
    _, traj = bd.brownian_rpy(trap, xr0, gen, dt=0.02,
                              n_steps=DYN_RPY_STEPS, kT=kt, collect_every=4)
    tail = traj[traj.shape[0] // 4:]
    fail_unless(bool(torch.isfinite(tail).all()),
                "BD-RPY: a Cholesky factor failed")
    kt_rpy = float(k_trap * ((tail - sites) ** 2).double().mean())
    rows["bd_rpy"] = dict(kT=kt_rpy)

    def trap_gle(x):
        return 0.5 * ((x - sites) ** 2).sum((-2, -1))

    a_mat = gle.exp_memory_matrix(2.0, 0.5)
    v0 = math.sqrt(kt) * torch.randn(sites.shape, generator=gen, device=dev)
    _, (_, vs) = gle.gle_baoab(trap_gle, sites.clone(), v0, gen, dt=0.05,
                               n_steps=n_steps, kT=kt, a_matrix=a_mat,
                               collect_every=4, collect_v=True)
    kt_gle = float((vs[vs.shape[0] // 4:] ** 2).double().mean())
    rows["gle"] = dict(kT=kt_gle)

    L = float(DYN_DPD_L)
    n_dpd = 3 * DYN_DPD_L ** 3
    xd = L * torch.rand(n_dpd, 3, generator=gen, device=dev)
    vd = math.sqrt(kt) * torch.randn(n_dpd, 3, generator=gen, device=dev)
    vd = vd - vd.mean(0)
    p0 = vd.double().sum(0)
    sd, (_, vds) = dpd.dpd_vv(xd, vd, gen, n_steps=n_steps, dt=0.04, a=25.0,
                              gamma=4.5, kT=kt, box=[L] * 3, lam=0.65,
                              collect_every=4, collect_v=True)
    kt_dpd = float((vds[vds.shape[0] // 4:] ** 2).double().mean())
    drift = float((sd.v.double().sum(0) - p0).abs().max())
    p_abs = float(sd.v.double().abs().sum())
    rows["dpd"] = dict(kT=kt_dpd, momentum_drift=drift, sum_abs_p=p_abs)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("dynamics")
    print(f"dynamics: free BD MSD {msd:.4f} against {msd_want:.4f}; "
          f"BD-RPY kT {kt_rpy:.4f}; GLE kT {kt_gle:.4f}; DPD kT "
          f"{kt_dpd:.4f}, momentum drift {drift:.3e} of summed |p| "
          f"{p_abs:.1f}", flush=True)
    fail_unless(abs(msd / msd_want - 1.0) < 0.05, f"free BD MSD {msd}")
    fail_unless(abs(kt_rpy - kt) < 0.03 * kt, f"BD-RPY kT {kt_rpy}")
    fail_unless(abs(kt_gle - kt) < 0.03 * kt, f"GLE kT {kt_gle}")
    fail_unless(abs(kt_dpd - kt) < 0.03 * kt, f"DPD kT {kt_dpd}")
    fail_unless(drift < 1e-3 * p_abs, f"DPD momentum drift {drift}")
    busy = card_busy(lambda: dpd.dpd_vv(sd.x, sd.v, gen, n_steps=5, dt=0.04,
                                        box=[L] * 3, lam=0.65), 5, dev)
    return sampling_row(
        "dynamics", wall, (3 * n_steps + DYN_RPY_STEPS) / wall,
        "integrator-steps/s", counts,
        busy, ms_per_step=1e3 * wall / (3 * n_steps + DYN_RPY_STEPS),
        **rows)


# ---------------------------------------------------------------------------
# Slice 13a: collective variables, metadynamics, OPES, eABF, NEB and TPS,
# every loop through utils.scan_collect (captured chunks replayed)
# ---------------------------------------------------------------------------

# Example 23 (--full widths): walkers, metadynamics steps, the plain
# control's (the example's default depth is 24 000 and 6000, --full runs
# 60 000 and 15 000; cut to pay for slice 14a, PERF.md section 4).
MT_WALKERS, MT_STEPS, MT_CONTROL = 64, 16_000, 4_000
# tests/test_opes.py and tests/test_abf.py: steps of each run.
OP_STEPS, AB_STEPS = 12_000, 40_000
# OPES's largest profile error: tests/test_opes.py asserts 1.2 kT at its
# one seed, but over seeds 1-18 the JAX package's own run gives 1.18-1.47
# (2 of 18 under 1.2) and the port's on the CPU 1.14-1.47 (5 of 18), with
# mean errors 0.37-0.43 under the 0.45 held here as there
# (tools/opes_error_spread.py): the phase holds the port to 1.5.
OP_MAX_ERR = 1.5
# Example 32 (--full widths): walkers, burn-in and harvest sweeps (the
# example's default depth; --full runs 250 and 400), NEB steps.
TP_WALKERS, TP_BURN, TP_HARVEST, NEB_STEPS = 48, 150, 250, 3000
# Example 33 (--full widths): configurations, shots each, training steps
# (the example's default 12 shots and 900 steps; --full 16 and 1500).
CM_CONFIGS, CM_SHOTS, CM_TRAIN = 768, 12, 900
MB_KT, MB_DT, MB_FRICTION, MB_FRAMES = 7.0, 0.004, 2.0, 401


def replay_busy(run, steps, dev, skip=0):
    """Device-busy ms of a replayed step and the replayed loop's idle
    share: run() twice from its first CUDA-graph replay on (the capture's
    eager warm-up left out; with ``skip``, from replay skip + 1 on, so that
    the first replay's upload of the graph is left out too), once timed
    and once under torch.profiler (device activity only), whose kernel
    times give the busy time; the timed pass gives the wall, since tracing
    the replays slows them.  ``steps``: the steps its replays in the window
    run.  (None, None) off the card or where the trace holds no device
    time."""
    if dev.type != "cuda":
        return None, None
    from torch.profiler import ProfilerActivity, profile
    replay = torch.cuda.CUDAGraph.replay

    def from_first_replay(begin):
        started, seen = [], [0]

        def first_begins(graph):
            seen[0] += 1
            if not started and seen[0] > skip:
                torch.cuda.synchronize()
                begin()
                started.append(time.perf_counter())
            return replay(graph)

        torch.cuda.CUDAGraph.replay = first_begins
        try:
            run()
            torch.cuda.synchronize()
        finally:
            torch.cuda.CUDAGraph.replay = replay
        return 1e3 * (time.perf_counter() - started[0]) if started else None

    wall_ms = from_first_replay(lambda: None)
    prof = profile(activities=[ProfilerActivity.CUDA])
    if wall_ms is None or from_first_replay(prof.start) is None:
        return None, None
    prof.stop()
    busy_us, _ = device_time(prof)
    if busy_us is None:
        return None, None
    return busy_us / 1e3 / steps, 1.0 - busy_us / 1e3 / wall_ms


def replay_row(name, wall, steps, rate, unit, counts, eager, eager_steps,
               replayed, replayed_steps, dev, skip=0, **extra):
    """Record and print one replayed path: its rate; ms a step replayed
    (the run's wall over its integrator steps, capture included) against
    ms a step of the eager loop (``eager()``, ``eager_steps`` steps, under
    ``scan.eager()``); and, from a profile of ``replayed()``'s replays
    after the first ``skip`` (``replayed_steps`` steps), the device-busy
    ms of a replayed step and the replayed loop's idle share."""
    from vaemolsim_tpu_torch.utils import scan
    replay_ms = 1e3 * wall / steps
    with scan.eager():
        sync(dev)
        t0 = time.perf_counter()
        eager()
        sync(dev)
        eager_ms = 1e3 * (time.perf_counter() - t0) / eager_steps
    busy_ms, idle = replay_busy(replayed, replayed_steps, dev, skip)
    row = {"path": name, "seconds": wall, "rate": rate, "unit": unit,
           "launches": counts, "ms_per_step_replayed": replay_ms,
           "ms_per_step_eager": eager_ms, "device_busy_ms": busy_ms,
           "device_idle_share": idle, "replays_skipped": skip, **extra}
    RESULTS["sampling"].append(row)
    busy = ("device busy not measured" if busy_ms is None else
            f"device busy {busy_ms:.4f} ms a replayed step, idle share "
            f"{idle:.3f}" + (f" (first {skip} replay skipped)" if skip
                             else ""))
    print(f"replay {name}: {rate:.1f} {unit} ({wall:.3f} s); "
          f"{replay_ms:.4f} ms a step replayed against {eager_ms:.4f} "
          f"eager; {busy}; launches {counts}", flush=True)
    return row


def butane(dev):
    """Example 23's butane-like chain: stiff bonds and angle, a 1 + 3-fold
    torsion (1.2, 2.2 kT), its torsion CV and the bare torsion profile."""
    quad = [[0, 1, 2, 3]]
    pot = potentials.composite(
        potentials.harmonic_bonds([[0, 1], [1, 2], [2, 3]], k=400.0, r0=1.0,
                                  device=dev),
        potentials.harmonic_angles([[0, 1, 2], [1, 2, 3]], k=100.0,
                                   theta0=1.9106, device=dev),
        potentials.periodic_torsions(quad, k=[1.2, 2.2], n=[1, 3],
                                     phase=[0.0, 0.0], device=dev))

    def profile(phi):
        return 1.2 * (1 + np.cos(phi)) + 2.2 * (1 + np.cos(3 * phi))

    return pot, colvars.torsion(0, 1, 2, 3), profile


def metadynamics_path(dev):
    """Example 23 at its --full width: MT_WALKERS walkers of the butane-like
    chain from a 300-step ``minimize_energy`` of gauche starts,
    well-tempered metadynamics on the periodic torsion (90 bins, hills 0.15
    wide 0.25, gamma 8, dt 0.004, friction 2, a deposit every 25 steps) for
    MT_STEPS steps, then the unbiased control for MT_CONTROL steps; the
    example's asserts: cis-eclipse coverage above 0.02, the profile's RMS
    error against the torsion potential under 0.5 kT, the global minimum
    within 0.2 rad, the control's coverage under a third of the biased one."""
    from vaemolsim_tpu_torch import metadynamics as mtd
    pot, cv, profile = butane(dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    x = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.5, 0.94, 0.0],
                      [1.2, 1.45, 0.9]], device=dev)
    x = x[None] + 0.02 * torch.randn(MT_WALKERS, 4, 3, generator=gen,
                                     device=dev)
    x0 = potentials.minimize_energy(pot, x, steps=300, lr=0.01)
    kw = dict(dt=0.004, deposit_every=25, hill_height=0.15, hill_width=0.25,
              kT=1.0, gamma=8.0, friction=2.0)
    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    _, grid, cvs = mtd.metad_baoab(
        pot, cv, x0, torch.zeros_like(x0), gen, n_steps=MT_STEPS,
        grid=mtd.bias_grid(-np.pi, np.pi, 90, periodic=True, device=dev),
        **kw)
    sync(dev)
    wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    traj = md._BAOAB(pot, dt=0.004, kt=1.0, friction=2.0, masses=1.0).run(
        x0, torch.zeros_like(x0), MT_CONTROL, gen, collect_v=False,
        collect_every=200)
    sync(dev)
    control_wall = time.perf_counter() - t1
    counts = path_counts("metadynamics")
    coverage = float((cvs.abs() < 0.4).float().mean())
    s, f = mtd.free_energy_from_bias(grid, kT=1.0, gamma=8.0)
    s, f = s.cpu().double().numpy(), f.cpu().double().numpy()
    u = profile(s)
    u = u - u.min()
    err = f - u
    err = err - err.mean()
    rms = float(np.sqrt(np.mean(err ** 2)))
    dphi = abs(s[np.argmin(f)] - s[np.argmin(u)])
    dphi = min(dphi, 2 * np.pi - dphi)
    cis_plain = float((cv(traj.reshape(-1, 4, 3)).abs() < 0.4).float()
                      .mean())
    print(f"example 23: cis coverage {coverage:.4f} (control "
          f"{cis_plain:.4f}), profile RMS {rms:.4f} kT, max "
          f"{float(np.abs(err).max()):.4f}, minimum off by {dphi:.4f} rad; "
          f"control {MT_CONTROL} steps in {control_wall:.3f} s", flush=True)
    fail_unless(coverage > 0.02, f"example 23: coverage {coverage}")
    fail_unless(rms < 0.5, f"example 23: profile RMS {rms}")
    fail_unless(dphi < 0.2, f"example 23: minimum off by {dphi}")
    fail_unless(cis_plain < coverage / 3,
                f"example 23: control {cis_plain} vs {coverage}")
    def short(n, every):
        return lambda: mtd.metad_baoab(
            pot, cv, x0, torch.zeros_like(x0), gen, n_steps=n,
            grid=mtd.bias_grid(-np.pi, np.pi, 90, periodic=True,
                               device=dev), **dict(kw, deposit_every=every))

    # Eagerly 5 steps and a deposit; replayed, three chunks of one
    # interval each (an odd count of intervals).
    return replay_row(
        "metadynamics_ex23", wall, MT_STEPS, MT_WALKERS * MT_STEPS / wall,
        "walker-steps/s", counts, short(5, 5), 5, short(75, 25), 75, dev,
        coverage=coverage,
        rms_kT=rms, dphi=dphi, control_coverage=cis_plain,
        control_seconds=control_wall)


def _well(height):
    def potential(x):
        s = x[..., 0, 0]
        return height * (s * s - 1.0) ** 2
    return potential


def _first_coordinate(x):
    return x[..., 0, 0]


def opes_eabf_path(dev):
    """The JAX package's convergence checks of OPES and eABF on the card.
    OPES (tests/test_opes.py): the 8 kT double well, 32 walkers from -1,
    121 nodes on [-1.8, 1.8], barrier 12, gamma 10, sigma 0.12, a deposit
    every 20 steps of 0.01, OP_STEPS steps: over the first 4000 steps more
    than 80% of walkers pass s = 0.5, and the profile's error against U(s)
    (|s| < 1.3, mean removed) is at most OP_MAX_ERR (max) and 0.45 kT
    (mean).
    eABF (tests/test_abf.py): the 6 kT well, 16 walkers, 33 bins on [-1.6,
    1.6], kappa 200, ramp 100, AB_STEPS steps: more than 5% of walkers end
    past 0.5, and CZAR's error at most 1.5 kT (max) and 0.6 (mean)."""
    from vaemolsim_tpu_torch import abf, opes
    gen = torch.Generator(device=dev).manual_seed(15)
    dw8 = _well(8.0)
    x0 = -1.0 + 0.05 * torch.randn(32, 1, 1, generator=gen, device=dev)
    okw = dict(dt=0.01, deposit_every=20, sigma=0.12, friction=2.0)

    def ogrid():
        return opes.opes_grid(-1.8, 1.8, 121, barrier=12.0, gamma=10.0,
                              device=dev)

    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    _, og, cvs = opes.opes_baoab(dw8, _first_coordinate, x0,
                                 torch.zeros_like(x0), gen,
                                 n_steps=OP_STEPS, grid=ogrid(), **okw)
    sync(dev)
    opes_wall = time.perf_counter() - t0
    visited = float((cvs[:4000 // 20] > 0.5).any(0).float().mean())
    s, f = (a.cpu().double().numpy() for a in opes.free_energy_from_opes(og))
    sel = np.abs(s) < 1.3
    err = (f - 8.0 * (s ** 2 - 1.0) ** 2)[sel]
    err = err - err.mean()
    o_max, o_mean = float(np.abs(err).max()), float(np.abs(err).mean())

    dw6 = _well(6.0)
    xa = -torch.ones(16, 1, 1, device=dev)
    akw = dict(dt=0.01, kappa=200.0, kT=1.0, friction=2.0,
               ramp_count=100.0)
    sync(dev)
    t1 = time.perf_counter()
    st, _, tbl, _ = abf.eabf_baoab(
        dw6, _first_coordinate, xa, torch.zeros_like(xa), gen,
        n_steps=AB_STEPS, grid=abf.abf_grid(-1.6, 1.6, 33, device=dev),
        **akw)
    sync(dev)
    abf_wall = time.perf_counter() - t1
    counts = path_counts("opes_eabf")
    crossed = float((st.x[..., 0, 0] > 0.5).float().mean())
    c, a = (t.cpu().double().numpy()
            for t in abf.czar_free_energy(tbl, kappa=200.0))
    sel = np.abs(c) < 1.3
    err = (a - 6.0 * (c ** 2 - 1.0) ** 2)[sel]
    err = err - err.mean()
    a_max, a_mean = float(np.abs(err).max()), float(np.abs(err).mean())
    print(f"OPES: {visited:.3f} of walkers crossed in 4000 steps, profile "
          f"error max {o_max:.4f} mean {o_mean:.4f} kT ({opes_wall:.3f} s);"
          f" eABF: {crossed:.3f} end past 0.5, CZAR error max "
          f"{a_max:.4f} mean {a_mean:.4f} kT ({abf_wall:.3f} s)",
          flush=True)
    fail_unless(visited > 0.8, f"OPES: visited {visited}")
    fail_unless(o_max < OP_MAX_ERR and o_mean < 0.45,
                f"OPES: profile error {o_max}, {o_mean}")
    fail_unless(crossed > 0.05, f"eABF: crossed {crossed}")
    fail_unless(a_max < 1.5 and a_mean < 0.6,
                f"eABF: CZAR error {a_max}, {a_mean}")
    def short_o(n):
        return lambda: opes.opes_baoab(
            dw8, _first_coordinate, x0, torch.zeros_like(x0), gen,
            n_steps=n, grid=ogrid(), **okw)

    def short_a(n):
        return lambda: abf.eabf_baoab(
            dw6, _first_coordinate, xa, torch.zeros_like(xa), gen,
            n_steps=n, grid=abf.abf_grid(-1.6, 1.6, 33, device=dev), **akw)

    # Replayed: three chunks (OPES: one interval each; eABF: 50 steps).
    o_row = replay_row(
        "opes", opes_wall, OP_STEPS, OP_STEPS / opes_wall, "steps/s",
        counts, short_o(20), 20, short_o(60), 60, dev, visited=visited,
        err_max=o_max, err_mean=o_mean)
    a_row = replay_row(
        "eabf", abf_wall, AB_STEPS, AB_STEPS / abf_wall, "steps/s", counts,
        short_a(20), 20, short_a(150), 150, dev, crossed=crossed,
        err_max=a_max, err_mean=a_mean)
    return {"launches": counts, "opes": o_row, "eabf": a_row}


def muller_brown(dev):
    """The Muller-Brown surface of examples 32 and 33: (..., 1, 2) ->
    (...,)."""
    cs = [torch.tensor(v, device=dev) for v in (
        [-200.0, -100.0, -170.0, 15.0], [-1.0, -1.0, -6.5, 0.7],
        [0.0, 0.0, 11.0, 0.6], [-10.0, -10.0, -6.5, 0.7],
        [1.0, 0.0, -0.5, -1.0], [0.0, 0.5, 1.5, 1.0])]

    def potential(conf):
        dx = conf[..., 0, 0][..., None] - cs[4]
        dy = conf[..., 0, 1][..., None] - cs[5]
        return (cs[0] * torch.exp(cs[1] * dx * dx + cs[2] * dx * dy
                                  + cs[3] * dy * dy)).sum(-1)

    return potential


def mb_geometry(pot, dev):
    """Examples 32 / 33's zero-temperature part: the minima A and C (2000
    ``minimize_energy`` steps of 0.005, both starts in one batch), the
    climbing NEB of 24 images over NEB_STEPS steps, and the basins."""
    from vaemolsim_tpu_torch import paths
    starts = torch.tensor([[[-0.558, 1.442]], [[0.623, 0.028]]], device=dev)
    mins = potentials.minimize_energy(pot, starts, steps=2000, lr=0.005)
    ma, mc = mins[0], mins[1]
    res = paths.climbing_neb(pot, paths.interpolate_path(ma, mc, 24),
                             n_steps=NEB_STEPS, k_spring=50.0, dt=0.002,
                             climb_after=500)

    def in_a(x):
        return ((x[..., 0, :] - ma[0]) ** 2).sum(-1) < 0.35 ** 2

    def in_b(x):
        return ((x[..., 0, :] - mc[0]) ** 2).sum(-1) < 0.35 ** 2

    return ma, mc, res, in_a, in_b


def tps_seed(res, walkers, dev):
    """The NEB path resampled to MB_FRAMES frames by ``jnp.interp``'s
    rule and tiled over walkers: (walkers, MB_FRAMES, 1, 2)."""
    from vaemolsim_tpu_torch import paths
    t_img = torch.linspace(0.0, 1.0, res.path.shape[0], device=dev)
    t_frm = torch.linspace(0.0, 1.0, MB_FRAMES, device=dev)
    xy = paths._interp_columns(t_frm, t_img, res.path[:, 0, :])
    return xy[None, :, None, :].repeat(walkers, 1, 1, 1)


def tps_path(dev):
    """Example 32 at its --full width: the Muller-Brown minima and the
    climbing NEB (saddle energy within 1e-2 of -40.664844), the harmonic TST
    rate at kT 7, then TP_WALKERS walkers of MB_FRAMES frames, TP_BURN
    burn-in and TP_HARVEST harvest sweeps of one-way shooting (dt 0.004,
    friction 2), every 10th ensemble kept; the example's asserts: acceptance
    above 0.1, the mean crossing point within 0.25 of the saddle, the mean
    peak energy 0.5-4 kT above it, the mean transit time below the path's
    length."""
    from vaemolsim_tpu_torch import mcmc, paths
    pot = muller_brown(dev)
    gen = torch.Generator(device=dev).manual_seed(32)
    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    ma, mc, res, in_a, in_b = mb_geometry(pot, dev)
    saddle = res.saddle
    e_saddle = float(pot(saddle))
    k_tst = float(paths.harmonic_tst_rate(pot, ma, saddle, kt=MB_KT))
    sync(dev)
    geometry_wall = time.perf_counter() - t0
    state = mcmc.tps_init(tps_seed(res, TP_WALKERS, dev), generator=gen,
                          kt=MB_KT)
    fail_unless(bool(in_a(state.path[:, 0]).all()
                     & in_b(state.path[:, -1]).all()),
                "example 32: the seed paths are not reactive")
    step = mcmc.make_tps_step(pot, in_a=in_a, in_b=in_b, dt=MB_DT,
                              kt=MB_KT, friction=MB_FRICTION)
    sync(dev)
    t1 = time.perf_counter()
    state, _ = mcmc.run_tps(step, state, gen, TP_BURN)
    state, coll = mcmc.run_tps(step, state, gen, TP_HARVEST,
                               collect_every=10)
    sync(dev)
    wall = time.perf_counter() - t1
    counts = path_counts("tps")
    acc = float(state.acceptance_rate.mean())
    xy = coll.reshape(-1, MB_FRAMES, 2)
    e = pot(xy[:, :, None, :])
    i_peak = e.argmax(1)
    peak = xy[torch.arange(xy.shape[0], device=dev), i_peak]
    dist = float(torch.linalg.norm(peak.mean(0) - saddle[0]))
    de = float(e.max(1).values.mean()) - e_saddle
    f_idx = torch.arange(MB_FRAMES, device=dev)[None]
    a_mask, b_mask = in_a(xy[:, :, None, :]), in_b(xy[:, :, None, :])
    enter_b = b_mask.int().argmax(1)
    leave_a = torch.where(a_mask & (f_idx < enter_b[:, None]), f_idx,
                          -1).amax(1)
    transit = float(((enter_b - leave_a) * MB_DT).float().mean())
    print(f"example 32: NEB saddle ({float(saddle[0, 0]):+.4f}, "
          f"{float(saddle[0, 1]):+.4f}) E {e_saddle:.6f}, TST rate "
          f"{k_tst:.4e}; {xy.shape[0]} paths, acceptance {acc:.4f}, "
          f"crossing {dist:.4f} from the saddle, peak {de / MB_KT:.3f} kT "
          f"above it, transit {transit:.4f} of {(MB_FRAMES - 1) * MB_DT:.2f}"
          f" (geometry {geometry_wall:.3f} s)", flush=True)
    fail_unless(abs(e_saddle + 40.664844) < 1e-2,
                f"example 32: saddle energy {e_saddle}")
    fail_unless(math.isfinite(k_tst) and k_tst > 0,
                f"example 32: TST rate {k_tst}")
    fail_unless(acc > 0.1, f"example 32: acceptance {acc}")
    fail_unless(dist < 0.25, f"example 32: crossing {dist}")
    fail_unless(0.5 < de / MB_KT < 4.0, f"example 32: peak {de}")
    fail_unless(transit < (MB_FRAMES - 1) * MB_DT,
                f"example 32: transit {transit}")
    sweeps = TP_BURN + TP_HARVEST
    # The step times on paths of 41 frames: a sweep eagerly, three
    # replayed (the kernels of a BAOAB step do not depend on the length).
    short = state._replace(path=state.path[:, ::10], vel=state.vel[:, ::10])
    row = replay_row(
        "tps_ex32", wall, sweeps * (MB_FRAMES - 1), sweeps / wall,
        "sweeps/s", counts, lambda: mcmc.run_tps(step, short, gen, 1), 40,
        lambda: mcmc.run_tps(step, short, gen, 3), 120, dev,
        acceptance=acc, saddle_energy=e_saddle,
        tst_rate=k_tst, crossing=dist, peak_kT=de / MB_KT, transit=transit,
        geometry_seconds=geometry_wall)
    return row, (pot, ma, mc, res, in_a, in_b, step)


def committor_path(geometry, dev):
    """Example 33 at its --full width, on example 32's minima and NEB (the
    same computation): 24 TPS walkers, 100 burn-in and 100 harvest sweeps,
    CM_CONFIGS frames drawn without replacement, labelled by
    ``first_hitting_committor`` (CM_SHOTS shots of up to 1000 steps); the
    tanh MLP 2 -> 64 -> 64 -> 1 trained CM_TRAIN Adam steps (3e-3) on the
    resolved-shot-weighted binomial likelihood of 80% of them; then 256
    shots from the saddle. The example's asserts: held-out correlation above
    0.85 and MAE under 0.15, q(A) < 0.2 and q(C) > 0.8, q(saddle) in (0.25,
    0.75) and within 0.2 of the shooting estimate."""
    from vaemolsim_tpu_torch import mcmc
    from vaemolsim_tpu_torch.nn.core import MLP
    pot, ma, mc, res, in_a, in_b, step = geometry
    gen = torch.Generator(device=dev).manual_seed(33)
    ckw = dict(in_a=in_a, in_b=in_b, max_steps=1000, dt=MB_DT, kt=MB_KT,
               friction=MB_FRICTION)
    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    state = mcmc.tps_init(tps_seed(res, 24, dev), generator=gen, kt=MB_KT)
    state, _ = mcmc.run_tps(step, state, gen, 100)
    state, coll = mcmc.run_tps(step, state, gen, 100, collect_every=10)
    frames = coll.reshape(-1, 1, 2)
    pick = torch.randperm(frames.shape[0], generator=gen,
                          device=dev)[:CM_CONFIGS]
    configs = frames[pick]
    sync(dev)
    tps_wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    q_mc, unres = mcmc.first_hitting_committor(
        pot, configs, generator=gen, n_shots=CM_SHOTS, **ckw)
    sync(dev)
    shots_wall = time.perf_counter() - t1
    n_eff = CM_SHOTS * (1.0 - unres)
    q_mc = torch.where(n_eff > 0, q_mc, 0.0)
    n_tr = int(0.8 * CM_CONFIGS)
    xy = configs[:, 0, :]
    net = MLP.create(gen, 2, [64, 64], 1, activation="tanh", device=dev)
    opt = torch.optim.Adam(net.parameters(), lr=3e-3)
    t2 = time.perf_counter()
    for _ in range(CM_TRAIN):
        logit = net(xy[:n_tr])[:, 0]
        ce = torch.nn.functional.binary_cross_entropy_with_logits(
            logit, q_mc[:n_tr], reduction="none")
        loss = (ce * n_eff[:n_tr]).sum() / n_eff[:n_tr].sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
    sync(dev)
    train_wall = time.perf_counter() - t2
    with torch.no_grad():
        p_te = torch.sigmoid(net(xy[n_tr:])[:, 0])
        q_te = q_mc[n_tr:]
        mae = float((p_te - q_te).abs().mean())
        corr = float(torch.corrcoef(torch.stack([p_te, q_te]))[0, 1])
        trio = torch.stack([ma[0], res.saddle[0], mc[0]])
        p_trio = torch.sigmoid(net(trio)[:, 0]).cpu().numpy()
    q_saddle, _ = mcmc.first_hitting_committor(
        pot, res.saddle[None], generator=gen, n_shots=256, **ckw)
    q_saddle = float(q_saddle[0])
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("committor")
    print(f"example 33: {CM_CONFIGS} configs x {CM_SHOTS} shots, mean q "
          f"{float(q_mc.mean()):.4f}, unresolved {float(unres.mean()):.4f};"
          f" held-out MAE {mae:.4f}, correlation {corr:.4f}; q at [A, "
          f"saddle, C] {np.round(p_trio, 4).tolist()}, shooting at the "
          f"saddle {q_saddle:.4f}; TPS {tps_wall:.3f} s, shots "
          f"{shots_wall:.3f} s, training {train_wall:.3f} s", flush=True)
    fail_unless(corr > 0.85, f"example 33: correlation {corr}")
    fail_unless(mae < 0.15, f"example 33: MAE {mae}")
    fail_unless(p_trio[0] < 0.2 and p_trio[2] > 0.8,
                f"example 33: basins {p_trio}")
    fail_unless(0.25 < p_trio[1] < 0.75, f"example 33: saddle {p_trio}")
    fail_unless(abs(p_trio[1] - q_saddle) < 0.2,
                f"example 33: saddle {p_trio[1]} vs shooting {q_saddle}")
    def short(n):
        return lambda: mcmc.first_hitting_committor(
            pot, configs, generator=gen, n_shots=CM_SHOTS,
            **dict(ckw, max_steps=n))

    return replay_row(
        "committor_ex33", shots_wall, 1000, CM_CONFIGS * CM_SHOTS
        / shots_wall, "shots/s", counts, short(20), 20, short(150), 150,
        dev, mae=mae, corr=corr,
        q_trio=p_trio.tolist(), q_saddle_shooting=q_saddle,
        tps_seconds=tps_wall, train_seconds=train_wall, total_seconds=wall)


def scan_replay_path(dev):
    """Replay against the eager loop on the card, at the phases' widths,
    over two captured chunks each or more: example 23's metadynamics (two
    chunks of two deposit intervals), two of example 32's shooting sweeps
    (a sweep a chunk), 100 steps of example 33's committor shots (two
    chunks of 50), and example 35's rare-event machinery: a 100-step
    basin_flux of 256 replicas and a 100-step ffs_stage of RE_TRIALS
    trials (two chunks of 50 each), five WE iterations of 10 bins x 24
    walkers (a 20-step segment and the resampling a chunk, run_we's
    default); and slice 13c's MD: one DiffTRe sampling round of example 31
    (DT_MD_STEPS steps of 24 chains, twelve chunks) and 100 steps each of
    example 18's FG MD and CG MD on a SchNet potential (two chunks): the
    largest difference of any output, at most 1e-6."""
    from vaemolsim_tpu_torch import mcmc, we
    from vaemolsim_tpu_torch import metadynamics as mtd
    from vaemolsim_tpu_torch.utils import scan
    pot, cv, _ = butane(dev)
    x = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.5, 0.94, 0.0],
                      [1.2, 1.45, 0.9]], device=dev)[None].repeat(
                          MT_WALKERS, 1, 1)
    mb = muller_brown(dev)
    ma = torch.tensor([[-0.5582, 1.4417]], device=dev)
    mc = torch.tensor([[0.6235, 0.0280]], device=dev)

    def in_a(q):
        return ((q[..., 0, :] - ma[0]) ** 2).sum(-1) < 0.35 ** 2

    def in_b(q):
        return ((q[..., 0, :] - mc[0]) ** 2).sum(-1) < 0.35 ** 2

    line = torch.stack([torch.linspace(float(ma[0, k]), float(mc[0, k]),
                                       MB_FRAMES, device=dev)
                        for k in range(2)], -1)[None, :, None, :]
    step = mcmc.make_tps_step(mb, in_a=in_a, in_b=in_b, dt=MB_DT,
                              kt=MB_KT, friction=MB_FRICTION)
    configs = line[0, ::MB_FRAMES // 40].repeat(300, 1, 1)[:CM_CONFIGS]

    def metad():
        gen = torch.Generator(device=dev).manual_seed(1)
        return mtd.metad_baoab(
            pot, cv, x, torch.zeros_like(x), gen, dt=0.004, n_steps=100,
            deposit_every=25, grid=mtd.bias_grid(-np.pi, np.pi, 90,
                                                 periodic=True, device=dev),
            hill_height=0.15, hill_width=0.25, gamma=8.0, friction=2.0)

    def sweeps():
        gen = torch.Generator(device=dev).manual_seed(2)
        state = mcmc.tps_init(line.repeat(TP_WALKERS, 1, 1, 1),
                              generator=gen, kt=MB_KT)
        return mcmc.run_tps(step, state, gen, 2)

    def shots():
        gen = torch.Generator(device=dev).manual_seed(3)
        return mcmc.first_hitting_committor(
            mb, configs, in_a=in_a, in_b=in_b, generator=gen,
            n_shots=CM_SHOTS, max_steps=100, dt=MB_DT, kt=MB_KT,
            friction=MB_FRICTION)

    rare = dict(dt=0.01, kT=0.4, friction=1.0)
    g0 = torch.Generator(device=dev).manual_seed(7)
    x_re = -1.0 + 0.1 * torch.randn(256, 1, 1, generator=g0, device=dev)
    v_re = math.sqrt(0.4) * torch.randn(256, 1, 1, generator=g0, device=dev)
    dyn35 = md._BAOAB(_well(2.0), dt=0.01, kt=0.4, friction=1.0, masses=1.0)
    step35, _ = we_parts(dyn35, torch.linspace(-1.4, 1.0, 9, device=dev),
                         20, 10, 24, dev)

    def flux():
        gen = torch.Generator(device=dev).manual_seed(4)
        return mcmc.basin_flux(_well(2.0), _first_coordinate, x_re, v_re,
                               gen, lambda0=-0.6, n_steps=100, **rare)

    def stage():
        gen = torch.Generator(device=dev).manual_seed(5)
        return mcmc.ffs_stage(
            _well(2.0), _first_coordinate, torch.full_like(x_re, -0.6),
            v_re.abs(), torch.ones(256, dtype=torch.bool, device=dev), gen,
            lambda_next=-0.2, lambda_fail=-0.6, max_steps=100,
            n_trials=RE_TRIALS, **rare)

    def we_iterations():
        gen = torch.Generator(device=dev).manual_seed(6)
        state = we.we_init((x_re[:64], v_re[:64]), 10, 24)
        return we.run_we(step35, state, gen, 5)

    # Slice 13c: one DiffTRe sampling round of example 31 (DT_MD_STEPS
    # steps, a frame every 25) and 100 steps each of example 18's FG MD and
    # CG MD on a SchNet potential, from relaxed starts.
    g13c = torch.Generator(device=dev).manual_seed(9)
    make31 = lj31(dev)[0]
    p31 = log_params(0.6, 1.12, dev)
    x31 = potentials.minimize_energy(
        make31(p31), (DT_N / DT_RHO) ** (1.0 / 3.0) * torch.rand(
            DT_CHAINS, DT_N, 3, generator=g13c, device=dev), steps=100,
        lr=0.05)
    fg_pot, L18 = cg_system(dev)
    x18 = potentials.minimize_energy(fg_pot, (L18 * torch.rand(
        CG_REP, CG_M, 1, 3, generator=g13c, device=dev) + 0.4 * torch.randn(
            CG_REP, CG_M, CG_APM, 3, generator=g13c, device=dev)).reshape(
                CG_REP, -1, 3), steps=100, lr=0.02)
    r18 = x18.reshape(CG_REP, CG_M, CG_APM, 3).mean(2)
    schnet = SchNetPotential.create(g13c, 1, features=32, num_blocks=2,
                                    n_rbf=24, cutoff=2.5, device=dev)
    for p in schnet.parameters():
        p.requires_grad_(False)
    cg_pot = schnet.as_potential(torch.ones(CG_M, 1, device=dev),
                                 box=torch.full((3,), L18, device=dev))

    def difftre_round():
        gen = torch.Generator(device=dev).manual_seed(10)
        dyn = lj31_md(make31, p31)
        return dyn.scan(dyn.start(x31, torch.zeros_like(x31)), DT_MD_STEPS,
                        gen, collect_every=25, snapshot_fn=lambda st: st.x)

    def md18(pot, x, dt, friction, seed):
        def run():
            gen = torch.Generator(device=dev).manual_seed(seed)
            dyn = md._BAOAB(pot, dt=dt, kt=1.0, friction=friction,
                            masses=1.0)
            return dyn.run(x, torch.zeros_like(x), 100, gen, False, 50)
        return run

    diffs = {}
    for name, run in (("metad_baoab", metad), ("tps_sweep", sweeps),
                      ("first_hitting_committor", shots),
                      ("basin_flux", flux), ("ffs_stage", stage),
                      ("run_we", we_iterations),
                      ("difftre_round", difftre_round),
                      ("cg_fg_md", md18(fg_pot, x18, 0.002, 2.0, 11)),
                      ("cg_schnet_md", md18(cg_pot, r18, 0.004, 1.0, 12))):
        got = scan._leaves(run())
        with scan.eager():
            want = scan._leaves(run())
        # q is NaN where no shot resolved: NaN must meet NaN.
        diffs[name] = max(
            float((g.double() - w.double()).abs().nan_to_num(0.0).max())
            if torch.equal(g.isnan(), w.isnan()) else math.inf
            for g, w in zip(got, want))
    print("scan_collect replay against the eager loop, largest "
          f"difference: {json.dumps(diffs)}", flush=True)
    fail_unless(all(d <= 1e-6 for d in diffs.values()),
                f"replay differs from the eager loop: {diffs}")
    RESULTS["scan_replay_max_diff"] = diffs
    return diffs


# ---------------------------------------------------------------------------
# Slice 13b: forward flux sampling, weighted ensembles, MSM / TICA and
# VAMPnets, every long Langevin loop replayed through md's shared runner,
# run_we and FFS's scans
# ---------------------------------------------------------------------------

# Examples 25 and 29 (their default depth; --full runs 128 walkers and
# 200 000 steps): walkers, steps, a frame every KN_COLLECT steps, the MSM
# lag in frames, kT; example 29's epochs and batch.
KN_WALKERS, KN_STEPS, KN_COLLECT, KN_LAG, KN_KT = 48, 80_000, 20, 10, 15.0
VN_EPOCHS, VN_BATCH = 12, 65_536
# Example 27 (default depth; --full 4000 iterations, 1024 x 200 000):
# WE iterations, brute-force walkers and steps.
WE_ITERS, WE_BF_WALKERS, WE_BF_STEPS = 1500, 384, 120_000
# Example 35 (default depth; --full 1024 x 60 000, 6000 flux steps, 2048
# trials, 3000 WE iterations): brute force, FFS, WE.
RE_BF_WALKERS, RE_BF_STEPS = 512, 40_000
RE_FLUX_STEPS, RE_MAX_STEPS, RE_TRIALS = 4000, 4000, 1024
RE_WE_ITERS = 1500


def kinetics_path(dev):
    """Examples 25 and 29 at their default depth, on one trajectory (both
    make the same one): KN_WALKERS Muller-Brown walkers, half from each end
    minimum, KN_STEPS BAOAB steps (dt 0.004, friction 5, kT 15) replayed
    through md's shared runner, a frame every KN_COLLECT steps.  Example
    25: TICA, the Voronoi MSM on the 7 x 7 grid below E = 150, stationary
    populations against Boltzmann quadrature, implied timescales at lags 10
    and 20, the A -> C committor and MFPT; its asserts: total-variation
    error under 0.12, timescale drift under 0.35, q(A) = 0 and q(C) = 1
    with interior values on both sides of 1/2, MFPT above 0, TICA's slow
    direction separating the basins.  Example 29: the VAMPnet (2 -> 64 ->
    64 -> 3 gelu, softmax) trained VN_EPOCHS epochs at batch VN_BATCH, lr
    3e-3, through train.fit; its asserts: its VAMP-2 score above TICA's
    less 0.01, its slowest timescale within 35% of the MSM's, a linear
    probe on its memberships above 0.9 accuracy."""
    from vaemolsim_tpu_torch import msm, vamp
    pot = muller_brown(dev)
    gen = torch.Generator(device=dev).manual_seed(25)
    min_a = torch.tensor([-0.558, 1.442], device=dev)
    min_c = torch.tensor([0.623, 0.028], device=dev)
    half = KN_WALKERS // 2
    x0 = torch.cat([min_a.expand(half, 1, 2),
                    min_c.expand(KN_WALKERS - half, 1, 2)]).contiguous()
    dyn = md._BAOAB(pot, dt=0.004, kt=KN_KT, friction=5.0, masses=1.0)
    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    traj = dyn.run(x0, torch.zeros_like(x0), KN_STEPS, gen,
                   collect_v=False, collect_every=KN_COLLECT)
    sync(dev)
    traj_wall = time.perf_counter() - t0
    frames = traj[..., 0, :].movedim(0, 1).contiguous()   # (W, T, 2)
    flat = frames.reshape(-1, 2)

    # Example 25.
    t1 = time.perf_counter()
    _, comps, _ = msm.tica(frames, lag=KN_LAG)
    mean = flat.mean(0)
    proj_a = float((min_a - mean) @ comps[:, 0])
    proj_c = float((min_c - mean) @ comps[:, 0])
    g = torch.linspace(-1.4, 1.0, 7, device=dev)
    gy = torch.linspace(-0.3, 1.9, 7, device=dev)
    grid = torch.stack(torch.meshgrid(g, gy, indexing="xy"), -1).reshape(
        -1, 2)
    centers = grid[pot(grid[:, None, :]) < 150.0]
    n_states = centers.shape[0]
    d = msm.assign_states(frames, centers)
    T = msm.transition_matrix(msm.count_matrix(d, n_states, lag=KN_LAG))
    pi = msm.stationary_distribution(T)
    qx = torch.linspace(-1.8, 1.4, 400, device=dev)
    qy = torch.linspace(-0.7, 2.3, 400, device=dev)
    pts = torch.stack(torch.meshgrid(qx, qy, indexing="xy"), -1).reshape(
        -1, 2)
    e = pot(pts[:, None, :]).double().cpu().numpy()
    w = np.exp(-(e - e.min()) / KN_KT)
    lbl = msm.assign_states(pts, centers).cpu().numpy()
    pi_quad = np.bincount(lbl, weights=w, minlength=n_states)
    pi_quad /= pi_quad.sum()
    state_a = int(msm.assign_states(min_a[None], centers)[0])
    state_c = int(msm.assign_states(min_c[None], centers)[0])
    tv = float(np.abs(pi.double().cpu().numpy() - pi_quad).sum()) / 2.0
    t_lag1 = float(msm.implied_timescales(T, lag=KN_LAG)[0])
    T2 = msm.transition_matrix(msm.count_matrix(d, n_states,
                                                lag=2 * KN_LAG))
    t_lag2 = float(msm.implied_timescales(T2, lag=2 * KN_LAG)[0])
    drift = abs(t_lag1 - t_lag2) / t_lag1
    q = msm.committor(T, [state_a], [state_c]).cpu().numpy()
    mfpt = float(msm.mean_first_passage_time(
        T, [state_c], lag=KN_LAG * KN_COLLECT)[state_a])
    interior = q[(q > 0) & (q < 1)]
    sync(dev)
    msm_wall = time.perf_counter() - t1

    # Example 29.
    t2 = time.perf_counter()
    mu, sd = flat.mean(0), flat.std(0, correction=0)
    x0p, xtp = vamp.lagged_pairs((frames - mu) / sd, lag=KN_LAG)
    net = vamp.VAMPNet.create(gen, 2, 3, hidden_dims=(64, 64), device=dev)
    net, hist = fit(net, lambda m, b, g_: m.loss(*b), (x0p, xtp),
                    generator=gen, num_epochs=VN_EPOCHS, batch_size=VN_BATCH,
                    learning_rate=3e-3, scan_epochs=True)
    score_net = -float(hist["loss"][-1])
    with torch.no_grad():
        tproj = ((flat - mean) @ comps).reshape(KN_WALKERS, -1, 2)
        score_tica = float(vamp.vamp_score(*vamp.lagged_pairs(tproj,
                                                               KN_LAG)))
        sv = net.singular_values(x0p, xtp)
        ts_net = float(vamp.vamp_timescales(sv, KN_LAG)[0])
        label = (((flat - min_c) ** 2).sum(-1)
                 < ((flat - min_a) ** 2).sum(-1)).long().cpu().numpy()
        chi = net((flat - mu) / sd).double().cpu().numpy()
    chi_aug = np.concatenate([chi, np.ones((len(chi), 1))], -1)
    coef, *_ = np.linalg.lstsq(chi_aug, np.eye(2)[label], rcond=None)
    acc = float(np.mean((chi_aug @ coef).argmax(-1) == label))
    sync(dev)
    vamp_wall = time.perf_counter() - t2
    counts = path_counts("kinetics")
    print(f"examples 25 / 29: {KN_WALKERS} walkers x {frames.shape[1]} "
          f"frames in {traj_wall:.3f} s; TICA basins A {proj_a:+.3f} C "
          f"{proj_c:+.3f}; {n_states} states, stationary TV error "
          f"{tv:.4f}; t2 lag {KN_LAG} {t_lag1:.2f} lag {2 * KN_LAG} "
          f"{t_lag2:.2f} (drift {drift:.4f}); q(A) {q[state_a]:.3f} q(C) "
          f"{q[state_c]:.3f}, MFPT {mfpt:.1f} steps; VAMP-2 net "
          f"{score_net:.4f} vs TICA {score_tica:.4f}; slowest timescale "
          f"net {ts_net:.2f} vs MSM {t_lag1:.2f} frames; probe accuracy "
          f"{acc:.4f} (MSM {msm_wall:.3f} s, VAMPnet {vamp_wall:.3f} s)",
          flush=True)
    fail_unless(proj_a * proj_c < 0, f"example 25: TICA {proj_a} {proj_c}")
    fail_unless(tv < 0.12, f"example 25: stationary TV error {tv}")
    fail_unless(drift < 0.35, f"example 25: timescales {t_lag1} {t_lag2}")
    fail_unless(q[state_a] == 0.0 and q[state_c] == 1.0,
                f"example 25: committor ends {q[state_a]} {q[state_c]}")
    fail_unless(interior.size > 0 and (interior > 0.5).any()
                and (interior < 0.5).any(),
                f"example 25: committor interior {interior}")
    fail_unless(mfpt > 0, f"example 25: MFPT {mfpt}")
    fail_unless(score_net > score_tica - 0.01,
                f"example 29: VAMP-2 {score_net} vs TICA {score_tica}")
    fail_unless(abs(ts_net - t_lag1) / t_lag1 < 0.35,
                f"example 29: timescale {ts_net} vs MSM {t_lag1}")
    fail_unless(acc > 0.9, f"example 29: probe accuracy {acc}")
    return replay_row(
        "kinetics_ex25_ex29", traj_wall, KN_STEPS, KN_STEPS / traj_wall,
        "steps/s", counts,
        lambda: dyn.run(x0, torch.zeros_like(x0), 200, gen, False, 20), 200,
        lambda: dyn.run(x0, torch.zeros_like(x0), 200, gen, False, 20), 200,
        dev, walkers=KN_WALKERS, stationary_tv=tv, timescale_lag10=t_lag1,
        timescale_lag20=t_lag2, mfpt=mfpt, tica_a=proj_a, tica_c=proj_c,
        vamp2_net=score_net, vamp2_tica=score_tica, timescale_net=ts_net,
        probe_accuracy=acc, msm_seconds=msm_wall, vamp_seconds=vamp_wall)


def we_parts(dyn, edges, seg, n_bins, m, dev):
    """A WE step whose segment is ``seg`` BAOAB steps through md's shared
    runner (velocities kept in the walker), binned by ``searchsorted`` on
    ``edges`` and recycled at the last bin to x = -1 at rest."""
    from vaemolsim_tpu_torch import we

    def propagate(walk, g):
        s, _ = dyn.scan(dyn.start(*walk), seg, g)
        return (s.x, s.v)

    def bin_fn(walk):
        return torch.searchsorted(edges, walk[0][..., 0, 0].contiguous())

    def recycle(walk):
        return (torch.full_like(walk[0], -1.0), torch.zeros_like(walk[1]))

    return we.make_we_step(propagate, bin_fn, n_bins=n_bins, m_per_bin=m,
                           target_bin=n_bins - 1, recycle_fn=recycle), bin_fn


def first_passage(hit, censor):
    """Per walker (the second axis of ``hit``, frames first): the first
    frame where ``hit`` holds, or ``censor`` where none does; and whether
    one does."""
    arrived = hit.any(0)
    first = torch.where(arrived, hit.int().argmax(0), censor)
    return first.cpu().numpy(), arrived.cpu().numpy()


def weighted_ensemble_path(dev):
    """Example 27 at its default depth: the double well 5.5 (q^2 - 1)^2 at
    kT 1, 20 bins x 8 walkers, 10-step BAOAB segments (dt 0.01, friction
    2) through md's shared runner, WE_ITERS iterations by run_we (a third
    burn-in), then brute force over WE_BF_WALKERS walkers x WE_BF_STEPS
    steps (a frame every 50); the example's asserts: total weight within
    1e-3 of 1, at least 12 bins above 1e-8 weight, the WE rate within 2.5x
    of the brute-force 1/MFPT."""
    from vaemolsim_tpu_torch import we
    n_bins, m, seg, dt = 20, 8, 10, 0.01
    dyn = md._BAOAB(_well(5.5), dt=dt, kt=1.0, friction=2.0,
                    masses=1.0)
    edges = torch.linspace(-1.3, 1.05, n_bins - 1, device=dev)
    step, bin_fn = we_parts(dyn, edges, seg, n_bins, m, dev)
    gen = torch.Generator(device=dev).manual_seed(27)
    x0 = -torch.ones(m, 1, 1, device=dev)
    v0 = torch.randn(m, 1, 1, generator=gen, device=dev)
    state = we.we_init((x0, v0), n_bins, m)
    burn = WE_ITERS // 3
    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    state, _ = we.run_we(step, state, gen, burn)
    f0, n0 = float(state.flux), int(state.n_iters)
    state, _ = we.run_we(step, state, gen, WE_ITERS - burn)
    sync(dev)
    we_wall = time.perf_counter() - t0
    rate_we = (float(state.flux) - f0) / ((int(state.n_iters) - n0)
                                          * seg * dt)
    w_sum = float(state.w.sum())
    b = bin_fn(state.x).cpu().numpy()
    wv = state.w.cpu().numpy()
    prof = np.array([wv[b == i].sum() for i in range(n_bins)])
    populated = int((prof > 1e-8).sum())
    t1 = time.perf_counter()
    xb = -torch.ones(WE_BF_WALKERS, 1, 1, device=dev)
    traj = dyn.run(xb, torch.zeros_like(xb), WE_BF_STEPS, gen,
                   collect_v=False, collect_every=50)
    sync(dev)
    bf_wall = time.perf_counter() - t1
    q = traj[..., 0, 0]
    first, crossed = first_passage(q > 1.05, -1)
    times = first[crossed] * 50 * dt
    t_tot = WE_BF_STEPS * dt
    mfpt = (times.sum() + (~crossed).sum() * t_tot) / max(crossed.sum(), 1)
    rate_bf = 1.0 / mfpt
    ratio = rate_we / rate_bf
    counts = path_counts("weighted_ensemble")
    print(f"example 27: WE weight sum {w_sum:.6f}, {populated}/{n_bins} bins"
          f" populated, rate {rate_we:.4e} over {WE_ITERS} iterations "
          f"({we_wall:.3f} s); brute force {crossed.mean():.3f} of "
          f"{WE_BF_WALKERS} crossed, MFPT {mfpt:.2f}, rate {rate_bf:.4e} "
          f"({bf_wall:.3f} s); ratio {ratio:.4f}", flush=True)
    fail_unless(abs(w_sum - 1.0) < 1e-3, f"example 27: weight {w_sum}")
    fail_unless(populated >= 12, f"example 27: {populated} bins populated")
    fail_unless(1 / 2.5 < ratio < 2.5, f"example 27: rate ratio {ratio}")
    return replay_row(
        "weighted_ensemble_ex27", we_wall, WE_ITERS * seg,
        WE_ITERS / we_wall, "iterations/s", counts,
        lambda: we.run_we(step, state, gen, 20), 20 * seg,
        lambda: we.run_we(step, state, gen, 20), 20 * seg, dev,
        weight_sum=w_sum, bins_populated=populated, rate_we=rate_we,
        rate_brute_force=rate_bf, ratio=ratio,
        brute_force_seconds=bf_wall,
        brute_force_steps_per_s=WE_BF_STEPS / bf_wall)


def rare_event_path(dev):
    """Example 35 at its default depth: one escape rate over a 5 kT barrier
    (2 (q^2 - 1)^2 at kT 0.4, friction 1, dt 0.01) four ways: brute force
    over RE_BF_WALKERS x RE_BF_STEPS (first arrivals at q >= 1, censored),
    FFS over the interfaces (-0.6, -0.2, 0.2, 0.6, 1.0) from 256 replicas
    (RE_FLUX_STEPS flux steps, RE_TRIALS trials of up to RE_MAX_STEPS
    steps a stage), WE with 10 bins x 24 walkers and 20-step segments
    (RE_WE_ITERS iterations after a third as many of relaxation), and
    Kramers-corrected harmonic TST; the example's asserts: every estimate
    within (0.35, 2.8) of brute force, TST at least 0.8 of it."""
    from vaemolsim_tpu_torch import mcmc, paths, we
    h, kt, friction, dt = 2.0, 0.4, 1.0, 0.01
    pot = _well(h)
    dyn = md._BAOAB(pot, dt=dt, kt=kt, friction=friction, masses=1.0)
    gen = torch.Generator(device=dev).manual_seed(35)

    def left_well(r):
        x = -1.0 + 0.1 * torch.randn(r, 1, 1, generator=gen, device=dev)
        v = math.sqrt(kt) * torch.randn(r, 1, 1, generator=gen, device=dev)
        s, _ = dyn.scan(dyn.start(x, v), 500, gen)
        return s.x, s.v

    _build.reset_launches()
    sync(dev)
    t0 = time.perf_counter()
    x0, v0 = left_well(RE_BF_WALKERS)
    traj = dyn.run(x0, v0, RE_BF_STEPS, gen, collect_v=False,
                   collect_every=10)
    q = traj[..., 0, 0]
    first, hit = first_passage(q >= 1.0, q.shape[0])
    k_bf = int(hit.sum()) / (float(first.sum()) * 10 * dt)
    sync(dev)
    bf_wall = time.perf_counter() - t0

    t1 = time.perf_counter()
    x0, v0 = left_well(256)
    res = mcmc.run_ffs(pot, _first_coordinate, x0, v0, gen,
                       interfaces=[-0.6, -0.2, 0.2, 0.6, 1.0], dt=dt, kT=kt,
                       flux_steps=RE_FLUX_STEPS, max_steps=RE_MAX_STEPS,
                       friction=friction, n_trials=RE_TRIALS)
    k_ffs = float(res.rate)
    sync(dev)
    ffs_wall = time.perf_counter() - t1

    t2 = time.perf_counter()
    n_bins, m, seg = 10, 24, 20
    step, _ = we_parts(dyn, torch.linspace(-1.4, 1.0, n_bins - 1,
                                           device=dev), seg, n_bins, m, dev)
    state = we.we_init(left_well(64), n_bins, m)
    state, _ = we.run_we(step, state, gen, RE_WE_ITERS // 3)
    f0, n0 = float(state.flux), int(state.n_iters)
    state, _ = we.run_we(step, state, gen, RE_WE_ITERS)
    k_we = (float(state.flux) - f0) / (int(state.n_iters) - n0) / (seg * dt)
    sync(dev)
    we_wall = time.perf_counter() - t2

    k_tst = float(paths.harmonic_tst_rate(
        pot, torch.tensor([[-1.0]], device=dev),
        torch.tensor([[0.0]], device=dev), kt=kt))
    g = friction / (2.0 * math.sqrt(4.0 * h))
    kappa = math.sqrt(1.0 + g * g) - g
    k_kr = kappa * k_tst
    counts = path_counts("rare_event")
    ratios = {"FFS": k_ffs / k_bf, "WE": k_we / k_bf,
              "Kramers-TST": k_kr / k_bf}
    print(f"example 35: brute force {k_bf:.4e} ({int(hit.sum())} events, "
          f"{bf_wall:.3f} s); FFS {k_ffs:.4e} (flux {float(res.flux):.4f}, "
          f"p {np.round(res.p_stages.cpu().numpy(), 4).tolist()}, "
          f"unresolved {res.n_unresolved.tolist()}, {ffs_wall:.3f} s); WE "
          f"{k_we:.4e} ({we_wall:.3f} s); Kramers-TST {k_kr:.4e} (TST "
          f"{k_tst:.4e} x {kappa:.4f}); ratios "
          f"{json.dumps({k: round(v, 4) for k, v in ratios.items()})}",
          flush=True)
    for name, ratio in ratios.items():
        fail_unless(0.35 < ratio < 2.8,
                    f"example 35: {name} / brute force {ratio}")
    fail_unless(k_tst >= 0.8 * k_bf, f"example 35: TST {k_tst} < 0.8 x "
                f"brute force {k_bf}")
    ffs_steps = RE_FLUX_STEPS + 4 * RE_MAX_STEPS
    return replay_row(
        "rare_event_ex35", bf_wall, RE_BF_STEPS, RE_BF_STEPS / bf_wall,
        "steps/s", counts,
        lambda: dyn.run(x0, v0, 200, gen, False, 10), 200,
        lambda: dyn.run(x0, v0, 200, gen, False, 10), 200, dev,
        rate_brute_force=k_bf, rate_ffs=k_ffs, rate_we=k_we,
        rate_kramers_tst=k_kr, rate_tst=k_tst, ratios=ratios,
        ffs_p_stages=res.p_stages.tolist(), ffs_seconds=ffs_wall,
        ffs_steps_per_s=ffs_steps / ffs_wall, we_seconds=we_wall,
        we_iterations_per_s=(RE_WE_ITERS * 4 // 3) / we_wall)


# ---------------------------------------------------------------------------
# Slice 13c: DiffTRe (example 31) and CG force matching / relative entropy
# (example 18), their MD replayed through md's shared runner
# ---------------------------------------------------------------------------

# Example 31 (its default depth; --full 14 rounds of 25 inner steps and
# 1000 MD steps a round): particles, chains, reference chains, rounds,
# inner steps a round, MD steps a round, reference MD steps.
DT_N, DT_CHAINS, DT_REF_CHAINS = 16, 24, 32
DT_OUTER, DT_INNER, DT_MD_STEPS, DT_REF_STEPS = 10, 20, 600, 3000
DT_RHO, DT_KT, DT_CUT, DT_BINS = 0.65, 0.85, 2.2, 24
# Example 31's own asserts (|epsilon - 1| < 0.2, |sigma - 1| < 0.05, max
# |dg| < 0.35) hold in the JAX package at 10 of 24 seeds of its default
# depth: the fit settles either near (1, 1) or at epsilon 0.49-0.73, sigma
# 0.87-0.97 (tools/difftre_seed_spread.py).  Across the 24 seeds epsilon
# spans 0.489-0.967, sigma 0.870-1.010, max |dg| reaches 1.735 and the
# loss ratio stays below 0.056.  The phase holds that envelope (sigma's
# excludes the start, 1.12) and the example's loss ratio.
DT_EPS_RANGE, DT_SIGMA_RANGE, DT_DG_MAX = (0.45, 1.2), (0.85, 1.05), 1.8
# Example 18 (--full width; its default depths, --full 12 000 FG and CG
# steps and 1500 training steps): replicas, FG MD steps, force-matching
# steps, CG MD steps; molecules, atoms a molecule, site density.
CG_REP, CG_FG_STEPS, CG_TRAIN, CG_CG_STEPS = 48, 5000, 800, 5000
CG_M, CG_APM, CG_RHO = 12, 3, 0.25


def lj31(dev):
    """Example 31's LJ fluid (16 particles at density 0.65, cutoff 2.2):
    its box, ``make_pot(params[, box])`` of ``{log_eps, log_sigma}``,
    per-frame g(r) bins (DT_BINS to half the box), the per-frame virial
    pressure at kT 0.85, and the bins' centres."""
    from vaemolsim_tpu_torch import observables
    L = (DT_N / DT_RHO) ** (1.0 / 3.0)
    box = torch.full((3,), L, device=dev)
    edges = torch.linspace(0.0, L / 2.0, DT_BINS + 1, device=dev)
    shell = (4.0 / 3.0) * math.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    rho_pairs = DT_N * (DT_N - 1) / 2.0 / L ** 3
    triu = torch.ones(DT_N, DT_N, dtype=torch.bool, device=dev).triu(1)

    def make_pot(p, b=box):
        return potentials.lennard_jones(
            sigma=torch.exp(p["log_sigma"]), epsilon=torch.exp(p["log_eps"]),
            box=b, cutoff=DT_CUT, device=dev)

    def frame_rdf(frames):
        d = frames[..., :, None, :] - frames[..., None, :, :]
        d = d - L * torch.round(d / L)
        r = torch.sqrt((d * d).sum(-1).clamp_min(1e-12))
        ind = ((r[..., None] >= edges[:-1]) & (r[..., None] < edges[1:])
               & triu[..., None])
        return ind.sum((-3, -2)).float() / (rho_pairs * shell)

    def frame_pressure(p, frames):
        return observables.virial_pressure(lambda b: make_pot(p, b), frames,
                                           box=box, kt=DT_KT)

    return make_pot, frame_rdf, frame_pressure, 0.5 * (edges[:-1]
                                                      + edges[1:])


def lj31_md(make_pot, p):
    """Example 31's Langevin dynamics (dt 0.003, friction 1, kT 0.85) on
    the potential of ``p``, through md's shared replayed runner."""
    return md._BAOAB(make_pot(p), dt=0.003, kt=DT_KT, friction=1.0,
                     masses=1.0)


def log_params(eps, sigma, dev):
    return {"log_eps": torch.full((), math.log(eps), device=dev),
            "log_sigma": torch.full((), math.log(sigma), device=dev)}


def example_31(dev, seed=31):
    """Example 31 at its default depth, its generator seeded by ``seed``: a
    reference LJ fluid at (epsilon, sigma) = (1, 1) (DT_REF_CHAINS chains,
    DT_REF_STEPS BAOAB steps, a frame every 100 after 1000) gives the
    target g(r) and virial pressure; difftre_fit recovers the parameters
    from (0.6, 1.12): DT_OUTER rounds of DT_MD_STEPS MD steps over
    DT_CHAINS warm-started chains (a frame every 25, the first third
    dropped), up to DT_INNER Adam steps (lr 0.05) a round until the ESS
    falls below 0.4 n, the RDF a static observable, the pressure's
    parameter gradient reverse over forward through
    ``observables.virial_pressure``.  Every MD run goes through md's shared
    runner (one capture a run).  Returns the results, and ``rerun(steps)``:
    that many MD steps of the fitted potential from the warm start."""
    from vaemolsim_tpu_torch import difftre
    make_pot, frame_rdf, frame_pressure, centres = lj31(dev)
    L = (DT_N / DT_RHO) ** (1.0 / 3.0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    md_wall = [0.0]

    def run_md(p, x0, steps):
        dyn = lj31_md(make_pot, p)
        sync(dev)
        t = time.perf_counter()
        s, traj = dyn.scan(dyn.start(x0, torch.zeros_like(x0)), steps, gen,
                           collect_every=25, snapshot_fn=lambda st: st.x)
        sync(dev)
        md_wall[0] += time.perf_counter() - t
        return s, traj

    true = log_params(1.0, 1.0, dev)
    x0 = L * torch.rand(DT_REF_CHAINS, DT_N, 3, generator=gen, device=dev)
    x0 = potentials.minimize_energy(make_pot(true), x0, steps=300, lr=0.05)
    _, traj = run_md(true, x0, DT_REF_STEPS)
    ref = traj[43::4].reshape(-1, DT_N, 3)    # every 100th step after 1000
    g_target = frame_rdf(ref).mean(0)
    p_target = float(frame_pressure(true, ref).mean())
    params = log_params(0.6, 1.12, dev)
    x_warm = potentials.minimize_energy(
        make_pot(params),
        L * torch.rand(DT_CHAINS, DT_N, 3, generator=gen, device=dev),
        steps=300, lr=0.05)

    def frames_of(traj):
        return traj[traj.shape[0] // 3:].reshape(-1, DT_N, 3)

    def sample_fn(p, g, state):
        s, traj = run_md(p, x_warm if state is None else state,
                         DT_MD_STEPS)
        return frames_of(traj), s.x

    md_before = md_wall[0]
    sync(dev)
    t0 = time.perf_counter()
    res = difftre.difftre_fit(
        lambda p, f: make_pot(p)(f), params, sample_fn=sample_fn,
        observable_fns={"rdf": difftre.static_observable(frame_rdf),
                        "pressure": frame_pressure},
        targets={"rdf": g_target, "pressure": p_target},
        weights={"rdf": 1.0, "pressure": 1.0}, beta=1.0 / DT_KT,
        generator=gen, n_outer=DT_OUTER, inner_steps=DT_INNER,
        ess_frac=0.4, learning_rate=0.05)
    sync(dev)
    fit_wall = time.perf_counter() - t0
    inner = res.history["inner_steps"]
    _, traj = run_md(res.params, x_warm, DT_MD_STEPS)
    frames_fit = frames_of(traj)
    g_fit = frame_rdf(frames_fit).mean(0)
    out = dict(
        epsilon=float(torch.exp(res.params["log_eps"])),
        sigma=float(torch.exp(res.params["log_sigma"])),
        fresh_losses=res.history["loss"], inner_steps=inner,
        ess_end=res.history["ess_end"], reference_frames=ref.shape[0],
        pressure_target=p_target, g_peak=float(g_target.max()),
        pressure_fit=float(frame_pressure(res.params, frames_fit).mean()),
        max_dg=float((g_fit - g_target).abs()[centres > 0.85].max()),
        md_seconds=md_wall[0],
        md_steps=DT_REF_STEPS + (DT_OUTER + 1) * DT_MD_STEPS,
        fit_seconds=fit_wall,
        ms_per_inner_step=1e3 * (fit_wall - (md_wall[0] - md_before))
        / sum(inner))
    return out, lambda steps: run_md(res.params, x_warm, steps)


def difftre_path(dev):
    """Example 31 (``example_31``) with the example's loss assert (the
    last fresh loss under a tenth of the first) and, where the example's
    other asserts are seed-fragile in the JAX package itself, what that
    package holds across seeds: epsilon in DT_EPS_RANGE, sigma in
    DT_SIGMA_RANGE, the fitted potential's g(r) within DT_DG_MAX of the
    target beyond r = 0.85; whether the example's own asserts held is
    printed.  Its MD replayed against eager."""
    _build.reset_launches()
    out, rerun = example_31(dev)
    counts = path_counts("difftre")
    eps, sig, losses = out["epsilon"], out["sigma"], out["fresh_losses"]
    print(f"example 31: reference {out['reference_frames']} frames, P "
          f"{out['pressure_target']:.3f}, g(r) peak {out['g_peak']:.2f}; "
          f"fresh losses {[round(v, 4) for v in losses]}, inner steps "
          f"{out['inner_steps']}, ESS at stop "
          f"{[round(v) for v in out['ess_end']]}; fitted epsilon {eps:.3f} "
          f"sigma {sig:.3f}; fitted ensemble P {out['pressure_fit']:.3f}, "
          f"max |dg| {out['max_dg']:.3f}; {out['ms_per_inner_step']:.3f} ms "
          f"a DiffTRe inner step (the fit's wall less its MD, over "
          f"{sum(out['inner_steps'])} steps)", flush=True)
    own = (abs(eps - 1.0) < 0.2 and abs(sig - 1.0) < 0.05
           and out["max_dg"] < 0.35)
    print(f"example 31: the example's own epsilon, sigma and g(r) asserts "
          f"{'hold' if own else 'do not hold'} at this seed (the JAX "
          f"package's hold at 10 of 24)", flush=True)
    fail_unless(DT_EPS_RANGE[0] < eps < DT_EPS_RANGE[1],
                f"example 31: epsilon {eps}")
    fail_unless(DT_SIGMA_RANGE[0] < sig < DT_SIGMA_RANGE[1],
                f"example 31: sigma {sig}")
    fail_unless(losses[-1] < 0.1 * losses[0],
                f"example 31: fresh loss {losses[0]} -> {losses[-1]}")
    fail_unless(out["max_dg"] < DT_DG_MAX, f"example 31: max |dg| "
                f"{out['max_dg']}")
    md_s, md_steps = out["md_seconds"], out["md_steps"]
    return replay_row(
        "difftre_ex31", md_s, md_steps, md_steps / md_s, "MD steps/s",
        counts, lambda: rerun(100), 100, lambda: rerun(300), 250, dev,
        skip=1, own_asserts_hold=own, **out)


def cg_system(dev):
    """Example 18's atomistic system: CG_M bonded trimers (harmonic bonds k
    200, r0 0.5) with intermolecular LJ (cutoff 2.5, 1-2 and 1-3 pairs
    excluded) in a periodic box at site density CG_RHO: the potential and
    the box edge."""
    n = CG_M * CG_APM
    L = (CG_M / CG_RHO) ** (1.0 / 3.0)
    bonds = np.concatenate([np.array([[0, 1], [1, 2]]) + CG_APM * m
                            for m in range(CG_M)])
    excl = potentials.exclusions_from_bonds(n, bonds, through_angles=True)
    pot = potentials.composite(
        potentials.harmonic_bonds(bonds, k=200.0, r0=0.5, device=dev),
        potentials.lennard_jones(box=torch.full((3,), L, device=dev),
                                 cutoff=2.5, exclude=excl, device=dev))
    return pot, L


def cg_path(dev):
    """Example 18 at its --full width (CG_REP replicas) and default depths:
    CG_FG_STEPS BAOAB steps of the trimer fluid (dt 0.002, friction 2; a
    frame every 100, the second half kept) with forces per frame; the
    centre-of-mass map and the summed-force map to 12 sites; a SchNet
    potential (32 features, 2 blocks, 24 RBFs, cutoff 2.5) trained by
    cg.force_matching_loss for CG_TRAIN Adam steps at batch 48 under the
    example's cosine decay from 3e-3 (a LambdaLR); CG_CG_STEPS BAOAB steps
    (dt 0.004) on the learned potential, frozen.  The FG and CG MD go
    through md's shared runner.  The example's asserts: the validation
    residual below 0.9 of its start, the held-out force correlation above
    0.3, the CG g(r) within 0.4 of the mapped FG g(r) beyond r = 0.7.  Then
    tests/test_cg.py's rel_entropy_fit (20 000 mapped and 8192 CG frames a
    round, 12 rounds of up to 40 steps) with that test's asserts."""
    from vaemolsim_tpu_torch import cg, observables
    from vaemolsim_tpu_torch.nn.mappings import CGCenterOfMass
    M, A = CG_M, CG_APM
    n = M * A
    fg_pot, L = cg_system(dev)
    box = torch.full((3,), L, device=dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    _build.reset_launches()
    com0 = L * torch.rand(CG_REP, M, 1, 3, generator=gen, device=dev)
    offs = 0.4 * torch.randn(CG_REP, M, A, 3, generator=gen, device=dev)
    x0 = potentials.minimize_energy(fg_pot, (com0 + offs).reshape(
        CG_REP, n, 3), steps=500, lr=0.02)
    fg = md._BAOAB(fg_pot, dt=0.002, kt=1.0, friction=2.0, masses=1.0)
    sync(dev)
    t0 = time.perf_counter()
    traj = fg.run(x0, torch.zeros_like(x0), CG_FG_STEPS, gen,
                  collect_v=False, collect_every=100)
    sync(dev)
    fg_wall = time.perf_counter() - t0
    frames = traj[traj.shape[0] // 2:].reshape(-1, n, 3)
    _, forces = md._force_fn(fg_pot)(frames)
    com = CGCenterOfMass.create([A] * M, np.ones(n), device=dev)
    agg = cg.force_aggregation_matrix([A] * M, device=dev)
    R = com(frames)
    F_cg = cg.map_forces(agg, forces)
    r_grid, g_fg = observables.radial_distribution(R, box=[L] * 3,
                                                   n_bins=36)

    sp = torch.ones(M, 1, device=dev)
    model = SchNetPotential.create(gen, 1, features=32, num_blocks=2,
                                   n_rbf=24, cutoff=2.5, device=dev)
    n_train = int(0.9 * R.shape[0])
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    # optax.cosine_decay_schedule(3e-3, CG_TRAIN) at the count of updates
    # already taken.
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda k: 0.5 * (
        1.0 + math.cos(math.pi * min(k, CG_TRAIN) / CG_TRAIN)))

    def val():
        with torch.no_grad():
            return float(cg.force_matching_loss(model, R[n_train:], sp,
                                                F_cg[n_train:], box=box))

    v0 = val()
    losses = []
    sync(dev)
    t1 = time.perf_counter()
    for _ in range(CG_TRAIN):
        idx = torch.randperm(n_train, generator=gen, device=dev)[:48]
        loss = cg.force_matching_loss(model, R[idx], sp, F_cg[idx], box=box)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())
    sync(dev)
    train_wall = time.perf_counter() - t1
    v1 = val()
    rv = R[n_train:].detach().requires_grad_(True)
    (g,) = torch.autograd.grad(model(rv, sp, box).sum(), rv)
    a = (-g).double().cpu().numpy().ravel()
    b = F_cg[n_train:].double().cpu().numpy().ravel()
    corr = float(np.corrcoef(a, b)[0, 1])

    for p in model.parameters():
        p.requires_grad_(False)
    cg_md = md._BAOAB(model.as_potential(sp, box=box), dt=0.004, kt=1.0,
                      friction=1.0, masses=1.0)
    r0 = R[torch.arange(CG_REP, device=dev) % R.shape[0]].contiguous()
    sync(dev)
    t2 = time.perf_counter()
    cg_traj = cg_md.run(r0, torch.zeros_like(r0), CG_CG_STEPS, gen,
                        collect_v=False, collect_every=100)
    sync(dev)
    cg_wall = time.perf_counter() - t2
    _, g_cg = observables.radial_distribution(
        cg_traj[cg_traj.shape[0] // 2:], box=[L] * 3, n_bins=36)
    gr_err = float((g_cg - g_fg).abs()[r_grid > 0.7].max())
    i_pk = int(g_fg.argmax())

    # tests/test_cg.py::test_fit_recovers_variance_matching_optimum.
    sigma_m, theta0 = 0.7, 0.4
    mapped = sigma_m * torch.randn(20_000, 1, generator=gen, device=dev)

    def quad(theta, f):
        return 0.5 * theta * (f ** 2).sum(-1)

    def sample(theta, g_, state):
        return (torch.randn(8192, 1, generator=g_, device=dev)
                / torch.sqrt(theta)), state

    t3 = time.perf_counter()
    rel = cg.rel_entropy_fit(quad, torch.full((), theta0, device=dev),
                             mapped_frames=mapped, sample_fn=sample,
                             beta=1.0, generator=gen, n_outer=12,
                             inner_steps=40, learning_rate=0.05)
    rel_wall = time.perf_counter() - t3
    theta_star = 1.0 / sigma_m ** 2
    theta = float(rel.params)
    hist = rel.loss_history.cpu().numpy()
    expect = 0.5 + 0.5 * math.log(sigma_m ** 2 * theta0)
    counts = path_counts("cg_force_matching")
    print(f"example 18: {frames.shape[0]} FG frames ({fg_wall:.3f} s), "
          f"validation residual {v0:.3f} -> {v1:.3f}, train loss "
          f"{float(losses[0]):.3f} -> {float(losses[-1]):.3f} "
          f"({1e3 * train_wall / CG_TRAIN:.3f} ms a force-matching step), "
          f"force correlation {corr:.3f}; CG g(r) peak mapped-FG "
          f"{float(g_fg[i_pk]):.3f} at r {float(r_grid[i_pk]):.3f}, CG-MD "
          f"{float(g_cg[i_pk]):.3f}, max |dg| {gr_err:.3f} ({cg_wall:.3f} "
          f"s); rel_entropy_fit theta {theta:.4f} against {theta_star:.4f}, "
          f"last loss {hist[-1]:.4f} against {expect:.4f} ({rel_wall:.3f} "
          f"s)", flush=True)
    fail_unless(v1 < 0.9 * v0, f"example 18: validation {v0} -> {v1}")
    fail_unless(corr > 0.3, f"example 18: force correlation {corr}")
    fail_unless(gr_err < 0.4, f"example 18: max |dg| {gr_err}")
    fail_unless(abs(theta - theta_star) / theta_star < 0.03,
                f"rel_entropy_fit: theta {theta} against {theta_star}")
    fail_unless(hist.shape == (12,) and abs(hist[-1] - expect) < 0.02
                and bool(np.all(np.diff(hist) < 0.02)),
                f"rel_entropy_fit: loss history {hist} (expected end "
                f"{expect})")
    fail_unless(bool((rel.ess_history <= 8192.0 + 1e-3).all()),
                f"rel_entropy_fit: ESS {rel.ess_history}")
    replay_row("cg_md_ex18", cg_wall, CG_CG_STEPS, CG_CG_STEPS / cg_wall,
               "steps/s", counts,
               lambda: cg_md.run(r0, torch.zeros_like(r0), 100, gen, False,
                                 50), 100,
               lambda: cg_md.run(r0, torch.zeros_like(r0), 300, gen, False,
                                 50), 250, dev, skip=1)
    return replay_row(
        "cg_fg_md_ex18", fg_wall, CG_FG_STEPS, CG_FG_STEPS / fg_wall,
        "steps/s", counts,
        lambda: fg.run(x0, torch.zeros_like(x0), 100, gen, False, 50), 100,
        lambda: fg.run(x0, torch.zeros_like(x0), 300, gen, False, 50), 250,
        dev, skip=1, validation=[v0, v1], force_correlation=corr,
        max_dg=gr_err, ms_per_force_matching_step=1e3 * train_wall
        / CG_TRAIN, train_seconds=train_wall, cg_md_seconds=cg_wall,
        rel_entropy_theta=theta, rel_entropy_last_loss=float(hist[-1]),
        rel_entropy_seconds=rel_wall)


# ---------------------------------------------------------------------------
# Slice 14a: score diffusion (example 28) on kernel 2, the PaiNN potential
# on md's shared replayed runner, and committee uncertainty
# ---------------------------------------------------------------------------

# Example 28 at its default depths but its epochs (--full: 65 536 points,
# 1000 epochs at batch 4096 with EMA 0.999, 20 000 evaluation points, 96
# ODE and 40 MH steps): training points, epochs (350, a depth cut of the
# example's default 500: PERF.md section 4), batch, EMA decay; evaluation
# points, RK4 / SDE steps, MH steps.
DF_TRAIN, DF_EPOCHS, DF_BATCH, DF_EMA = 16_384, 350, 2048, 0.998
DF_EVAL, DF_ODE, DF_MH = 4000, 48, 12
DF_CENTERS = ((-2.5, -1.0), (0.0, 2.0), (2.5, -1.0))
# Kernel 2's rows on the path: the DSM batch, the SDE's chains, the
# divergence's two stacked copies of the MH chains and of the 41 x 41 grid.
DF_ROWS = (DF_BATCH, DF_EVAL, 2 * DF_EVAL, 2 * 41 * 41)
# The committee: members, padding atoms of the masked pass, and the frames
# held against a CPU copy (each frame's statistics are its own).
UQ_K, UQ_PAD, UQ_CPU_FRAMES = 3, 4, 32
# PaiNN's replay against eager and its profiled replays: steps, a chunk.
PN_CHECK, PN_WINDOW, PN_CHUNK = 100, 100, 50


def ex28_target(dev):
    """Example 28's unequal 3-mode 2-D Gaussian mixture (0.5 / 0.3 /
    0.2)."""
    locs = torch.tensor(DF_CENTERS, device=dev)
    scales = torch.tensor([[0.45, 0.7], [0.6, 0.35], [0.5, 0.5]],
                          device=dev)
    logits = torch.log(torch.tensor([0.5, 0.3, 0.2], device=dev))
    return dist.MixtureSameFamily(
        logits, dist.Independent(dist.Normal(locs, scales), 1))


def mode_weights(x):
    """Each mode's share of the samples, a sample to its nearest centre."""
    centers = torch.tensor(DF_CENTERS, device=x.device)
    idx = ((x[:, None, :] - centers) ** 2).sum(-1).argmin(-1)
    return np.array([float((idx == k).float().mean()) for k in range(3)])


def check_diffusion_kernel(model, gen, dev):
    """Kernel 2 at example 28's noise net (11 -> 128 -> 128 -> 2, gelu in
    its tanh form, the trained net's weights) at the path's four row
    counts (``DF_ROWS``), against its plain version (1e-4 + 1e-4|y|); each
    timed by CUDA events against the plain version, which is the library
    chain (addmm, gelu, addmm, gelu, addmm), with its bound."""
    net = model.eps_net.net
    ks = [l.kernel.detach() for l in net.layers] + [net.head.kernel.detach()]
    bs = [l.bias.detach() for l in net.layers] + [net.head.bias.detach()]
    acts = [l.activation for l in net.layers] + [None]
    dims = [ks[0].shape[0]] + [k.shape[1] for k in ks]
    shape = "->".join(map(str, dims))
    for n in DF_ROWS:
        x = torch.randn(n, dims[0], generator=gen, device=dev)
        got = dense_stack_cuda(x, ks, bs, acts)
        want = dense_stack_plain(x, ks, bs, acts)
        err = compare(f"diffusion noise net {shape} N={n}", got, want, 1e-4,
                      1e-4)
        ms = timed(lambda: dense_stack_cuda(x, ks, bs, acts))
        plain_ms = timed(lambda: dense_stack_plain(x, ks, bs, acts))
        bound_us, bound_by = stack_bound(n, ks, bs)
        record("dense_stack", f"diffusion noise net {shape} gelu N={n}",
               err, ms, plain_ms, regime=stack_regime(n, dims)[0],
               library_ms=plain_ms, bound_us=bound_us, bound_by=bound_by)


def score_diffusion_path(dev):
    """Example 28 at its default depths but DF_EPOCHS: a VP diffusion (hidden (128, 128),
    gelu: kernel 2) trained by denoising score matching through train.fit
    (DF_EPOCHS epochs at batch DF_BATCH on DF_TRAIN points of the 3-mode
    target, lr 2e-3, EMA DF_EMA); DF_EVAL ancestral (SDE) samples of
    DF_ODE steps with each mode's weight within 0.06; probability-flow
    densities (DF_ODE RK4 steps, the exact divergence) on a 41 x 41 grid,
    mean |p_model - p_target| < 6e-3, and the importance-sampled
    normalization within 0.08 of 1; the diffusion as an MH-corrected
    independence proposal (DF_EVAL chains, DF_MH steps): acceptance > 0.5
    and E|x|^2 within 3% of the target's.  Then kernel 2 at the path's row
    counts."""
    from vaemolsim_tpu_torch.flows import Diffusion
    gen = torch.Generator(device=dev).manual_seed(28)
    target = ex28_target(dev)
    data = target.sample(gen, (DF_TRAIN,))
    model = Diffusion.create(gen, 2, hidden_dim=(128, 128), device=dev)

    def loss_fn(m, b, g):
        return m.loss(g, b)

    n_fit = DF_EPOCHS * (DF_TRAIN // DF_BATCH)
    sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    model, hist = fit(model, loss_fn, data, generator=gen,
                      num_epochs=DF_EPOCHS, batch_size=DF_BATCH,
                      learning_rate=2e-3, scan_epochs=True, ema_decay=DF_EMA)
    sync(dev)
    fit_s = time.perf_counter() - t0
    train_counts = path_counts("score_diffusion_train",
                               expect=("dense_stack",))
    # A 3-step profiled window of DSM steps, on a copy of the model.
    probe = copy.deepcopy(model)
    step = make_train_step(loss_fn, torch.optim.Adam(probe.parameters(),
                                                     lr=2e-3))
    step(probe, data[:DF_BATCH], gen)
    busy = card_busy(lambda: [step(probe, data[:DF_BATCH], gen)
                              for _ in range(3)], 3, dev)
    del probe
    _build.reset_launches()
    with torch.no_grad():
        t1 = time.perf_counter()
        x_sde = model.sample(gen, (DF_EVAL,), n_steps=DF_ODE, method="sde")
        w = mode_weights(x_sde)
        sde_s = time.perf_counter() - t1
        g = torch.linspace(-5.0, 5.0, 41, device=dev)
        grid = torch.stack(torch.meshgrid(g, g, indexing="ij"),
                           -1).reshape(-1, 2)
        sync(dev)
        t2 = time.perf_counter()
        lp_model = model.log_prob(grid, n_steps=DF_ODE)
        derr = float((lp_model.exp() - target.log_prob(grid).exp())
                     .abs().mean())
        x_is = target.sample(gen, (DF_EVAL,))
        lw = model.log_prob(x_is, n_steps=DF_ODE) - target.log_prob(x_is)
        z = float(lw.exp().mean())
        lp_s = time.perf_counter() - t2
        t3 = time.perf_counter()
        x, lq = model.sample_and_log_prob(gen, (DF_EVAL,), n_steps=DF_ODE)
        lpi = target.log_prob(x)
        acc = torch.zeros((), device=dev)
        for _ in range(DF_MH):
            y, lq_y = model.sample_and_log_prob(gen, (DF_EVAL,),
                                                n_steps=DF_ODE)
            lpi_y = target.log_prob(y)
            log_r = (lpi_y - lpi) + (lq - lq_y)
            u = torch.log(torch.rand(DF_EVAL, generator=gen, device=dev)
                          .clamp_min(1e-38))
            take = u < log_r
            x = torch.where(take[:, None], y, x)
            lpi = torch.where(take, lpi_y, lpi)
            lq = torch.where(take, lq_y, lq)
            acc = acc + take.float().mean()
        acc = float(acc) / DF_MH
        mh_s = time.perf_counter() - t3
        m2_mh = float((x ** 2).sum(-1).mean())
        m2_true = float((target.sample(gen, (200_000,)) ** 2).sum(-1).mean())
    counts = path_counts("score_diffusion_sample", expect=("dense_stack",))
    wall = time.perf_counter() - t0
    dsm_ms = 1e3 * fit_s / n_fit
    n_lp = grid.shape[0] + DF_EVAL
    print(f"example 28: DSM loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f} ({dsm_ms:.3f} ms a DSM step); SDE mode "
          f"weights {np.round(w, 3)} ({DF_EVAL / sde_s:.1f} samples/s); "
          f"grid density error {derr:.5f}, normalization {z:.4f} "
          f"({n_lp / lp_s:.1f} log-prob points/s); MH acceptance "
          f"{acc:.3f}, E|x|^2 {m2_mh:.4f} against {m2_true:.4f} "
          f"({1e3 * mh_s / (DF_MH + 1):.1f} ms a proposal of {DF_EVAL} "
          f"chains)", flush=True)
    fail_unless(bool(np.all(np.abs(w - np.array([0.5, 0.3, 0.2])) < 0.06)),
                f"example 28: SDE mode weights {w}")
    fail_unless(derr < 6e-3, f"example 28: grid density error {derr}")
    fail_unless(abs(z - 1.0) < 0.08, f"example 28: normalization {z}")
    fail_unless(acc > 0.5, f"example 28: MH acceptance {acc}")
    fail_unless(abs(m2_mh - m2_true) / m2_true < 0.03,
                f"example 28: E|x|^2 {m2_mh} against {m2_true}")
    if dev.type == "cuda":
        with torch.no_grad():
            check_diffusion_kernel(model, gen, dev)
    row = sampling_row(
        "score_diffusion_ex28", wall, DF_EVAL / sde_s, "SDE samples/s",
        counts, busy, ms_per_dsm_step=dsm_ms, fit_seconds=fit_s,
        log_prob_points_per_s=n_lp / lp_s, mh_proposal_ms=1e3 * mh_s
        / (DF_MH + 1), sde_seconds=sde_s, log_prob_seconds=lp_s,
        mh_seconds=mh_s, mode_weights=w.tolist(), density_error=derr,
        normalization=z, acceptance=acc, m2=[m2_mh, m2_true],
        dsm_loss=[hist["loss"][0], hist["loss"][-1]])
    row["train_launches"] = train_counts
    return row


def mlp_start(gen, L, dev):
    """bench.py:736's start: MLP_REPLICAS copies of a cubic lattice of
    MLP_ATOMS sites in a box of edge L, jittered by 0.05, and unit normal
    velocities."""
    n = MLP_ATOMS
    m = int(math.ceil(n ** (1.0 / 3.0)))
    grid = np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                    -1).reshape(-1, 3)[:n] * (L / m)
    x0 = (torch.tensor(grid, dtype=torch.float32, device=dev)[None]
          + 0.05 * torch.randn(MLP_REPLICAS, n, 3, generator=gen,
                               device=dev))
    return x0, torch.randn(x0.shape, generator=gen, device=dev)


def painn_path(dev):
    """A PaiNNPotential at bench.py:736's configuration (the SchNet MD of
    ml_potential_md_path: features 64, 3 blocks, 32 RBFs, cutoff 2.5,
    MLP_REPLICAS x MLP_ATOMS atoms at density MLP_RHO, periodic): MLP_STEPS
    BAOAB steps of dt 0.002 after as many to equilibrate, replayed through
    md._BAOAB (a step captured: PaiNN launches no port kernel), held to the
    eager loop within 1e-6 over PN_CHECK steps; energies finite;
    ``energy_force_loss`` and its gradients against a CPU copy on 32
    replicas; the forces on a non-periodic cluster rotating with the frame;
    the box gradient of ``as_potential_for_box`` against the CPU copy.
    Then a committee of UQ_K PaiNNs from their own seeds, through
    stack_models: ``ensemble_energy_forces`` and ``max_force_uncertainty``
    over the MLP_REPLICAS frames, without and with a padding mask, against
    a CPU copy on the first UQ_CPU_FRAMES frames; and three identical
    members giving a spread of exactly 0."""
    from vaemolsim_tpu_torch.nn import (PaiNNPotential,
                                        ensemble_energy_forces,
                                        max_force_uncertainty)
    from vaemolsim_tpu_torch.utils import scan
    n, L = MLP_ATOMS, float((MLP_ATOMS / MLP_RHO) ** (1.0 / 3.0))
    cpu = torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(14)

    def painn(g):
        return PaiNNPotential.create(g, 1, features=MLP_FEATURES,
                                     num_blocks=MLP_BLOCKS, n_rbf=MLP_RBF,
                                     cutoff=MLP_CUTOFF, device=dev)

    model = painn(gen)
    species = torch.ones(n, 1, device=dev)
    box = torch.full((3,), L, device=dev)
    pot = model.as_potential(species, box)
    x0, v0 = mlp_start(gen, L, dev)
    for p in model.parameters():
        p.requires_grad_(False)
    dyn = md._BAOAB(pot, dt=MLP_DT, kt=1.0, friction=1.0, masses=1.0)
    _build.reset_launches()
    st, _ = dyn.scan(dyn.start(x0, v0), MLP_STEPS, gen)
    sync(dev)
    t0 = time.perf_counter()
    out, _ = dyn.scan(st, MLP_STEPS, gen)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = path_counts("painn_md")
    with torch.no_grad():
        e = pot(out.x)
    fail_unless(bool(torch.isfinite(e).all() and torch.isfinite(out.x).all()),
                "PaiNN MD: non-finite energies or positions")
    kt = float((out.v ** 2).mean())
    rate = MLP_REPLICAS * n * MLP_STEPS / wall

    def check_run():
        return dyn.run(st.x, st.v, PN_CHECK, torch.Generator(
            device=dev).manual_seed(15), True, PN_CHUNK)

    got = scan._leaves(check_run())
    with scan.eager():
        want = scan._leaves(check_run())
    diff = max(float((a.double() - b.double()).abs().max())
               for a, b in zip(got, want))
    print(f"PaiNN MD: replay against the eager loop over {PN_CHECK} steps, "
          f"largest difference {diff:.3e}", flush=True)
    fail_unless(diff <= 1e-6, f"PaiNN MD: replay differs from eager {diff}")
    row = replay_row(
        "painn_md", wall, MLP_STEPS, rate, "replica-atom-steps/s", counts,
        lambda: dyn.run(st.x, st.v, 20, gen, False, 10), 20,
        lambda: dyn.run(st.x, st.v, PN_WINDOW, gen, False, PN_CHUNK),
        PN_WINDOW - PN_CHUNK, dev, skip=1, kT=kt, replay_max_diff=diff)

    for p in model.parameters():
        p.requires_grad_(True)
    xs = out.x[:32].detach()
    targets = (e[:32].detach() + 0.1, 0.1 * torch.randn(
        xs.shape, generator=gen, device=dev))
    check_grads("painn energy_force_loss", model, lambda mod, d: (
        energy_force_loss(mod, xs.to(d), species.to(d), targets[0].to(d),
                          targets[1].to(d), box=box.to(d), w_energy=0.1)),
        dev)
    cpu_model = copy.deepcopy(model).to(cpu)

    def forces(mod, c, *args):
        c = c.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(mod(c, *args).sum(), c)
        return -g

    rot = torch.tensor(np.linalg.qr(np.random.default_rng(14).normal(
        size=(3, 3)))[0], dtype=torch.float32, device=dev)
    cluster = out.x[:8].detach()
    f = forces(model, cluster, species)
    scale = float(f.abs().max())
    rot_err = compare("painn forces rotate with the frame",
                      forces(model, cluster @ rot, species), f @ rot,
                      1e-4 * scale, 1e-4)
    bx = box.clone().requires_grad_(True)
    (g_box,) = torch.autograd.grad(
        model.as_potential_for_box(species)(bx)(xs).sum(), bx)
    bx_cpu = box.cpu().requires_grad_(True)
    (g_cpu,) = torch.autograd.grad(
        cpu_model.as_potential_for_box(species.cpu())(bx_cpu)(
            xs.cpu()).sum(), bx_cpu)
    box_err = compare("painn box gradient", g_box.cpu(), g_cpu,
                      1e-4 * float(g_cpu.abs().max()), 1e-4)

    members = [painn(torch.Generator(device=dev).manual_seed(100 + i))
               for i in range(UQ_K)]
    stack = stack_models(members)
    frames = out.x.detach()
    mask = torch.arange(n, device=dev) < n - UQ_PAD
    sync(dev)
    t1 = time.perf_counter()
    masks = {"all": None, "masked": mask}

    def committee(st, x, d, m):
        """Both statistics of the committee st on frames x, on device d."""
        args = (species.to(d), box.to(d), None if m is None else m.to(d))
        with torch.no_grad():
            return (*ensemble_energy_forces(st, x, *args),
                    max_force_uncertainty(st, x, *args))

    sync(dev)
    t1 = time.perf_counter()
    preds = {k: committee(stack, frames, dev, m) for k, m in masks.items()}
    sync(dev)
    uq_s = time.perf_counter() - t1
    cpu_stack = copy.deepcopy(stack).to(cpu)
    uq_err = 0.0
    for k, m in masks.items():
        fail_unless(all(bool(torch.isfinite(v).all()) for v in preds[k]),
                    f"committee {k}: non-finite statistics")
        want = committee(cpu_stack, frames[:UQ_CPU_FRAMES].cpu(), cpu, m)
        for name, a, b in zip(("energy", "forces", "energy_std",
                               "force_std", "max_force_uncertainty"),
                              preds[k], want):
            uq_err = max(uq_err, compare(
                f"committee {name} {k}", a[:UQ_CPU_FRAMES].cpu(), b,
                1e-4 * float(b.abs().max()), 1e-4))
    fail_unless(float(preds["masked"][1][:, n - UQ_PAD:].abs().max()) == 0.0,
                "committee: padding atoms carry a force")
    same = stack_models([members[0]] * UQ_K)
    with torch.no_grad():
        zero = ensemble_energy_forces(same, frames, species, box)
        zero_mu = max_force_uncertainty(same, frames, species, box, mask)
    spread = max(float(zero.energy_std.abs().max()),
                 float(zero.force_std.abs().max()),
                 float(zero_mu.abs().max()))
    fail_unless(spread == 0.0, f"committee: identical members spread "
                f"{spread}")
    unc = preds["all"]
    print(f"PaiNN: {rate:.1f} replica-atom-steps/s; rotated forces max err "
          f"{rot_err:.3e}, box gradient {box_err:.3e}; committee of {UQ_K} "
          f"over {frames.shape[0]} frames in {uq_s:.3f} s (both masks), "
          f"mean force std {float(unc[3].mean()):.4f}, mean max force "
          f"uncertainty {float(unc[4].mean()):.4f}, against the CPU "
          f"copy {uq_err:.3e}; identical members spread {spread}",
          flush=True)
    # The replayed loop's own pace: its busy time over its busy share (the
    # run's wall above includes the capture and its eager warm-up).
    if row["device_busy_ms"] is not None:
        pace = row["device_busy_ms"] / (1.0 - row["device_idle_share"])
        row["ms_per_step_replay_window"] = pace
        print(f"PaiNN: {pace:.4f} ms a step in the replayed window "
              f"({1e3 * MLP_REPLICAS * n / pace:.1f} replica-atom-steps/s)",
              flush=True)
    row.update(rotation_err=rot_err, box_grad_err=box_err,
               committee_seconds=uq_s, committee_cpu_err=uq_err,
               identical_spread=spread)
    return row


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for each kernel's main shape
# ---------------------------------------------------------------------------


def _bound(nbytes, flops, bf16_flops=0):
    """(bound µs, what bounds it): bytes over HBM bandwidth against the
    operations' time, ``flops`` at the float32 rate and ``bf16_flops``
    (products of bfloat16 operands summed in float32) at the tensor
    cores' bfloat16 rate."""
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_F32 + bf16_flops / PEAK_BF16
    return (1e6 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def spline_flops(K):
    """One RQS evaluation: the bin walk's running sums (4 adds per knot)
    and ~25 operations for the rational map and its log-derivative."""
    return 4 * (K - 1) + 25


def proposal_bound(vae, m, K=32):
    """(bound µs, what bounds it) of kernel 4's whole proposal over m
    chains: two encoder and two decoder passes and 2B = 4 spline walks a
    chain; x1 in, x2 and four scalars out."""
    enc_w, _, _, _ = mf._extract_mlp(vae.encoder, "encoder")
    dec_w, _, _, _ = mf._extract_mlp(vae.decoder, "decoder")
    ew = (enc_w[0].shape[0] * enc_w[0].shape[1]
          + enc_w[2].shape[0] * enc_w[2].shape[1])
    dw = (dec_w[0].shape[0] * dec_w[0].shape[1]
          + dec_w[2].shape[0] * dec_w[2].shape[1])
    d_x = dec_w[2].shape[1] // 2
    return _bound(4 * m * (d_x + d_x + 4),
                  m * (2 * 2 * ew + 2 * 2 * dw + 4 * spline_flops(K)))


def bounds(vae, flow):
    """{kernel or shape: (bound µs, what bounds it)}, at each kernel's
    main shape and at the one-row MAF conditioner and the MAF forward:
    bytes read once and written once over HBM bandwidth against float32
    operations over the peak outside the tensor cores."""
    n, K = SIZES[-1], 32
    out = {"rqs": _bound(4 * (3 * n + 3 * K - 1), n * spline_flops(K)),
           f"rqs N={SIZES[0]}": _bound(4 * (3 * SIZES[0] + 3 * K - 1),
                                       SIZES[0] * spline_flops(K))}
    enc_w, _, _, _ = mf._extract_mlp(vae.encoder, "encoder")
    ew = (enc_w[0].shape[0] * enc_w[0].shape[1]
          + enc_w[2].shape[0] * enc_w[2].shape[1])
    d_in, d_out = enc_w[0].shape[0], enc_w[2].shape[1]
    out["dense_stack"] = _bound(
        4 * (n * (d_in + d_out) + ew + sum(t.numel() for t in enc_w[1::2])),
        2 * n * ew)
    for m, key in ((n, "vae_proposal"),
                   (SIZES[0], f"vae_proposal N={SIZES[0]}")):
        out[key] = proposal_bound(vae, m, K)
    cond = flow.flowed_dist.flow.blocks[0].conditioner
    D, H, Kf = (cond.w_net.event_size, cond.w_net.kernels[0].shape[1],
                cond.num_bins)
    nf = TRAIN_BATCH
    head = H * D * (3 * Kf - 1)  # the three heads' blocks of K2
    maf_bytes = 4 * (nf * (2 * D + 1) + D * 3 * H + 3 * H + head
                     + D * (3 * Kf - 1))
    # The products the MADE masks leave non-zero (about half of K1 and of
    # each head's block: hidden degrees cycle over 1..D-1) are the least
    # work; the block-diagonal product with its masked zeros is what the
    # kernel does.  Both add, per (row, DOF), the softmax of the widths
    # and heights (~3 operations per bin: exp, sum, scale) and the spline.
    masked = sum(int(m.sum()) for n in cond.nets for m in n.masks)
    spline = nf * D * (2 * 3 * Kf + spline_flops(Kf))
    out["maf_block"] = _bound(maf_bytes, 2 * nf * masked + spline)
    # The forward (the D-pass fixed point) needs each DOF's outputs and
    # each hidden unit once, from final inputs: the inverse's work.  The
    # D-pass count (the plain version's, and the first design of kernel
    # 3's) is kept beside it.
    out["maf_block forward"] = _bound(maf_bytes, 2 * nf * masked + spline)
    out["maf_block forward D-pass"] = _bound(
        maf_bytes, D * (2 * nf * masked + spline))
    out["maf_block block-diagonal"] = _bound(
        maf_bytes, 2 * nf * (D * 3 * H + head) + spline)
    # The flagship prior's one-row merged conditioner: its weights.
    w = [t for t in vae.prior.flow.blocks[0].conditioner.merged_params()
         if t is not None]
    out["dense_stack one-row MAF conditioner"] = _bound(
        4 * (1 + sum(t.numel() for t in w) + w[2].shape[1]),
        2 * (w[0].numel() + w[2].numel()))
    # The pair-attention kernel: computed from each timed check's own
    # inputs (its mask sets the valid pairs), by check_pair_attention.
    for c in RESULTS["checks"]:
        if c["kernel"] == "pair_attention" and "bound_us" in c:
            by = RESULTS["pair_attention_bound_by"][c["shape"]]
            out[f"pair_attention {c['shape']}"] = (c["bound_us"], by)
            out[f"pair_attention {c['shape']} per-pair head"] = (
                c["per_pair_head_bound_us"], "operations")
            if c["shape"] == PA_MAIN:
                out["pair_attention"] = (c["bound_us"], by)
    # The cell-pair kernel: from each timed check's own inputs (the pairs
    # inside the cutoff depend on the state), by check_cell_lj_case.
    # The old count (every padded slot tested) is kept beside the new.
    for c in RESULTS["checks"]:
        if c["kernel"] == "cell_lj" and "bound_us" in c:
            work = RESULTS["cell_lj_work"][c["shape"]]
            out[f"cell_lj {c['shape']}"] = (c["bound_us"], work["bound_by"])
            out[f"cell_lj {c['shape']} padded count"] = (
                c["padded_bound_us"], work["padded_bound_by"])
            if c["shape"].startswith(MOL_SHAPE):
                out["cell_lj"] = (c["bound_us"], work["bound_by"])
    # Kernel 1's row per element at the flagship's K and sizes: each
    # element reads x and its 3K - 1 parameters, writes y and the log-det.
    for m in SIZES:
        out[f"rqs per-element N={m}"] = _bound(4 * m * (3 * K + 2),
                                               m * spline_flops(K))
    # Shapes checked with their own bound: the dense stack's tiled regime
    # at the backmapping decoder's widths, and kernels 2 and 1 at the
    # RealNVP paths' shapes (check_coupling_kernels).
    for c in RESULTS["checks"]:
        if (c["kernel"] in ("dense_stack", "rqs", "maf_block")
                and "bound_us" in c):
            out[f"{c['kernel']} {c['shape']}"] = (c["bound_us"],
                                                 c["bound_by"])
    return out


# ---------------------------------------------------------------------------
# Slice 14b: the parallel layer (examples 08 and 05, kernel 6's slabs,
# slab-decomposed PME, the collective checkpoint), the input pipeline and
# the debug and profiling utilities
# ---------------------------------------------------------------------------

EX08_SAMPLES, EX08_EPOCHS, EX08_CHAINS, EX08_STEPS = 4096, 3, 1024, 50
EX08_COV_HALF = ((1.0, 0.0), (0.8, 0.6))
# |sampled - target covariance|, largest entry: 0.109 (generic) and 0.111
# (fused) in a CPU rehearsal of the phase; twice that, with room for the
# card's other random streams (sampling error alone is ~0.044).
EX08_COV_TOL = 0.25
EX05_R, EX05_CHAINS, EX05_STEPS = 6, 256, 150
# The cold replica's right-mode fraction: the JAX example's least and
# largest over seeds 0-11 (0.4453, 0.5352; tools/remc_mode_spread.py on
# the CPU) widened by three binomial standard errors of 256 chains (0.094).
EX05_FRAC_BAND = (0.345, 0.635)
SLAB_COUNT = 4
PIPE_FRAMES, PIPE_ATOMS, PIPE_BATCH, PIPE_HIDDEN = 65_536, 22, 8192, 1024
# prefetch_to_device's copies over PIPE_OVERLAP_PASSES passes through the
# batches: the least share of their time on the card that must run beside
# a kernel (at most 1 - 3 / 32 with the default two batches ahead).
PIPE_OVERLAP_PASSES, PIPE_MIN_OVERLAP = 4, 0.5


def free_port():
    """A TCP port on localhost that no process holds now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def ex08_target(dev):
    """Example 08's log target: the data's Gaussian, -|L^-1 x|^2 / 2."""
    inv = torch.linalg.inv(torch.tensor(EX08_COV_HALF, device=dev))

    def log_target(x):
        y = x @ inv.T
        return -0.5 * (y * y).sum(-1)

    return log_target


def example_08(dev, mesh, chain_mesh):
    """Example 08 at its default depths: the flagship VAE trained by its
    ELBO with fit(mesh=) on EX08_SAMPLES correlated 2-D points for
    EX08_EPOCHS epochs (batch EX08_SAMPLES / 8, scan_epochs as the
    example), then EX08_CHAINS chains sharded over the chain mesh for
    EX08_STEPS steps of the generic step (kernels 1 and 2) and of the
    fused step (kernel 4), the fused run held bit for bit to the same
    run unsharded; the sampled covariance held to the target's, the
    acceptance in (0, 1)."""
    from vaemolsim_tpu_torch import parallel

    rng = np.random.default_rng(0)
    cov_half = np.asarray(EX08_COV_HALF)
    data = torch.tensor(rng.normal(size=(EX08_SAMPLES, 2)) @ cov_half.T,
                        dtype=torch.float32, device=dev)
    vae = flagship_experiment_config().build(dev)
    world = parallel.process_count()
    batch = max(EX08_SAMPLES // 8, world)
    sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    vae, hist = fit(vae, lambda m, b, g: m.elbo_loss(b, g), data,
                    generator=torch.Generator(device=dev).manual_seed(1),
                    num_epochs=EX08_EPOCHS, batch_size=batch,
                    scan_epochs=True, mesh=mesh)
    sync(dev)
    train_s = time.perf_counter() - t0
    train_counts = path_counts("example_08_train",
                               expect=("rqs", "dense_stack"))
    steps = EX08_EPOCHS * (EX08_SAMPLES // batch)
    fail_unless(all(math.isfinite(v) for v in hist["loss"]),
                f"example 08: losses {hist['loss']}")

    log_t = ex08_target(dev)
    parallel.replicate(vae, chain_mesh)
    x0 = torch.randn(EX08_CHAINS, 2, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    want = torch.tensor(cov_half @ cov_half.T, device=dev)

    def run(step, sharded):
        st = MCMCState.create(x0, log_t(x0),
                              torch.Generator(device=dev).manual_seed(3))
        if sharded:
            st = parallel.shard_chain_state(st, chain_mesh)
        sync(dev)
        t0 = time.perf_counter()
        st, _ = run_mcmc(step, st, EX08_STEPS)
        sync(dev)
        return st, time.perf_counter() - t0

    rows = {}
    for name, step, expect in (
            ("generic", make_mcmc_step(*vae_proposal_fns(vae), log_t),
             ("rqs", "dense_stack")),
            ("fused", make_fused_vae_step(vae, log_t), ("vae_proposal",))):
        _build.reset_launches()
        st, secs = run(step, True)
        counts = path_counts(f"example_08_{name}", expect=expect)
        glob = parallel.local_to_global(
            st.configs, parallel.chain_sharding(chain_mesh, 2)).full_tensor()
        cov = torch.cov(glob.T.double())
        err = float((cov - want).abs().max())
        acc = float(st.acceptance_rate)
        fail_unless(0.0 < acc < 1.0, f"example 08 {name}: acceptance {acc}")
        fail_unless(int(st.num_trials) == EX08_CHAINS * EX08_STEPS,
                    f"example 08 {name}: {int(st.num_trials)} trials")
        fail_unless(err < EX08_COV_TOL,
                    f"example 08 {name}: covariance {cov.tolist()} against "
                    f"{want.tolist()}")
        rows[name] = dict(seconds=secs, acceptance=acc, cov_err=err,
                          proposals_per_s=EX08_CHAINS * EX08_STEPS / secs,
                          launches=counts)
        if name == "fused":
            one, _ = run(step, False)
            fail_unless(torch.equal(one.configs, st.configs),
                        "example 08: the sharded fused run differs from "
                        "the one-device run")
    print(f"example 08: {steps} fit(mesh=) steps in {train_s:.2f} s "
          f"({steps / train_s:.3f} steps/s), loss {hist['loss'][0]:.4f} -> "
          f"{hist['loss'][-1]:.4f}; "
          + "; ".join(f"{k} {v['proposals_per_s']:.1f} proposals/s, "
                      f"acceptance {v['acceptance']:.4f}, covariance error "
                      f"{v['cov_err']:.4f}" for k, v in rows.items()),
          flush=True)
    return dict(train_seconds=train_s, train_steps=steps,
                train_steps_per_s=steps / train_s, loss=hist["loss"],
                train_launches=train_counts, mc=rows)


def example_05(dev, seed=0, check=True, mesh=None):
    """Example 05 at its default depths: EX05_R tempered replicas (beta
    down to 0.05) x EX05_CHAINS chains x EX05_STEPS steps on a rough
    two-mode 1-D target (modes at -6 and 6, width 0.4), every chain
    started in the left mode, an independence proposal (encoder = prior
    = N(0, 1), decoder N(0, 3^2)), an exchange every 2 steps; sharded
    over ``mesh`` (a ("replica", "chain") mesh) when given.  The cold
    replica's right-mode fraction is held to EX05_FRAC_BAND."""
    from vaemolsim_tpu_torch import parallel

    z2 = torch.zeros(2, device=dev)
    target = dist.MixtureSameFamily(z2, dist.Normal(
        torch.tensor([-6.0, 6.0], device=dev), 0.4 + z2))

    def log_target(x):
        return target.log_prob(x[..., 0])

    def enc(x):
        z = torch.zeros(x.shape[:-1] + (1,), device=x.device)
        return dist.Independent(dist.Normal(z, torch.ones_like(z)), 1)

    def dec(z):
        loc = torch.zeros(z.shape[:-1] + (1,), device=z.device)
        return dist.Independent(dist.Normal(loc, 3.0 + loc), 1)

    step = make_remc_step(enc, enc, dec, log_target, exchange_every=2,
                          mesh=mesh)
    state = REMCState.create(
        torch.full((EX05_R, EX05_CHAINS, 1), -6.0, device=dev), log_target,
        temperature_ladder(EX05_R, beta_min=0.05, device=dev),
        torch.Generator(device=dev).manual_seed(seed))
    if mesh is not None:
        state = parallel.shard_chain_state(state, mesh)
    sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    final = run_remc(step, state, EX05_STEPS)
    sync(dev)
    secs = time.perf_counter() - t0
    counts = _build.launch_counts()
    # This rank's cold-replica chains (the whole replica on one rank).
    frac = float((final.configs[0, :, 0] > 0).double().mean())
    row = dict(seconds=secs, right_mode_fraction=frac,
               acceptance=float(final.acceptance_rate),
               swap_acceptance=float(final.swap_acceptance_rate),
               proposals_per_s=EX05_R * EX05_CHAINS * EX05_STEPS / secs,
               launches=counts)
    if check:
        lo, hi = EX05_FRAC_BAND
        fail_unless(lo <= frac <= hi,
                    f"example 05: right-mode fraction {frac} outside "
                    f"{EX05_FRAC_BAND}")
        fail_unless(0.0 < row["swap_acceptance"] < 1.0
                    and 0.0 < row["acceptance"] < 1.0,
                    f"example 05: acceptance {row}")
        fail_unless(bool(torch.isfinite(final.energies).all()),
                    "example 05: non-finite energies")
        print(f"example 05: {EX05_R} x {EX05_CHAINS} x {EX05_STEPS} in "
              f"{secs:.2f} s ({row['proposals_per_s']:.1f} tempered "
              f"proposals/s), acceptance {row['acceptance']:.3f}, swap "
              f"acceptance {row['swap_acceptance']:.3f}, cold right-mode "
              f"fraction {frac:.4f}", flush=True)
    return row


def check_proposal_offset(vae, dev):
    """Kernel 4 with a chain offset: the second half of a launch over
    EX08_CHAINS chains, launched alone from chain EX08_CHAINS / 2, is the
    whole launch's second half bit for bit (what a rank of a sharded run
    computes); the plain version at that offset agrees at check_proposal's
    tolerances."""
    gen = torch.Generator(device=dev).manual_seed(77)
    x = torch.randn(EX08_CHAINS, 2, generator=gen, device=dev)
    seed = torch.tensor([12345, -6789], dtype=torch.int32, device=dev)
    rest = _proposal_args(vae)
    half = EX08_CHAINS // 2
    xh = x[half:].contiguous()
    whole = mf.vae_proposal_cuda(x, seed, *rest)
    part = mf.vae_proposal_cuda(xh, seed, *rest, chain0=half)
    plain = mf.vae_proposal_plain(xh, seed, *rest, chain0=half)
    err = 0.0
    for name, w, g, p in zip(("x2", "fwd", "rev", "z1", "z2"), whole, part,
                             plain):
        fail_unless(torch.equal(w[half:], g),
                    f"kernel 4 at a chain offset: {name} differs from the "
                    "whole launch's rows")
        dens = name in ("fwd", "rev")
        err = max(err, compare(f"proposal chain0={half} {name}", g, p,
                               1e-3 if dens else 1e-4, 1e-4, 1e-4))
    ms = timed(lambda: mf.vae_proposal_cuda(xh, seed, *rest, chain0=half))
    plain_ms = timed(lambda: mf.vae_proposal_plain(xh, seed, *rest,
                                                   chain0=half))
    bound_us, bound_by = proposal_bound(vae, half)
    record("vae_proposal", f"chain0={half} philox N={half}", err, ms,
           plain_ms, bound_us=bound_us, bound_by=bound_by)


def check_slabs(mol, x, mesh):
    """Kernel 6's sharded cell grid at the molecular stack's shape (MD_N
    atoms, C = 72, charges and exclusions): the SLAB_COUNT slabs
    evaluated one after another in this process (``energy.by_slabs``:
    SLAB_COUNT times the launches of one call), their summed energy and
    assembled gradient held to the unsharded call (energy 1e-6 relative,
    gradient 1e-6 of its largest component: the same cell rows, summed
    in another order), and the mesh path over ``mesh`` ("cells")
    likewise.  The launch counts of the path are read from zero around
    the slab and mesh evaluations only.  Then the kernel on the first
    slab's rows against its plain version (check_cell_lj_case's
    tolerances), each timed, beside the device ms of the slabs in turn,
    the mesh path and the unsharded call."""
    energy = mol["cell_energy"]
    _, mesh_energy = potentials.lennard_jones_cell_neighbor(
        mesh=mesh, mesh_axis="cells", **mol["cell_kw"])
    nl = mol["build"](x)

    def value_and_grad(fn):
        xg = x.detach().clone().requires_grad_(True)
        before = cell_lj.KERNEL.launches
        e = fn(nl, xg)
        (g,) = torch.autograd.grad(e, xg)
        return e.detach(), g, cell_lj.KERNEL.launches - before

    e, g, per_call = value_and_grad(energy)
    scale = float(g.abs().max())
    _build.reset_launches()
    before = cell_lj.KERNEL.launches
    slabs = energy.by_slabs(nl, x, SLAB_COUNT)
    slabs += (cell_lj.KERNEL.launches - before,)
    mesh_run = value_and_grad(mesh_energy)
    counts = path_counts("sharded_cell_grid", expect=("cell_lj",))
    out = {}
    for name, (e_s, g_s, launched), want in (
            ("slabs", slabs, SLAB_COUNT * per_call),
            ("mesh", mesh_run, per_call)):
        fail_unless(launched == want,
                    f"kernel 6 {name}: {launched} launches, want {want}")
        e_err = abs(float(e_s) - float(e)) / abs(float(e))
        g_err = float((g_s - g).abs().max())
        fail_unless(e_err < 1e-6 and g_err < 1e-6 * scale,
                    f"kernel 6 {name}: energy {float(e_s)} against "
                    f"{float(e)}, gradient error {g_err} of {scale}")
        out[name] = dict(energy_rel_err=e_err, grad_err=g_err,
                         launches=launched)

    args, kw = energy.cell_pair_inputs(nl, x)
    n_cells = args[0].shape[0]
    rows = -(-n_cells // SLAB_COUNT)

    def first_slab(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            return type(a)(first_slab(t) for t in a)
        return a[:rows].contiguous()

    slab_args = first_slab(args)
    kw = dict(kw, grid_cells=n_cells)
    es, gs = cell_lj.cell_pair_energy_force_cuda(*slab_args, **kw)
    ew, gw = cell_lj.cell_pair_energy_force_plain(*slab_args, **kw)
    err = max(compare("cell_lj slab e", es, ew,
                      1e-5 * float(ew.abs().max()), 1e-5),
              compare("cell_lj slab grad", gs, gw,
                      1e-4 * float(gw.abs().max()) + 1e-5, 0.0))
    with torch.no_grad():
        ms_slab = timed(lambda: cell_lj.cell_pair_energy_force_cuda(
            *slab_args, **kw))
        plain_slab = timed(lambda: cell_lj.cell_pair_energy_force_plain(
            *slab_args, **kw), reps=5)
        ms_one = timed(lambda: energy(nl, x))
        ms_slabs = timed(lambda: energy.by_slabs(nl, x, SLAB_COUNT))
        ms_mesh = timed(lambda: mesh_energy(nl, x))
    record("cell_lj", f"slab 1 of {SLAB_COUNT} ({rows} of {n_cells} "
           f"cells) of {MOL_SHAPE}", err, ms_slab, plain_slab,
           slabs_ms=ms_slabs, mesh_ms=ms_mesh, unsharded_ms=ms_one,
           launches_per_call=per_call)
    print(f"kernel 6 slabs: {SLAB_COUNT} slabs {ms_slabs:.4f} ms, the "
          f"mesh path {ms_mesh:.4f} ms, against {ms_one:.4f} ms unsharded "
          f"({per_call} launch(es) a call); energy errors "
          f"{out['slabs']['energy_rel_err']:.2e} and "
          f"{out['mesh']['energy_rel_err']:.2e}; one slab's kernel "
          f"{ms_slab:.4f} ms against its plain version {plain_slab:.4f} ms",
          flush=True)
    return dict(out, ms_slabs=ms_slabs, ms_mesh=ms_mesh,
                ms_unsharded=ms_one, ms_slab=ms_slab,
                plain_ms_slab=plain_slab, launches_per_call=per_call,
                launches=counts)


def check_sharded_pme(mol, x, mesh):
    """Slab-decomposed PME over ``mesh`` ("atoms") on the molecular
    stack's reciprocal sum (MD_N charges, exclusions, tolerance 1e-4)
    against the unsharded call: energy 1e-5 relative, forces 1e-4 of
    their largest component, with the device ms of each."""
    out = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        fn = potentials.pme_coulomb(mesh=m, mesh_axis="atoms",
                                    **mol["pme_kw"])
        xg = x.detach().clone().requires_grad_(True)
        e = fn(xg)
        (g,) = torch.autograd.grad(e, xg)
        with torch.no_grad():
            ms = timed(lambda: fn(x), reps=5)
        out[name] = (float(e.detach()), g, ms, fn.grid_shape)
    (e0, g0, ms0, grid), (e1, g1, ms1, grid1) = (out["unsharded"],
                                                 out["sharded"])
    e_err = abs(e1 - e0) / abs(e0)
    f_err = float((g1 - g0).abs().max()) / float(g0.abs().max())
    fail_unless(grid == grid1 and e_err < 1e-5 and f_err < 1e-4,
                f"sharded PME: energy {e1} against {e0}, forces {f_err}, "
                f"grids {grid} {grid1}")
    print(f"sharded PME grid {grid}: {ms1:.3f} ms against {ms0:.3f} ms "
          f"unsharded, energy error {e_err:.2e}, force error {f_err:.2e}",
          flush=True)
    return dict(ms_sharded=ms1, ms_unsharded=ms0, energy_rel_err=e_err,
                force_rel_err=f_err, grid=grid)


def check_collective_checkpoint(vae, chain_mesh, dev):
    """The distributed smoke's checkpoint step: a sharded fused MC state
    saved by the collective CheckpointManager, restored into a template,
    every shard back bit for bit and the run going on as if it had not
    stopped."""
    from vaemolsim_tpu_torch import parallel

    log_t = ex08_target(dev)
    step = make_fused_vae_step(vae, log_t)
    x0 = torch.randn(EX08_CHAINS, 2, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5))

    def state(x):
        return parallel.shard_chain_state(MCMCState.create(
            x, log_t(x), torch.Generator(device=dev).manual_seed(6)),
            chain_mesh)

    st, _ = run_mcmc(step, state(x0), 5)
    with tempfile.TemporaryDirectory() as tmp:
        ck = CheckpointManager(tmp)
        ck.save(5, st)
        back = ck.restore(state(torch.zeros_like(x0)))
    fail_unless(torch.equal(back.configs, st.configs)
                and int(back.num_trials) == int(st.num_trials)
                and torch.equal(back.generator.get_state(),
                                st.generator.get_state()),
                "collective checkpoint: the restored shard differs")
    fail_unless(torch.equal(run_mcmc(step, back, 3)[0].configs,
                            run_mcmc(step, st, 3)[0].configs),
                "collective checkpoint: the resumed run differs")


def distributed_path(dev, mol, mol_x, vae):
    """The parallel layer on the card: a world-size-1 NCCL group (a
    failed init raises), meshes over it, example 08 (fit(mesh=) and
    sharded MC), example 05 over a ("replica", "chain") mesh, kernel 4
    at a chain offset, kernel 6's slabs, slab-decomposed PME and the
    collective checkpoint; the group destroyed with a timeout."""
    import torch.distributed as dist

    from vaemolsim_tpu_torch import parallel

    parallel.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                    timeout=300.0)
    try:
        backend = dist.get_backend()
        want = "nccl" if dev.type == "cuda" else "gloo"
        fail_unless(backend == want, f"backend {backend}, not {want}")
        print(f"distributed: backend {backend}, world size "
              f"{dist.get_world_size()}, {torch.cuda.device_count()} "
              "device(s)", flush=True)
        batch_mesh = parallel.make_mesh({"batch": -1})
        chain_mesh = parallel.make_mesh({"chain": -1})
        ex08 = example_08(dev, batch_mesh, chain_mesh)
        ex05 = example_05(dev, mesh=parallel.make_mesh(
            {"replica": 1, "chain": -1}))
        with torch.no_grad():
            check_proposal_offset(vae, dev)
        slabs = check_slabs(mol, mol_x, parallel.make_mesh({"cells": -1}))
        pme = check_sharded_pme(mol, mol_x, parallel.make_mesh(
            {"atoms": -1}))
        check_collective_checkpoint(vae, chain_mesh, dev)
        row = dict(backend=backend, world_size=dist.get_world_size(),
                   device_count=torch.cuda.device_count(), example_08=ex08,
                   example_05=ex05, slabs=slabs, pme=pme)
    finally:
        done = threading.Thread(target=parallel.shutdown_distributed)
        done.start()
        done.join(timeout=120.0)
    fail_unless(not done.is_alive(),
                "destroying the process group took over 120 s")
    RESULTS["distributed"] = row
    launches = {}
    for counts in (ex08["train_launches"], ex08["mc"]["generic"]["launches"],
                   ex08["mc"]["fused"]["launches"]):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    row["launches"] = launches
    return row


def pipeline_utils_path(dev):
    """The input pipeline and the utilities on the card: a DCD file of
    PIPE_FRAMES frames written here streamed through ``epoch_stream``
    (every frame once, on the card); the copies of ``prefetch_to_device``
    on a side stream against a step's compute (the share of the copies'
    time on the card that ran beside a kernel, from a profile, held to
    PIPE_MIN_OVERLAP; the loop's host wall time with prefetch, against
    compute alone and copies alone, printed); ``checked``
    raising on a NaN row carried into kernel 2's output by the flagship
    encoder; ``StepTimer`` and ``benchmark_fn`` against CUDA events; a
    ``trace`` file written."""
    from vaemolsim_tpu_torch import utils

    rng = np.random.default_rng(14)
    frames = rng.normal(size=(PIPE_FRAMES, PIPE_ATOMS, 3)).astype(np.float32)
    width = 3 * PIPE_ATOMS
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pipe.dcd")
        data.write_dcd(path, frames)
        reader = data.DCDReader(path)
        t0 = time.perf_counter()
        total, seen = torch.zeros((), dtype=torch.float64, device=dev), 0
        for b in data.epoch_stream(
                lambda s, c: reader.read(s, c)[0].reshape(c, -1),
                reader.n_frames, PIPE_BATCH, key=0, device=dev):
            fail_unless(b.device.type == dev.type
                        and b.shape == (PIPE_BATCH, width),
                        f"epoch_stream batch {b.shape} on {b.device}")
            total += b.double().sum()
            seen += b.shape[0]
        sync(dev)
        out["epoch_seconds"] = time.perf_counter() - t0
        want = float(frames.astype(np.float64).sum())
        fail_unless(seen == PIPE_FRAMES
                    and abs(float(total) - want) < 1e-6 * frames.size,
                    f"epoch_stream: {seen} frames, sum {float(total)} "
                    f"against {want}")

    gen = torch.Generator(device=dev).manual_seed(15)
    w1 = torch.randn(width, PIPE_HIDDEN, generator=gen, device=dev) * 0.1
    w2 = torch.randn(PIPE_HIDDEN, PIPE_HIDDEN, generator=gen,
                     device=dev) * 0.03
    host = [frames[i:i + PIPE_BATCH].reshape(PIPE_BATCH, -1)
            for i in range(0, PIPE_FRAMES, PIPE_BATCH)]

    def step(b):
        h = torch.tanh(b @ w1)
        for _ in range(4):
            h = torch.tanh(h @ w2)
        return h.sum()

    def loop(batches):
        sync(dev)
        t0 = time.perf_counter()
        acc = torch.zeros((), device=dev)
        for b in batches:
            acc = acc + step(b)
        sync(dev)
        return time.perf_counter() - t0

    def copies_alone():
        """Each batch pinned and copied in turn, nothing to overlap."""
        sync(dev)
        t0 = time.perf_counter()
        for h in host:
            torch.as_tensor(h).pin_memory().to(dev, non_blocking=True)
        sync(dev)
        return time.perf_counter() - t0

    def prefetched(batches=host):
        return loop(data.prefetch_to_device(iter(batches), device=dev))

    resident = [torch.as_tensor(h, device=dev) for h in host]
    # One warm-up each (the host allocator's pinned blocks, the side
    # stream), then the least of three runs: host wall times, printed.
    loop(resident), copies_alone(), prefetched()
    compute = min(loop(resident) for _ in range(3))
    copies = min(copies_alone() for _ in range(3))
    both = min(prefetched() for _ in range(3))
    # The claim itself, on the card's clock: the share of the
    # host-to-device copies' time during which a kernel ran, over
    # PIPE_OVERLAP_PASSES passes through the batches (the first `size`
    # + 1 copies, issued before any step, have nothing to hide behind).
    _, prof = profiled(lambda: prefetched(host * PIPE_OVERLAP_PASSES))
    copy_us, hidden_us = copy_overlap(prof)
    overlap = hidden_us / copy_us if copy_us else 0.0
    out.update(compute_s=compute, copies_s=copies, prefetch_s=both,
               copy_us=copy_us, hidden_copy_us=hidden_us,
               overlap_share=overlap)
    print(f"prefetch: {len(host)} batches of {PIPE_BATCH} x {width}: "
          f"compute {1e3 * compute:.3f} ms, pinned copies {1e3 * copies:.3f}"
          f" ms, both through prefetch_to_device {1e3 * both:.3f} ms (host "
          f"wall); on the card, {hidden_us:.1f} of {copy_us:.1f} us of "
          f"copies ran beside a kernel over {PIPE_OVERLAP_PASSES} passes "
          f"(overlap share {overlap:.3f})", flush=True)
    fail_unless(copy_us > 0 and overlap >= PIPE_MIN_OVERLAP,
                f"prefetch: {hidden_us} of {copy_us} us of copies ran "
                f"beside a kernel, under {PIPE_MIN_OVERLAP}")

    vae = flagship_experiment_config().build(dev)
    x = torch.randn(1000, 2, generator=gen, device=dev)
    enc = utils.checked(lambda v: vae.encoder.mapping(v))
    with torch.no_grad():
        torch.testing.assert_close(enc(x), vae.encoder.mapping(x))
        x[5] = float("nan")
        before = _build.KERNELS["dense_stack"].launches
        try:
            enc(x)
            fail_unless(False, "checked let a NaN from kernel 2 through")
        except utils.CheckError as err:
            fail_unless("dense_stack kernel" in str(err),
                        f"checked named {err}")
            out["checked_message"] = str(err)
        fail_unless(_build.KERNELS["dense_stack"].launches > before,
                    "checked: kernel 2 did not launch")
    print(f"checked: {out['checked_message']}", flush=True)

    big = torch.randn(4096, 4096, generator=gen, device=dev)

    def work():
        h = big
        for _ in range(8):
            h = torch.tanh(h @ big) * 0.01
        return h

    # StepTimer's contract, against CUDA events recorded around the same
    # work inside each phase: fenced (ph.result set), a phase lasts at
    # least its device time; unfenced, it times only the host's enqueue,
    # which returns before the device is done.
    timer = utils.StepTimer()
    work()
    events = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        with timer.phase("fenced") as ph:
            start.record()
            ph.result = work()
            end.record()
        events.append(start.elapsed_time(end) / 1e3)
        with timer.phase("unfenced"):
            work()
        sync(dev)
    events_s = sum(events) / len(events)
    bench_s = utils.benchmark_fn(lambda m: work(), big, iters=5)
    fenced, unfenced = timer.mean("fenced"), timer.mean("unfenced")
    out.update(step_timer_s=fenced, unfenced_s=unfenced, events_s=events_s,
               benchmark_fn_s=bench_s)
    fail_unless(all(t >= e for t, e in zip(timer.times["fenced"], events))
                and (unfenced < events_s or dev.type != "cuda"),
                f"StepTimer fenced {timer.times['fenced']} s, unfenced "
                f"{timer.times['unfenced']} s, CUDA events {events} s")
    print(f"StepTimer fenced {1e3 * fenced:.3f} ms, unfenced (the enqueue) "
          f"{1e3 * unfenced:.3f} ms, CUDA events {1e3 * events_s:.3f} ms in "
          f"the same phases; benchmark_fn {1e3 * bench_s:.3f} ms", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with utils.trace(tmp):
            with torch.no_grad():
                vae.encoder.mapping(torch.randn(1000, 2, device=dev))
            sync(dev)
        traces = [f for _, _, fs in os.walk(tmp) for f in fs
                  if f.endswith(".json") or f.endswith(".json.gz")]
        fail_unless(bool(traces), "trace() wrote no trace file")
    RESULTS["pipeline_utils"] = out
    return out


# ---------------------------------------------------------------------------
# Slice 15: the member axis (example 09's ensemble above, through one
# vmapped step) and example 30, committee active learning
# ---------------------------------------------------------------------------

# Example 30 at its default depths: atoms, density, the cold (training)
# and hot (deployment) kT, committee members, initial frames, frames
# acquired a round, rounds, committee train steps initially and a round,
# bootstrap batch; the validation and deployment chains, deployment MD
# steps and its collection stride, the label MD's steps (cold, hot).
AL30_N, AL30_RHO, AL30_KT_COLD, AL30_KT_HOT, AL30_K = 8, 0.4, 0.7, 2.2, 3
AL30_INIT, AL30_ACQ, AL30_ROUNDS = 96, 48, 2
AL30_STEPS_INIT, AL30_STEPS_ROUND, AL30_BATCH = 350, 300, 32
AL30_VAL, AL30_DEPLOY, AL30_MD_STEPS, AL30_COLLECT = 64, 32, 600, 25
AL30_COLD_STEPS, AL30_HOT_STEPS = 1500, 2500
# Committee train steps a captured chunk: each capture's eager warm-up
# runs this many steps (one capture a data size, as JAX compiles one
# program a size).
AL30_CHUNK = 10


def al30_box():
    return (AL30_N / AL30_RHO) ** (1.0 / 3.0)


def al30_frames(gen, pot, n_frames, kt, n_steps, dev):
    """Example 30's ``equilibrium_frames``: uniform starts relaxed by 300
    ``minimize_energy`` steps at lr 0.05, then ``n_steps`` BAOAB steps
    (dt 0.003, friction 1) replayed through md._BAOAB, wrapped into the
    box."""
    L = al30_box()
    x0 = L * torch.rand(n_frames, AL30_N, 3, generator=gen, device=dev)
    x0 = potentials.minimize_energy(pot, x0, steps=300, lr=0.05)
    dyn = md._BAOAB(pot, dt=0.003, kt=kt, friction=1.0, masses=1.0)
    st, _ = dyn.scan(dyn.start(x0, torch.zeros_like(x0)), n_steps, gen)
    return st.x - L * torch.floor(st.x / L)


def al30_label(pot, x):
    """The ground-truth oracle: energies and forces."""
    return md._force_fn(pot)(x)


def al30_closest(x):
    """Per frame, the minimum-image closest approach."""
    L = al30_box()
    d = x[..., :, None, :] - x[..., None, :, :]
    d = d - L * torch.round(d / L)
    r2 = (d * d).sum(-1) + 1e9 * torch.eye(AL30_N, device=x.device)
    return torch.sqrt(r2.amin((-2, -1)))


def al30_train(stack, data, species, box, steps, seed, dev):
    """Example 30's ``make_trainer``: ``steps`` steps of the whole
    committee from fresh Adam moments (optax's adam at 3e-3), each member
    on its own bootstrap batch of AL30_BATCH frames drawn without
    replacement from its own generator, the members' losses
    (``energy_force_loss``, w_energy 0.1) one vmapped gradient, the loop
    replayed through scan_collect in chunks of AL30_CHUNK steps with the
    members' generators registered.  Writes the trained weights into the
    stack; returns the last step's mean loss."""
    from vaemolsim_tpu_torch.train import EnsembleAdam
    from vaemolsim_tpu_torch.utils.scan import scan_collect
    x, e, f = data
    n = x.shape[0]
    trainer = EnsembleAdam(stack, lambda m, ix: energy_force_loss(
        m, x[ix], species, e[ix], f[ix], box=box, w_energy=0.1,
        w_force=1.0), learning_rate=3e-3)
    gens = [torch.Generator(device=dev).manual_seed(seed + i)
            for i in range(len(stack))]

    def step(carry):
        state, _ = carry
        idx = torch.stack([torch.rand(n, generator=g, device=dev).argsort()
                           [:AL30_BATCH] for g in gens])
        state, loss = trainer.update(state, idx, in_dims=(0,))
        return state, loss.mean()

    (state, loss), _ = scan_collect(
        step, (trainer.init(), torch.zeros((), device=dev)), steps,
        chunk=AL30_CHUNK, generators=gens)
    trainer.write(state)
    return float(loss)


def al30_committee(stack, species, box):
    """The committee-mean potential: the members' energies averaged, one
    vmapped call over the stack."""
    return lambda x: stack.vmap(lambda m, c: m(c, species, box), x).mean(0)


def active_learning_path(dev):
    """examples/30_active_learning.py at its default depths: a committee
    of AL30_K SchNets (features 16, 2 blocks, 12 RBFs, cutoff 2.2) stacked
    on the member axis, trained on AL30_INIT cold frames (kT 0.7) of the
    periodic 8-atom LJ fluid (AL30_STEPS_INIT steps), deployed for
    AL30_ROUNDS rounds of AL30_MD_STEPS steps of committee-mean MD at kT
    2.2 from AL30_DEPLOY hot frames (a frame every AL30_COLLECT steps),
    labelling the AL30_ACQ frames of highest committee force
    disagreement and retraining AL30_STEPS_ROUND steps; then the
    random-acquisition control from the same initial committee and
    budget, and the example's four asserts.  Every MD run (labels and
    committee) is replayed by md._BAOAB and every training run by
    al30_train's scan_collect; no port kernel runs (SchNet has none)."""
    from vaemolsim_tpu_torch.nn import (ensemble_energy_forces,
                                        max_force_uncertainty)
    from vaemolsim_tpu_torch.utils import scan
    L = al30_box()
    box = torch.full((3,), L, device=dev)
    true_pot = potentials.lennard_jones(box=(L, L, L), cutoff=2.2,
                                        device=dev)
    species = torch.ones(AL30_N, 1, device=dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    x_tr = al30_frames(torch.Generator(device=dev).manual_seed(0), true_pot,
                       AL30_INIT, AL30_KT_COLD, AL30_COLD_STEPS, dev)
    e_tr, f_tr = al30_label(true_pot, x_tr)
    x_val = al30_frames(torch.Generator(device=dev).manual_seed(1), true_pot,
                        AL30_VAL, AL30_KT_HOT, AL30_HOT_STEPS, dev)
    e_val, f_val = al30_label(true_pot, x_val)
    f_rms = float(torch.sqrt((f_val ** 2).mean()))
    sync(dev)
    label_s = time.perf_counter() - t0
    stack = stack_models([SchNetPotential.create(
        torch.Generator(device=dev).manual_seed(10 + i), 1, features=16,
        num_blocks=2, n_rbf=12, cutoff=2.2, device=dev)
        for i in range(AL30_K)])

    def validate(st, tag):
        with torch.no_grad():
            pred = ensemble_energy_forces(st, x_val, species, box)
            unc = float(max_force_uncertainty(st, x_val, species, box).mean())
        rmse = float(torch.sqrt(((pred.forces - f_val) ** 2).mean()))
        print(f"  [{tag}] hot-ensemble force RMSE {rmse:.3f} "
              f"({100 * rmse / f_rms:.1f}% of rms), committee uncertainty "
              f"{unc:.3f}", flush=True)
        return rmse, unc

    sync(dev)
    t1 = time.perf_counter()
    loss0 = al30_train(stack, (x_tr, e_tr, f_tr), species, box,
                       AL30_STEPS_INIT, 2, dev)
    sync(dev)
    train_s = [time.perf_counter() - t1]
    train_steps = [AL30_STEPS_INIT]
    print(f"initial committee trained ({AL30_STEPS_INIT} steps, final loss "
          f"{loss0:.4f})", flush=True)
    rmse0, _ = validate(stack, "round 0")
    stack0 = copy.deepcopy(stack)     # the control branches from here

    md_gen = torch.Generator(device=dev).manual_seed(3)
    sel_closest, flagged, traj1, md_s = [], [], None, 0.0
    for rnd in range(1, AL30_ROUNDS + 1):
        dyn = md._BAOAB(al30_committee(stack, species, box), dt=0.003,
                        kt=AL30_KT_HOT, friction=1.0, masses=1.0)
        x0 = x_val[:AL30_DEPLOY]
        sync(dev)
        t2 = time.perf_counter()
        traj = dyn.run(x0, torch.zeros_like(x0), AL30_MD_STEPS, md_gen,
                       False, AL30_COLLECT)
        sync(dev)
        md_s += time.perf_counter() - t2
        frames = traj.reshape(-1, AL30_N, 3)
        frames = frames - L * torch.floor(frames / L)
        if traj1 is None:
            traj1 = frames
        with torch.no_grad():
            u = max_force_uncertainty(stack, frames, species, box)
        top = torch.argsort(-u)[:AL30_ACQ]
        x_new = frames[top]
        sel_closest.append(float(al30_closest(x_new).mean()))
        e_new, f_new = al30_label(true_pot, x_new)
        x_tr, e_tr, f_tr = (torch.cat([a, b]) for a, b in
                            ((x_tr, x_new), (e_tr, e_new), (f_tr, f_new)))
        u_before = float(u[top].median())
        print(f"round {rnd}: flagged {AL30_ACQ}/{frames.shape[0]} frames "
              f"(median u {u_before:.3f} vs trajectory "
              f"{float(u.mean()):.3f}); retraining on {x_tr.shape[0]} "
              f"labels", flush=True)
        sync(dev)
        t1 = time.perf_counter()
        al30_train(stack, (x_tr, e_tr, f_tr), species, box,
                   AL30_STEPS_ROUND, 10 * rnd, dev)
        sync(dev)
        train_s.append(time.perf_counter() - t1)
        train_steps.append(AL30_STEPS_ROUND)
        with torch.no_grad():
            u_after = float(max_force_uncertainty(
                stack, x_new, species, box).median())
        flagged.append((u_before, u_after))
        rmse_al, _ = validate(stack, f"round {rnd}")

    pick = torch.rand(traj1.shape[0], generator=md_gen,
                      device=dev).argsort()[:AL30_ROUNDS * AL30_ACQ]
    x_rnd = traj1[pick]
    e_rnd, f_rnd = al30_label(true_pot, x_rnd)
    rnd_data = tuple(torch.cat([a[:AL30_INIT], b]) for a, b in
                     ((x_tr, x_rnd), (e_tr, e_rnd), (f_tr, f_rnd)))
    for r in range(AL30_ROUNDS):
        sync(dev)
        t1 = time.perf_counter()
        al30_train(stack0, rnd_data, species, box, AL30_STEPS_ROUND,
                   100 + 10 * r, dev)
        sync(dev)
        train_s.append(time.perf_counter() - t1)
        train_steps.append(AL30_STEPS_ROUND)
    rmse_rnd, _ = validate(stack0, "random-acquisition control")
    mean_cold = float(al30_closest(x_tr[:AL30_INIT]).mean())
    counts = path_counts("active_learning")
    fail_unless(sum(counts.values()) == 0,
                f"example 30 launched port kernels: {counts}")
    print(f"acquired-frame closest approach {sel_closest[0]:.3f} vs "
          f"cold-data mean {mean_cold:.3f}; flagged-frame uncertainty "
          "before->after retrain: " + ", ".join(
              f"{b:.3f}->{a:.3f}" for b, a in flagged), flush=True)
    fail_unless(rmse_al < 0.7 * rmse0,
                f"example 30: AL RMSE {rmse_al} not below 0.7 x {rmse0}")
    fail_unless(rmse_al < 0.9 * rmse_rnd,
                f"example 30: AL RMSE {rmse_al} not below 0.9 x the random "
                f"control's {rmse_rnd}")
    fail_unless(all(a < 0.8 * b for b, a in flagged),
                f"example 30: flagged-frame uncertainty {flagged}")
    fail_unless(sel_closest[0] < mean_cold,
                f"example 30: acquired closest approach {sel_closest} not "
                f"below the cold data's {mean_cold}")
    # The committee steps of the timed runs (train_s), and only those.
    steps, wall = sum(train_steps), sum(train_s)
    probe = copy.deepcopy(stack)
    data = (x_tr, e_tr, f_tr)
    row = replay_row(
        "active_learning_train", wall, steps, steps / wall, "committee "
        "steps/s", counts,
        lambda: al30_train(probe, data, species, box, AL30_CHUNK, 7, dev),
        AL30_CHUNK,
        lambda: al30_train(probe, data, species, box, 4 * AL30_CHUNK, 7,
                           dev),
        3 * AL30_CHUNK, dev, skip=1, label_md_seconds=label_s,
        committee_md_seconds=md_s, train_seconds=train_s,
        train_steps=train_steps,
        rmse=dict(initial=rmse0, active=rmse_al, random=rmse_rnd,
                  f_rms=f_rms),
        flagged_uncertainty=flagged, selected_closest=sel_closest,
        cold_closest=mean_cold)
    print(f"example 30: OK (AL {100 * rmse_al / f_rms:.1f}% vs random "
          f"{100 * rmse_rnd / f_rms:.1f}% vs initial "
          f"{100 * rmse0 / f_rms:.1f}% of force rms); labels {label_s:.2f} "
          f"s, committee MD {md_s:.2f} s "
          f"({1e3 * md_s / (AL30_ROUNDS * AL30_MD_STEPS):.4f} ms a step, "
          f"capture included), committee training "
          f"{', '.join(f'{v:.2f}' for v in train_s)} s", flush=True)
    with scan.eager():
        sync(dev)
        t2 = time.perf_counter()
        dyn.run(x0, torch.zeros_like(x0), AL30_COLLECT, md_gen, False,
                AL30_COLLECT)
        sync(dev)
        row["committee_md_ms_eager"] = (1e3 * (time.perf_counter() - t2)
                                        / AL30_COLLECT)
    row["committee_md_ms_replayed"] = 1e3 * md_s / (AL30_ROUNDS
                                                    * AL30_MD_STEPS)
    print(f"example 30: committee MD {row['committee_md_ms_replayed']:.4f} "
          f"ms a step replayed (capture included) against "
          f"{row['committee_md_ms_eager']:.4f} eager", flush=True)
    return row


_T0 = time.perf_counter()
SLICE12_PHASES = (triclinic_npt_path, charged_crystal_path,
                  remd_flow_matching_path, extrapolation_path, hrex_path,
                  pimd_path, dynamics_path)
SLICE13A_PHASES = (scan_replay_path, metadynamics_path, opes_eabf_path,
                   tps_path, committor_path)
SLICE13B_PHASES = (kinetics_path, weighted_ensemble_path, rare_event_path)
SLICE13C_PHASES = (difftre_path, cg_path)
SLICE14A_PHASES = (score_diffusion_path, painn_path)
SLICE14B_PHASES = (distributed_path, pipeline_utils_path)
SLICE15_PHASES = (active_learning_path,)


def build_kernels(out):
    """_build.build_all() into ``out``: its libraries and seconds, or
    the error it raised (for a thread; main raises it after the join)."""
    t0 = time.perf_counter()
    try:
        out["libs"] = _build.build_all()
    except BaseException as err:
        out["error"] = err
    out["seconds"] = time.perf_counter() - t0


def stamped(phase, *args):
    """phase(*args), with the script's elapsed seconds at its start and
    end printed."""
    t0 = time.perf_counter()
    print(f"phase {phase.__name__} starts at {t0 - _T0:.1f} s", flush=True)
    out = phase(*args)
    t1 = time.perf_counter()
    RESULTS.setdefault("phase_seconds", {})[phase.__name__] = t1 - t0
    print(f"phase {phase.__name__} took {t1 - t0:.1f} s", flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    # nvcc compiles in a thread (it waits on its processes, so the host
    # stays free) while the slice-11 phases that launch no kernel run;
    # the kernel checks and every other phase come after the build.
    build = {}
    build_thread = threading.Thread(target=build_kernels, args=(build,))
    build_thread.start()
    try:
        water = stamped(rigid_water_path, dev)
        ensembles = stamped(npt_gcmc_gibbs_path, dev)
        alch = stamped(alchemical_path, dev)
    finally:
        build_thread.join()
    if "error" in build:
        raise build["error"]
    print(f"built {sorted(build['libs'])} in {build['seconds']:.1f} s, "
          f"beside the phases that launch no kernel", flush=True)
    for src in ("rqs", "dense_stack", "vae_proposal", "maf_block",
                "cell_lj", "pair_attention"):
        for line in _build.BUILD_LOGS.get(src, "(cached)").splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "(cached)")):
                print(f"ptxas {src}: {line.strip()}", flush=True)

    vae = flagship_experiment_config().build(dev)
    flow = ExperimentConfig(model=FlowModelConfig(FlowedDistConfig(
        MAFConfig(data_dim=FLOW_D, num_blocks=2, rqs=RQSParams()),
        base=None, static_base_dim=FLOW_D))).build(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        check_rqs(vae, gen, dev)
        check_dense_stack(vae, gen, dev)
        x1, seed, args = check_proposal(vae, gen, dev)
        check_philox_samples(vae, x1, seed, args)
        # The launch floor: an empty kernel's device time, by the same
        # events behind a device spin as every kernel's.
        RESULTS["launch_floor_ms"] = timed(lambda: torch.cuda._sleep(0))
        check_maf_block(flow, gen, dev)
        check_pair_attention(backmapping_experiment_config().build(dev),
                             gen, dev)

    generic = run_path("generic", make_mcmc_step(*vae_proposal_fns(vae),
                                                 log_target), dev)
    fused = run_path("fused", make_fused_vae_step(vae, log_target), dev)
    fail_unless(generic["rqs"] > 0 and generic["dense_stack"] > 0,
                f"generic path launch counts {generic}")
    fail_unless(fused["vae_proposal"] > 0,
                f"fused path launch counts {fused}")
    elbo = stamped(elbo_path, dev)
    flow_row, predict = stamped(flow_path, flow, dev)
    with torch.no_grad():
        check_maf_block(flow, gen, dev, label=" trained")
    bm_serve, bm_train = stamped(backmapping_path, dev)
    mol, mol_row, mol_state = stamped(molecular_path, dev)
    lj, lj_row, lj_state = stamped(lj_path, dev)
    check_cell_lj(mol, mol_state.x, lj, lj_state.x, dev)
    realnvp, rnvp_row, rnvp_sample = stamped(realnvp_1d_path, dev)
    stats = stamped(statistics_path, vae, dev)
    hmc = stamped(molecular_hmc_path, dev)
    fe10, fe40, flow2d, x_a = stamped(free_energy_path, dev)
    remc = stamped(remc_path, vae, dev)
    tempering = stamped(tempering_path, dev)
    with torch.no_grad():
        check_coupling_kernels(realnvp, flow2d, x_a, gen, dev)
    dual = stamped(dual_elbo_path, dev)
    hvae = stamped(hvae_path, dev)
    bn_model, flow_bn = stamped(flow_bn_path, dev)
    ensemble = stamped(ensemble_path, dev)
    bm_ar, made = stamped(backmapping_ar_path, dev)
    with torch.no_grad():
        check_slice9_kernels(made, bn_model, gen, dev)
    workflow = stamped(molecular_workflow_path, dev)
    joint = stamped(joint_backmapping_path, dev)
    mlp_md = stamped(ml_potential_md_path, dev)
    two_stage = stamped(two_stage_backmapping_path, dev)
    ckpt = stamped(mcmc_checkpoint_path, vae, dev)
    bf16 = stamped(bf16_flow_path, dev)
    stamped(repairs_path, dev)
    salt = stamped(molten_salt_path, dev)
    exact = stamped(molecular_exact_path, dev)
    bgen = stamped(boltzmann_generator_path, dev)
    chunked = stamped(chunked_stream_path, dev)
    tri = stamped(triclinic_npt_path, dev)
    crystal = stamped(charged_crystal_path, dev)
    rfm = stamped(remd_flow_matching_path, dev)
    extrap = stamped(extrapolation_path, dev)
    hrex = stamped(hrex_path, dev)
    ring = stamped(pimd_path, dev)
    dyn = stamped(dynamics_path, dev)
    stamped(scan_replay_path, dev)
    metad = stamped(metadynamics_path, dev)
    opes_abf = stamped(opes_eabf_path, dev)
    tps_row, geometry = stamped(tps_path, dev)
    committor = stamped(committor_path, geometry, dev)
    kinetics = stamped(kinetics_path, dev)
    ensemble27 = stamped(weighted_ensemble_path, dev)
    rare = stamped(rare_event_path, dev)
    dtre = stamped(difftre_path, dev)
    fm = stamped(cg_path, dev)
    ex28 = stamped(score_diffusion_path, dev)
    pn = stamped(painn_path, dev)
    dist_row = stamped(distributed_path, dev, mol, mol_state.x, vae)
    stamped(pipeline_utils_path, dev)
    al30 = stamped(active_learning_path, dev)
    fail_unless("jax" not in sys.modules, "jax was imported")

    launches = {"generic": generic, "fused": fused,
                "elbo_train": elbo["launches"],
                "flow_train": flow_row["launches"], "flow_sample": predict,
                "backmapping_serve": bm_serve["launches"],
                "backmapping_train": bm_train["launches"],
                "md_molecular": mol_row["launches"],
                "md_lj": lj_row["launches"],
                "flow_realnvp_1d_train": rnvp_row["launches"],
                "flow_realnvp_1d_sample": rnvp_sample,
                "statistics": stats["launches"],
                "molecular_hmc": hmc["launches"],
                "free_energy_10": fe10["launches"],
                "free_energy_40": fe40["launches"],
                "remc": remc["launches"],
                "tempering": tempering["launches"],
                "dual_elbo_train": dual["launches"],
                "hvae_train": hvae["launches"],
                "flow_bn_train": flow_bn["launches"],
                "flow_bn_sample": flow_bn["predict_launches"],
                "ensemble": ensemble["launches"],
                "backmapping_ar_train": bm_ar["launches"],
                "backmapping_ar_serve": bm_ar["serve_launches"],
                "molecular_workflow_train": workflow["launches"],
                "molecular_workflow_predict": workflow["predict_launches"],
                "joint_backmapping_schnet_train": joint["launches"],
                "joint_backmapping_attention_log_prob":
                    joint["attention_launches"],
                "joint_backmapping_attention_train":
                    joint["attention_train_launches"],
                "ml_potential_md": mlp_md["launches"],
                "two_stage_backmapping_serve": two_stage["launches"],
                "two_stage_backmapping_train": two_stage["train_launches"],
                "mcmc_checkpoint_fused": ckpt["fused"]["launches"],
                "mcmc_checkpoint_generic": ckpt["generic"]["launches"],
                "bf16_flow_train": bf16["launches"],
                "bf16_flow_sample": bf16["predict_launches"],
                "molten_salt": salt["launches"],
                "molecular_exact": exact["launches"],
                "rigid_water": water["launches"],
                "boltzmann_generator_train": bgen["launches"],
                "boltzmann_generator_sample": bgen["sample_launches"],
                "npt_gcmc_gibbs": ensembles["launches"],
                "alchemical": alch["launches"],
                "chunked_stream": chunked,
                "triclinic_npt": tri["launches"],
                "charged_crystal": crystal["launches"],
                "remd_flow_matching": rfm["launches"],
                "extrapolation": extrap["launches"],
                "hrex": hrex["launches"], "pimd": ring["launches"],
                "dynamics": dyn["launches"],
                "metadynamics": metad["launches"],
                "opes_eabf": opes_abf["launches"],
                "tps": tps_row["launches"],
                "committor": committor["launches"],
                "kinetics": kinetics["launches"],
                "weighted_ensemble": ensemble27["launches"],
                "rare_event": rare["launches"],
                "difftre": dtre["launches"],
                "cg_force_matching": fm["launches"],
                "score_diffusion_train": ex28["train_launches"],
                "score_diffusion_sample": ex28["launches"],
                "painn_md": pn["launches"],
                "example_08_train": dist_row["example_08"]["train_launches"],
                "example_08_generic":
                    dist_row["example_08"]["mc"]["generic"]["launches"],
                "example_08_fused":
                    dist_row["example_08"]["mc"]["fused"]["launches"],
                "sharded_cell_grid": dist_row["slabs"]["launches"],
                "active_learning": al30["launches"]}
    print("kernel launches on the main paths: " + json.dumps(
        {k: sum(v.values()) for k, v in launches.items()}), flush=True)
    bound = bounds(vae, flow)
    floor_us = 1e3 * RESULTS["launch_floor_ms"]
    for name, (us, by) in bound.items():
        floor = (f"; launch floor {floor_us:.4f} us (torch.cuda._sleep(0))"
                 if name.startswith("rqs") else "")
        print(f"bound {name:36s} {us:10.4f} us ({by}){floor}", flush=True)
    kernels = []
    n = SIZES[-1]
    main_shape = {"rqs": f"forward broadcast N={n}",
                  "dense_stack": f"encoder 2->200->2 relu N={n}",
                  "vae_proposal": f"philox N={n}",
                  "maf_block": f"inverse D={FLOW_D} N={TRAIN_BATCH}",
                  "pair_attention": PA_MAIN,
                  "cell_lj": MOL_SHAPE}
    # Kernel 3's bf16 mode and kernels 1 and 2's member axis are entries
    # of their own: their launches are the launches made in that mode
    # (the kernel's own entry counts them too).
    entries = [(name, k, name, None) for name, k in _build.KERNELS.items()]
    entries.append(("maf_block_bf16", _build.KERNELS["maf_block"],
                    "maf_block", "bf16"))
    main_shape["maf_block_bf16"] = f"inverse bf16 D={FLOW_D} N={TRAIN_BATCH}"
    for kname in ("rqs", "dense_stack"):
        entries.append((f"{kname}_members", _build.KERNELS[kname], kname,
                        "members"))
    main_shape["rqs_members"] = f"members M={ENS_K} forward"
    main_shape["dense_stack_members"] = f"members M={ENS_K} N=1"

    def mode_of(check):
        return ("bf16" if "bf16" in check["shape"] else "members"
                if check["shape"].startswith("members") else None)

    for name, k, kernel, mode in entries:
        rows = [c for c in RESULTS["checks"] if c["kernel"] == kernel
                and mode_of(c) == mode]
        timed_row = next(c for c in rows if c["ms"] is not None
                         and c["shape"].startswith(main_shape[name]))
        bound_us, bound_by = (bound[name] if mode is None else
                              (timed_row["bound_us"], timed_row["bound_by"]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"vaemolsim_tpu_torch/{k.source}",
            "replaces": k.replaces,
            "launches": sum(c.get(name, 0) for c in launches.values()),
            "max_abs_err": max(c["max_abs_err"] for c in rows),
            "ms": timed_row["ms"], "plain_ms": timed_row["plain_ms"],
            "bound_ms": bound_us / 1e3, "bound_us": bound_us,
            "bound_by": bound_by, "library_ms": None})
    fail_unless(all(k["launches"] > 0 for k in kernels),
                f"a kernel was not launched on the main path: {kernels}")
    RESULTS.update(card=card, kernels=kernels, launches=launches,
                   bounds={k: {"us": us, "by": by}
                           for k, (us, by) in bound.items()})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_results.json"),
              "w") as fh:
        json.dump(RESULTS, fh, indent=1)

    seconds = RESULTS["phase_seconds"]
    slice12 = sum(seconds[p.__name__] for p in SLICE12_PHASES)
    slice13a = sum(seconds[p.__name__] for p in SLICE13A_PHASES)
    slice13b = sum(seconds[p.__name__] for p in SLICE13B_PHASES)
    slice13c = sum(seconds[p.__name__] for p in SLICE13C_PHASES)
    slice14a = sum(seconds[p.__name__] for p in SLICE14A_PHASES)
    slice14b = sum(seconds[p.__name__] for p in SLICE14B_PHASES)
    slice15 = sum(seconds[p.__name__] for p in SLICE15_PHASES)
    print(f"slice-12 phases {slice12:.1f} s; slice-13a phases "
          f"{slice13a:.1f} s; slice-13b phases {slice13b:.1f} s; slice-13c "
          f"phases {slice13c:.1f} s; slice-14a phases {slice14a:.1f} s; "
          f"slice-14b phases {slice14b:.1f} s ("
          + ", ".join(f"{p.__name__} {seconds[p.__name__]:.1f} s"
                      for p in SLICE14B_PHASES) + f"); slice-15 phases "
          f"{slice15:.1f} s (ensemble_path "
          f"{seconds['ensemble_path']:.1f} s, on the member axis); the "
          f"script "
          f"{time.perf_counter() - _T0:.1f} s", flush=True)
    print("phase seconds: " + json.dumps(dict(sorted(
        ((k, round(v, 1)) for k, v in seconds.items()),
        key=lambda kv: -kv[1]))), flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

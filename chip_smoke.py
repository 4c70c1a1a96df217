#!/usr/bin/env python3
"""Drive vaemolsim_tpu_torch's flagship MC path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. builds the CUDA kernels from ``vaemolsim_tpu_torch/csrc`` (nvcc, one
   process per source, in parallel);
2. holds each kernel against its plain PyTorch version on the card, at
   the flagship's shapes (10k and 50k rows), with the tolerances stated
   beside each check, and times both;
3. checks the proposal kernel's own Philox draws: the plain version on
   the same seed, the densities of its samples recomputed through the
   model's distribution objects, and the moments of the normals it drew;
4. runs both MC paths on the full-width flagship (hidden 200, 32 bins,
   random weights from the config's seed) on a 2-D standard-normal
   target at 10k and 50k chains: the generic ``make_mcmc_step`` (dense
   stack + RQS kernels) and ``make_fused_vae_step`` (proposal kernel),
   with launch counters zeroed before and read after, and checks
   acceptance, finiteness, the chains' second moment and the counters.

Any failed check raises and the script exits non-zero; there is no CPU
fallback.  The last stdout lines are the card's name and power limit,
one JSON line of per-kernel results, and
``{"ok": true, "device": {...}}``.  The full results also go to
``chiprun_out/chip_smoke_results.json``.  TF32 is off throughout, so
every float32 product is a float32 product.
"""

import copy
import json
import math
import os
import subprocess
import sys
import time

import torch

from vaemolsim_tpu_torch import _build
from vaemolsim_tpu_torch.config import flagship_experiment_config
from vaemolsim_tpu_torch.flows.spline_flows import _bin_positions, _slopes
from vaemolsim_tpu_torch.mcmc import (MCMCState, make_fused_vae_step,
                                      make_mcmc_step, run_mcmc,
                                      vae_proposal_fns)
from vaemolsim_tpu_torch.mcmc import fused as mf
from vaemolsim_tpu_torch.ops import rqs
from vaemolsim_tpu_torch.ops.fused_mlp import (dense_stack_cuda,
                                               dense_stack_plain)

SIZES = (10_000, 50_000)
WARMUP_STEPS, TIMED_STEPS = 20, 200
RESULTS = {"checks": [], "mc": []}


def fail_unless(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed(fn, reps=20):
    """Mean device milliseconds of fn() over reps, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def record(kernel, shape, max_err, ms=None, plain_ms=None):
    RESULTS["checks"].append({"kernel": kernel, "shape": shape,
                              "max_abs_err": max_err, "ms": ms,
                              "plain_ms": plain_ms})
    t = "" if ms is None else f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
    print(f"check {kernel:12s} {shape:44s} max_abs_err {max_err:.3e}{t}",
          flush=True)


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
                ms = plain_ms = None
                if n == SIZES[-1]:
                    ms = timed(lambda: rqs.rqs_cuda(x, *params, range_min,
                                                    inverse))
                    plain_ms = timed(lambda: plain(x, *params, range_min))
                shape = (f"{'inverse' if inverse else 'forward'} {pname} "
                         f"N={n} K={K}")
                record("rqs", shape, err, ms, plain_ms)


def check_dense_stack(vae, gen, dev):
    """The flagship encoder (2->200->2 relu) and decoder (1->200->4 relu)
    with their own weights; 1->200->95 tanh with and without a 3-wide
    conditional input; and the one-row merged MAF conditioner
    (1->600->95 tanh).  Float32 sums of up to 600 terms in another
    order than cuBLAS's: 1e-4 + 1e-4|y|."""
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
        ("MAF conditioner 1->600->95 tanh", 1,
         ([k1.detach(), k2.detach()], [b1.detach(), b2.detach()], None),
         ["tanh", None], 0, (1,)),
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
            if n == SIZES[-1] or sizes == (1,):
                ms = timed(lambda: dense_stack_cuda(x, ks, bs, acts, c, cks))
                plain_ms = timed(lambda: dense_stack_plain(x, ks, bs, acts,
                                                           c, cks))
            record("dense_stack", f"{name} N={n}", err, ms, plain_ms)


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
            ms = plain_ms = None
            if n == SIZES[-1]:
                ms = timed(lambda: mf.vae_proposal_cuda(*args))
                plain_ms = timed(lambda: mf.vae_proposal_plain(*args))
            record("vae_proposal", f"{mode} N={n} H=200 K=32 B=2", err, ms,
                   plain_ms)
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


# ---------------------------------------------------------------------------
# The main path: both MC steps on the full-width flagship
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
        RESULTS["mc"].append({"path": name, "chains": n, "steps":
                              TIMED_STEPS, "seconds": dt,
                              "proposals_per_s": rate, "acceptance": acc,
                              "second_moment": m2})
        print(f"mc {name:8s} N={n:6d} {rate:14.1f} proposals/s  "
              f"({dt * 1e3 / TIMED_STEPS:.3f} ms/step)  acceptance "
              f"{acc:.4f}  E[x^2] {m2:.4f}", flush=True)
    return _build.launch_counts()


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

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {sorted(libs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)

    vae = flagship_experiment_config().build(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        check_rqs(vae, gen, dev)
        check_dense_stack(vae, gen, dev)
        x1, seed, args = check_proposal(vae, gen, dev)
        check_philox_samples(vae, x1, seed, args)

    generic = run_path("generic", make_mcmc_step(*vae_proposal_fns(vae),
                                                 log_target), dev)
    fused = run_path("fused", make_fused_vae_step(vae, log_target), dev)
    fail_unless(generic["rqs"] > 0 and generic["dense_stack"] > 0,
                f"generic path launch counts {generic}")
    fail_unless(fused["vae_proposal"] > 0,
                f"fused path launch counts {fused}")
    fail_unless("jax" not in sys.modules, "jax was imported")

    kernels = []
    main_shape = {"rqs": "forward broadcast N=50000",
                  "dense_stack": "encoder 2->200->2 relu N=50000",
                  "vae_proposal": "philox N=50000"}
    for name, k in _build.KERNELS.items():
        rows = [c for c in RESULTS["checks"] if c["kernel"] == name]
        timed_row = next(c for c in rows
                         if c["shape"].startswith(main_shape[name]))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"vaemolsim_tpu_torch/{k.source}",
            "replaces": k.replaces,
            "launches": generic[name] + fused[name],
            "max_abs_err": max(c["max_abs_err"] for c in rows),
            "ms": timed_row["ms"], "plain_ms": timed_row["plain_ms"]})
    fail_unless(all(k["launches"] > 0 for k in kernels),
                f"a kernel was not launched on the main path: {kernels}")
    RESULTS.update(card=card, kernels=kernels,
                   launches={"generic": generic, "fused": fused})
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke_results.json"),
              "w") as fh:
        json.dump(RESULTS, fh, indent=1)

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Kernels of this checkout against another checkout's, on one H100, in
turns: the other, this, this, the other (twice over for the paths' wall
times).

    python3 chip_turns.py OTHER_DIR [--targets md,backmapping,mc]
                          [--out chiprun_out/chip_turns.json]

OTHER_DIR holds another commit's tree, for example the parent's,
unpacked by ``git archive <commit> | tar -x -C OTHER_DIR`` into a
directory that git ignores.  Each target builds the other's sources of
its kernels and loads their wrappers beside this checkout's: ``md``
kernel 6 (``csrc/cell_lj.cu``, ``ops/cell_lj.py``), ``backmapping``
kernel 5 (``csrc/pair_attention.cu``, ``ops/attention.py``), ``mc``
kernels 4 and 1 (``csrc/vae_proposal.cu``, ``mcmc/fused.py``;
``csrc/rqs.cu``, ``ops/rqs.py``).  All three by default.  In one
process, it measures:

- kernel 6 at both MD paths' final states (the molecular stack and the
  LJ liquid of chip_smoke.py), kernel 5 at the backmapping notebook's
  shapes (B = 2000 and serving's 10 000, both modes) and at N = 50 and
  N = 37: CUDA events behind a device spin (``chip_smoke.timed``),
  torch.profiler's device µs per recorded launch, and the host µs a
  call takes to enqueue (wrapper and launch);
- kernel 5's two regimes forced over N = 6 .. 64 at H = 16 .. 200, in
  both modes (events), the data for the rule of
  ``ops/attention.kernel_plan``;
- the phase split of this checkout's kernels: copies of the source with
  one phase cut out by text replacement (their results are wrong by
  design; only their times are read);
- the MD steps' wall ms per step (MD_TIMED steps ending in a sync) and
  device busy per step of a profiled rebuild chunk, and backmapping
  ``predict``'s wall ms per call at 10k sites and its device busy, with
  each checkout's kernel swapped into the path;
- ``mc``: kernel 4 on the flagship (d_x = 2, H = 200, K = 32, B = 2,
  relu) at 10k and 50k chains in Philox and noise-input modes, kernel 1
  on the flagship prior's row at 10k and 50k (broadcast, both
  directions) and on per-element rows at 50k, the same three ways as
  kernels 5 and 6, each case with its launch plan; the launch floor (an
  empty ``torch.cuda._sleep(0)``, timed the same way); the phase splits
  of kernel 4 and of kernel 1 on the broadcast row; kernel 1's threads
  a block swept on the broadcast row, by events; the generic and fused
  MC steps at 50k chains (wall ms per step over 200 steps, device busy
  per step of 20 profiled steps) and the ELBO train step at batch 10k
  (wall ms per step over 2 epochs, device busy per step of a profiled
  epoch), with each checkout's kernels 1 and 4 swapped into the paths.

Prints the card's name and power limit first; writes every number to
the JSON file.  Needs one card and nvcc, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from vaemolsim_tpu_torch import _build, md, potentials
from vaemolsim_tpu_torch.config import (OptimizerConfig,
                                        backmapping_experiment_config,
                                        flagship_experiment_config)
from vaemolsim_tpu_torch.mcmc import (MCMCState, make_fused_vae_step,
                                      make_mcmc_step, run_mcmc,
                                      vae_proposal_fns)
from vaemolsim_tpu_torch.mcmc import fused as mf
from vaemolsim_tpu_torch.nn.attention import VectorAttention
from vaemolsim_tpu_torch.ops import attention as pa
from vaemolsim_tpu_torch.ops import cell_lj, rqs
from vaemolsim_tpu_torch.train import fit

HERE = Path(__file__).resolve().parent
BUILD = HERE / "vaemolsim_tpu_torch" / "_build_cache" / "turns"
ORDER = ("other", "this", "this", "other")
DEVICE, SWEEP_B = "cuda:0", 1000
SWEEP_H, SWEEP_N = (16, 40, 64, 100, 128, 200), (6, 10, 20, 37, 50, 64)
OUT: dict = {"kernels": {}, "sweep": {}, "phases": {}, "paths": {}}
# Each target: {source stem: wrapper module path under the package}.
TARGETS = {"md": {"cell_lj": "ops/cell_lj.py"},
           "backmapping": {"pair_attention": "ops/attention.py"},
           "mc": {"vae_proposal": "mcmc/fused.py", "rqs": "ops/rqs.py"}}
ELBO_EPOCHS = 2

# Phase-split copies: {source stem: {label: [(old, new), ...]}}; every old
# text must occur in the source.
PHASES = {
    "cell_lj": {
        "count pass only": [
            ("  __syncthreads();\n\n  // Exclusive scan",
             "  __syncthreads();\n  return;\n\n  // Exclusive scan")],
        "+ compaction": [
            ("  __pipeline_wait_prior(0);\n  __syncthreads();\n",
             "  __pipeline_wait_prior(0);\n  __syncthreads();\n  return;\n")],
        "+ chunk boxes, centre loop, cluster sums": [
            ("        pair(q[lane]);\n", "\n"),
            ("    if (lane < qn) pair(q[lane]);", ""),
            ("for (int cb0 = 0; cb0 < nbox; cb0 += 32) {",
             "for (int cb0 = 0; cb0 < 0; cb0 += 32) {")],
        "+ cheap pass (no expensive branch)": [
            ("        pair(q[lane]);\n", "\n"),
            ("    if (lane < qn) pair(q[lane]);", "")],
        "full, no chunk pruning": [
            ("        hit = gap2 <= rcs2;", "        hit = true;")],
    },
    "pair_attention": {
        "staging only": [
            ("  __pipeline_commit();\n  __pipeline_wait_prior(0);\n"
             "  __syncthreads();\n\n  // The invariants",
             "  __pipeline_commit();\n  __pipeline_wait_prior(0);\n"
             "  __syncthreads();\n  return;\n\n  // The invariants")],
        "+ invariants": [
            ("                           xj * xj + yj * yj + zj * zj);\n"
             "  }\n  __syncthreads();\n",
             "                           xj * xj + yj * yj + zj * zj);\n"
             "  }\n  __syncthreads();\n  return;\n")],
        "no score loop": [
            ("      if (mi * msk(f)[j] > 0.5f) {", "      if (false) {")],
        "no value loop": [
            ("    for (int j = 0; j < N; ++j) {\n      const float alpha",
             "    for (int j = 0; j < 0; ++j) {\n      const float alpha")],
        "no value head": [
            ("      for (int k = 0; k < H; ++k) v = fmaf(acc[k], w2v[k * Fo + o]"
             ", v);\n      p.out[((b0 + f) * N + i) * Fo + o]",
             "      p.out[((b0 + f) * N + i) * Fo + o]")],
    },
    "rqs": {
        "load and store only": [
            ("  for (int t = threadIdx.x; t < 3 * K - 1; t += blockDim.x)\n"
             "    raw[t] = t < K ? w[t] : t < 2 * K ? h[t - K] : "
             "s[t - 2 * K];\n  __syncthreads();\n"
             "  for (int k = threadIdx.x; k <= K; k += blockDim.x)\n"
             "    rqs_table_knot(raw, raw + K, raw + 2 * K, K, range_min, k, "
             "tab);\n  __syncthreads();\n", ""),
            ("  if (i < n) rqs_eval_table<kInverse>(v, tab, K, range_min, "
             "y[i], ldj[i]);", "  if (i < n) y[i] = v, ldj[i] = 0.f;")],
        "+ staging and knot table": [
            ("  if (i < n) rqs_eval_table<kInverse>(v, tab, K, range_min, "
             "y[i], ldj[i]);",
             "  if (i < n) y[i] = v + tab[0], ldj[i] = 0.f;")],
        "no search (bin 0)": [
            ("  if (i < n) rqs_eval_table<kInverse>(v, tab, K, range_min, "
             "y[i], ldj[i]);",
             "  const int kp = rqs_knot_stride(K);\n"
             "  const float4* b = reinterpret_cast<const float4*>(tab + 2 * "
             "kp);\n  if (i < n)\n    rqs_apply<kInverse>(v, b[0].x, b[0].y, "
             "b[0].z, b[0].w, b[1].x, b[1].y, range_min,\n"
             "                        tab[(kInverse ? kp : 0) + K], y[i], "
             "ldj[i]);")],
    },
    "vae_proposal": {
        "staging + knot tables only": [
            ("                   tabs + b * TF);\n  }\n",
             "                   tabs + b * TF);\n  }\n  return;\n")],
        "no Philox, Box-Muller": [
            ("draw_normals<kNoise>(i, p.seed, eps);",
             "for (int j = 0; j < kNoise; ++j) eps[j] = 0.25f * j - 0.5f;")],
        "no encoder passes": [
            ("mlp<R, DX, 2, S::kEnc, R>(xin, enc, Hp,",
             "mlp<R, DX, 2, S::kEnc, R>(xin, enc, 0,")],
        "no decoder pass": [
            ("mlp<2 * R, 1, 2 * DX, S::kDec, R>(zin, dec, Hp,",
             "mlp<2 * R, 1, 2 * DX, S::kDec, R>(zin, dec, 0,")],
        "no spline walks (search + rqs_apply)": [
            ("rqs_eval_table<false>(zf, tabs + b * TF, K, p.range_min, zf, "
             "lf);", "lf = 0.f;"),
            ("rqs_eval_table<true>(zi, tabs + (B - 1 - b) * TF, K, "
             "p.range_min, zi, li);", "li = 0.f;")],
    },
}


def nvcc(src: Path, out: Path, include: Path) -> subprocess.Popen:
    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o",
         str(out), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def bind(proc: subprocess.Popen, path: Path, kernel: _build.Kernel):
    """(entry point, error-string function) of a library built by
    ``proc``, bound like ``kernel``'s own; ptxas's lines are printed."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"build of {path.name} failed:\n{log}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas {path.stem}: {line.strip()}", flush=True)
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    err = lib.vms_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def load_other(other: Path, module: str, proc, path):
    """The other checkout's wrapper module (``module``, a path under the
    package), its kernel bound to the library that ``proc`` built from
    its source; the launch-count registry keeps this checkout's
    kernels."""
    saved = dict(_build.KERNELS)
    spec = importlib.util.spec_from_file_location(
        f"other_{Path(module).stem}", other / "vaemolsim_tpu_torch" / module)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _build.KERNELS.clear()
    _build.KERNELS.update(saved)
    mod.KERNEL._fn, mod.KERNEL._err = bind(proc, path, mod.KERNEL)
    return mod


def build_phases(stem: str):
    src = (_build.SRC_DIR / f"{stem}.cu").read_text()
    procs = {}
    for i, (label, reps) in enumerate(PHASES[stem].items()):
        text = src
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"phase copy {stem} '{label}': text not "
                                   f"found: {old!r}")
            text = text.replace(old, new)
        path = BUILD / f"{stem}_phase{i}.cu"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        procs[label] = (nvcc(path, path.with_suffix(".so"), _build.SRC_DIR),
                        path.with_suffix(".so"))
    return procs


class swapped:
    """Within the block, ``kernel`` launches the given (fn, err)."""

    def __init__(self, kernel, fn_err):
        self.k, self.fe = kernel, fn_err

    def __enter__(self):
        self.saved = (self.k._fn, self.k._err)
        self.k._fn, self.k._err = self.fe

    def __exit__(self, *exc):
        self.k._fn, self.k._err = self.saved


def dev_us(fn, match, reps=10):
    fn()
    _, prof = cs.profiled(lambda: [fn() for _ in range(reps)])
    return cs.launch_us(prof, match)


def host_us(fn, reps=20):
    """Host µs per call of fn() (the wrapper and the launch), enqueued
    while the device spins, so that no call waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(0.05 * cs.SM_HZ))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / reps
    torch.cuda.synchronize()
    return us


def turns(label, fns, match):
    """Events, device µs and host µs of each checkout's call, in
    ORDER."""
    rows = []
    for which in ORDER:
        ms = cs.timed(fns[which])
        us, n = dev_us(fns[which], match)
        host = host_us(fns[which])
        rows.append({"which": which, "event_us": ms * 1e3, "device_us": us,
                     "recorded": n, "host_us": host})
        print(f"turn {label:44s} {which:5s} events {ms * 1e3:9.3f} us  "
              f"device {'-' if us is None else f'{us:.3f}'} us ({n} "
              f"recorded)  host {host:.1f} us", flush=True)
    OUT["kernels"][label] = rows


def phases(label, kernel, table, fn, match):
    """This checkout's kernel, then each phase copy, device µs."""
    rows = {}
    fn()
    for tag, fe in [("full", (kernel._fn, kernel._err))] + list(table.items()):
        with swapped(kernel, fe):
            ms = cs.timed(fn)
            us, n = dev_us(fn, match)
        rows[tag] = {"event_us": ms * 1e3, "device_us": us, "recorded": n}
        print(f"phase {label:40s} {tag:40s} events {ms * 1e3:9.3f} us  "
              f"device {'-' if us is None else f'{us:.3f}'} us", flush=True)
    OUT["phases"][label] = rows


def md_turns(label, sys_, s, gen, other_cl):
    """Wall ms per step of MD_TIMED steps from the same state, and device
    busy per step of a profiled rebuild chunk, with each checkout's
    kernel 6 on the path; ORDER twice."""
    spec, build, energy = sys_["spec"], sys_["build"], sys_["energy"]
    own = potentials.cell_pair_energy_force
    rows = []
    for which in ORDER + ORDER:
        potentials.cell_pair_energy_force = (
            own if which == "this" else other_cl.cell_pair_energy_force)
        try:
            md.baoab_neighbor(build, energy, s.x, s.v, gen, dt=spec["dt"],
                              n_steps=2 * cs.MD_REBUILD,
                              rebuild_every=cs.MD_REBUILD, friction=1.0,
                              kT=1.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            md.baoab_neighbor(build, energy, s.x, s.v, gen, dt=spec["dt"],
                              n_steps=cs.MD_TIMED,
                              rebuild_every=cs.MD_REBUILD, friction=1.0,
                              kT=1.0)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / cs.MD_TIMED

            def chunk():
                nl = build(s.x)
                return md.baoab(lambda x: energy(nl, x), s.x, s.v, gen,
                                dt=spec["dt"], n_steps=cs.MD_REBUILD,
                                friction=1.0, kT=1.0, f0=s.force)[0]

            chunk()
            chunk_s, prof = cs.profiled(chunk)
        finally:
            potentials.cell_pair_energy_force = own
        busy, _ = cs.device_time(prof)
        k6, n6 = cs.launch_us(prof, "cell_lj_kernel")
        row = {"which": which, "wall_ms_per_step": wall_ms,
               "busy_ms_per_step": (None if busy is None
                                    else busy / 1e3 / cs.MD_REBUILD),
               "profiled_ms_per_step": 1e3 * chunk_s / cs.MD_REBUILD,
               "k6_us": k6, "k6_recorded": n6}
        rows.append(row)
        print(f"path md {label:10s} {which:5s} wall {wall_ms:.4f} ms/step; "
              f"device busy {row['busy_ms_per_step']} ms/step of "
              f"{row['profiled_ms_per_step']:.3f} profiled; kernel 6 {k6} us "
              f"({n6} of {cs.MD_REBUILD} recorded)", flush=True)
    OUT["paths"][f"md {label}"] = rows


def predict_turns(bm, dev, other_pa):
    """Backmapping ``predict`` at BM_SITES sites: wall ms per call over 10
    calls ending in a sync, and device busy of one profiled call, with
    each checkout's kernel 5; ORDER twice."""
    ref, coords, info, _ = cs.backmapping_frames(cs.BM_SITES, 22, dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    own = pa.pair_attention_cuda
    rows = []
    for which in ORDER + ORDER:
        pa.pair_attention_cuda = (own if which == "this"
                                  else other_pa.pair_attention_cuda)
        try:
            with torch.no_grad():
                bm.predict(ref, coords, info, gen)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    bm.predict(ref, coords, info, gen)
                torch.cuda.synchronize()
                ms = 1e2 * (time.perf_counter() - t0)
                wall, prof = cs.profiled(lambda: bm.predict(ref, coords,
                                                            info, gen))
        finally:
            pa.pair_attention_cuda = own
        busy, k5 = cs.device_time(prof, "pair_attention_kernel")
        row = {"which": which, "wall_ms_per_call": ms,
               "busy_ms": None if busy is None else busy / 1e3,
               "pair_attention_ms": None if k5 is None else k5 / 1e3,
               "profiled_ms": 1e3 * wall}
        rows.append(row)
        print(f"path predict {which:5s} wall {ms:.3f} ms/call; device busy "
              f"{row['busy_ms']} ms, kernel 5 {row['pair_attention_ms']} ms, "
              f"of {1e3 * wall:.3f} profiled", flush=True)
    OUT["paths"]["backmapping predict"] = rows


def attention_args(attn, c, v, m):
    (c_, *nodes, mf, weights), kw = attn.pair_args(c, v, m)
    return (c_, *nodes, mf, *weights), kw


def fresh_attention(gen, dev, N, H, B):
    attn = VectorAttention.create(gen, 20, 20, hidden_dim=H, device=dev)
    with torch.no_grad():
        for p in attn.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=gen, device=dev))
    c = 1.5 * torch.randn(B, N, 3, generator=gen, device=dev)
    v = torch.randn(B, N, 20, generator=gen, device=dev)
    m = (torch.rand(B, N, generator=gen, device=dev) > 0.3).float()
    return attn, c, v, m


def regime_sweep(gen, dev):
    """Kernel 5, both modes, both regimes forced, B = SWEEP_B, by
    events."""
    plan = pa.kernel_plan
    for H in SWEEP_H:
        for N in SWEEP_N:
            if all(plan(SWEEP_B, N, H, 20, regime=r)["refused"]
                   for r in ("rows", "grid")):
                continue
            base, c, v, m = fresh_attention(gen, dev, N, H, SWEEP_B)
            for reduce in (False, True):
                attn = VectorAttention(base.score_net, base.value_net,
                                       reduce)
                a, kw = attention_args(attn, c, v, m)
                want = pa.pair_attention_plain(*a, **kw)
                mode = "reduce" if reduce else "row"
                row = {}
                for regime in ("rows", "grid", "grid", "rows"):
                    forced = plan(SWEEP_B, N, H, 20, regime=regime)
                    if forced["regime"] != regime or forced["refused"]:
                        row.setdefault(regime, []).append(None)
                        continue
                    pa.kernel_plan = (lambda *x, r=regime:
                                      plan(*x, regime=r))
                    try:
                        got = pa.pair_attention_cuda(*a, **kw)
                        cs.compare(f"sweep {mode} N={N} H={H} {regime}",
                                   got, want, 1e-5, 1e-5)
                        us = 1e3 * cs.timed(lambda: pa.pair_attention_cuda(
                            *a, **kw))
                    finally:
                        pa.kernel_plan = plan
                    row.setdefault(regime, []).append(us)
                row["rule"] = plan(SWEEP_B, N, H, 20)["regime"]
                OUT["sweep"][f"{mode} N={N} H={H}"] = row
                print(f"sweep {mode:6s} N={N:2d} H={H:3d} B={SWEEP_B}  "
                      + "  ".join(f"{r} " + " ".join(
                          "-" if us is None else f"{us:9.3f}"
                          for us in row[r]) for r in ("rows", "grid"))
                      + f" us  rule: {row['rule']}", flush=True)


def proposal_cases(dev):
    """(label, args) of kernel 4 on the flagship: 10k and 50k chains,
    Philox and noise-input modes."""
    vae = flagship_experiment_config().build(dev)
    enc_w, dec_w, tables, base, spec = cs._proposal_args(vae)
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for n in cs.SIZES:
        x1 = torch.randn(n, spec.d_x, generator=gen, device=dev)
        seed = torch.tensor([11, -12], dtype=torch.int32, device=dev)
        noise = torch.randn(n, 2 + spec.d_x, generator=gen, device=dev)
        for mode, nz in (("philox", None), ("noise input", noise)):
            cases.append((f"vae_proposal {mode} N={n}",
                          (x1, seed, enc_w, dec_w, tables, base, spec, nz)))
    return vae, cases


RQS_SWEEP_T = (32, 64, 96, 128, 192, 256)


def rqs_sweep(label, x, params, range_min, inverse):
    """Kernel 1 on one broadcast row at each forced thread count, by
    events; the rule's own plan named."""
    plan = rqs.kernel_plan
    n, K = x.numel(), params[0].shape[-1]
    row = {"rule": plan(n, K, 1)}
    for T in RQS_SWEEP_T:
        rqs.kernel_plan = lambda *a, T=T: plan(*a, threads=T)
        try:
            us = 1e3 * cs.timed(lambda: rqs.rqs_cuda(x, *params, range_min,
                                                     inverse))
        finally:
            rqs.kernel_plan = plan
        row[f"T={T}"] = us
    OUT["sweep"][label] = row
    print(f"sweep {label}: " + "  ".join(
        f"{k} {v:.3f}" for k, v in row.items() if k != "rule")
        + f" us; rule {row['rule']}", flush=True)


def mc_kernels(vae, cases, dev, other_mf, other_rqs, tables):
    """Kernels 4 and 1 in turns (each checked against the plain version
    first, at chip_smoke.py's tolerances), their phase splits, kernel 1's
    plan sweep and the launch floor."""
    names = ("x2", "fwd", "rev", "z1", "z2")
    for label, args in cases:
        want = mf.vae_proposal_plain(*args)
        for which, mod in (("this", mf), ("other", other_mf)):
            got = mod.vae_proposal_cuda(*args)
            err = max(cs.compare(f"{label} {which} {nm}", g, w,
                                 1e-3 if nm in ("fwd", "rev") else 1e-4,
                                 1e-4, 1e-4)
                      for nm, g, w in zip(names, got, want))
            print(f"kernel 4 {label} {which}: err {err:.3e}", flush=True)
        x1, spec, splines = args[0], args[6], args[4]
        plan = mf.kernel_plan(x1.shape[0], spec.d_x, args[2][0].shape[1],
                              *splines[0].shape)
        turns(label, {"other": lambda: other_mf.vae_proposal_cuda(*args),
                      "this": lambda: mf.vae_proposal_cuda(*args)},
              "vae_proposal_kernel")
        OUT["kernels"][label].append({"plan": plan})
        print(f"plan {label}: {plan}", flush=True)
        if label == f"vae_proposal philox N={cs.SIZES[-1]}":
            phases(label, mf.KERNEL, tables["vae_proposal"],
                   lambda: mf.vae_proposal_cuda(*args),
                   "vae_proposal_kernel")

    splines, range_min = mf._extract_prior(vae.prior)[0]()
    K = splines[0].shape[-1]
    shared = tuple(t[0:1] for t in splines)
    gen = torch.Generator(device=dev).manual_seed(4)
    for n in cs.SIZES:
        x = torch.rand(n, 1, generator=gen, device=dev) * 14.0 - 7.0
        rows = [("broadcast", shared)]
        if n == cs.SIZES[-1]:
            rand = [torch.randn(n, 1, k, generator=gen, device=dev)
                    for k in (K, K, K - 1)]
            rows.append(("per-row", (
                cs._bin_positions(rand[0], -5.0, 5.0, K),
                cs._bin_positions(rand[1], -5.0, 5.0, K),
                cs._slopes(rand[2]))))
        for pname, params in rows:
            for inverse in (False, True):
                plain = (rqs.rqs_inverse_plain if inverse
                         else rqs.rqs_forward_plain)
                want = plain(x, *params, range_min)
                label = (f"rqs {'inverse' if inverse else 'forward'} "
                         f"{pname} N={n} K={K}")
                for which, mod in (("this", rqs), ("other", other_rqs)):
                    got = mod.rqs_cuda(x, *params, range_min, inverse)
                    err = max(cs.compare(f"{label} {which}", got[0], want[0],
                                         1e-5, 1e-5, 1e-4),
                              cs.compare(f"{label} {which} ldj", got[1],
                                         want[1], 1e-4, 0.0, 1e-4))
                    print(f"kernel 1 {label} {which}: err {err:.3e}",
                          flush=True)
                plan = rqs.kernel_plan(n, K, params[0].shape[0])
                turns(label, {
                    "other": lambda: other_rqs.rqs_cuda(x, *params,
                                                        range_min, inverse),
                    "this": lambda: rqs.rqs_cuda(x, *params, range_min,
                                                 inverse)}, "rqs_")
                OUT["kernels"][label].append({"plan": plan})
                print(f"plan {label}: {plan}", flush=True)
                if pname == "broadcast":
                    if not inverse:
                        phases(label, rqs.KERNEL, tables["rqs"],
                               lambda: rqs.rqs_cuda(x, *params, range_min,
                                                    inverse), "rqs_")
                    rqs_sweep(label, x, params, range_min, inverse)

    floor = []
    for _ in ORDER:
        ms = cs.timed(lambda: torch.cuda._sleep(0))
        total, _ = cs.device_us(lambda: torch.cuda._sleep(0), "")
        floor.append({"event_us": 1e3 * ms, "device_us": total})
        print(f"launch floor torch.cuda._sleep(0): events {1e3 * ms:.3f} us"
              f"  device {total} us", flush=True)
    OUT["kernels"]["launch floor"] = floor


class kernels_of:
    """Within the block, kernels 1 and 4 of ``which`` checkout run on the
    paths (the wrappers the dispatchers look up at call time)."""

    def __init__(self, which, other_mf, other_rqs):
        self.sub = ({} if which == "this" else
                    {(mf, "vae_proposal_cuda"): other_mf.vae_proposal_cuda,
                     (rqs, "rqs_cuda"): other_rqs.rqs_cuda})

    def __enter__(self):
        self.saved = {k: getattr(*k) for k in self.sub}
        for (mod, name), fn in self.sub.items():
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def mc_turns(vae, dev, other_mf, other_rqs):
    """The generic and fused MC steps at 50k chains: wall ms per step of
    TIMED_STEPS steps ending in a sync, device busy per step of
    MC_PROFILED profiled steps, each checkout's kernels on the path;
    ORDER twice."""
    n = cs.SIZES[-1]
    for path, step in (
            ("generic", make_mcmc_step(*vae_proposal_fns(vae),
                                       cs.log_target)),
            ("fused", make_fused_vae_step(vae, cs.log_target))):
        rows = []
        for which in ORDER + ORDER:
            gen = torch.Generator(device=dev).manual_seed(1)
            x0 = torch.randn(n, 2, generator=gen, device=dev)
            state = MCMCState.create(x0, cs.log_target(x0), torch.Generator(
                device=dev).manual_seed(2))
            with kernels_of(which, other_mf, other_rqs):
                state, _ = run_mcmc(step, state, cs.WARMUP_STEPS)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, _ = run_mcmc(step, state, cs.TIMED_STEPS)
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / cs.TIMED_STEPS
                window, prof = cs.profiled(lambda: run_mcmc(
                    step, state, cs.MC_PROFILED))
            busy, _ = cs.device_time(prof)
            row = {"which": which, "wall_ms_per_step": wall,
                   "busy_ms_per_step": (None if busy is None else
                                        busy / 1e3 / cs.MC_PROFILED),
                   "profiled_ms_per_step": 1e3 * window / cs.MC_PROFILED,
                   "acceptance": float(state.acceptance_rate)}
            rows.append(row)
            print(f"path mc {path:8s} {which:5s} wall {wall:.4f} ms/step; "
                  f"device busy {row['busy_ms_per_step']} ms/step of "
                  f"{row['profiled_ms_per_step']:.3f} profiled", flush=True)
        OUT["paths"][f"mc {path} N={n}"] = rows


def elbo_turns(dev, other_mf, other_rqs):
    """The flagship's ELBO train step at batch TRAIN_BATCH: wall ms per
    step over ELBO_EPOCHS epochs ending in a sync after a warm-up epoch,
    device busy per step of a profiled epoch, each checkout's kernel 1 on
    the path; ORDER twice."""
    vae = flagship_experiment_config().build(dev)
    data = cs.two_mode_data(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    adam = OptimizerConfig("adam", 1e-3).build()
    per_epoch = data.shape[0] // cs.TRAIN_BATCH

    def loss(m, b, g):
        return m.elbo_loss(b, g)

    def epochs(k):
        return fit(vae, loss, data, generator=gen, num_epochs=k,
                   batch_size=cs.TRAIN_BATCH, optimizer=adam)

    rows = []
    for which in ORDER + ORDER:
        with kernels_of(which, other_mf, other_rqs):
            epochs(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            epochs(ELBO_EPOCHS)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / (ELBO_EPOCHS
                                                       * per_epoch)
            window, prof = cs.profiled(lambda: epochs(1))
        busy, k1 = cs.device_time(prof, "rqs_")
        row = {"which": which, "wall_ms_per_step": wall,
               "busy_ms_per_step": (None if busy is None
                                    else busy / 1e3 / per_epoch),
               "rqs_us_per_step": None if k1 is None else k1 / per_epoch,
               "profiled_ms_per_step": 1e3 * window / per_epoch}
        rows.append(row)
        print(f"path elbo {which:5s} wall {wall:.4f} ms/step; device busy "
              f"{row['busy_ms_per_step']} ms/step (kernel 1 "
              f"{row['rqs_us_per_step']} us) of "
              f"{row['profiled_ms_per_step']:.3f} profiled", flush=True)
    OUT["paths"][f"elbo batch {cs.TRAIN_BATCH}"] = rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--targets", default=",".join(TARGETS),
                    help="comma-separated, of " + ", ".join(TARGETS))
    ap.add_argument("--out", type=Path,
                    default=HERE / "chiprun_out" / "chip_turns.json")
    opts = ap.parse_args()
    targets = opts.targets.split(",")
    if not set(targets) <= set(TARGETS):
        sys.exit(f"unknown target in {targets}; choose from {list(TARGETS)}")
    if not torch.cuda.is_available():
        sys.exit("chip_turns.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    OUT["card"] = card

    t0 = time.perf_counter()
    other = opts.other.resolve()
    other_src = other / "vaemolsim_tpu_torch" / "csrc"
    modules = {stem: mod for t in targets for stem, mod in TARGETS[t].items()}
    procs = {stem: nvcc(other_src / f"{stem}.cu",
                        BUILD / f"other_{stem}.so", other_src)
             for stem in modules}
    phase_procs = {stem: build_phases(stem) for stem in modules
                   if stem in PHASES}
    _build.build_all()
    for stem in modules:
        for line in _build.BUILD_LOGS.get(stem, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}", flush=True)
    others = {stem: load_other(other, mod, procs[stem],
                               BUILD / f"other_{stem}.so")
              for stem, mod in modules.items()}
    own = {"cell_lj": cell_lj.KERNEL, "pair_attention": pa.KERNEL,
           "vae_proposal": mf.KERNEL, "rqs": rqs.KERNEL}
    for stem in modules:
        own[stem]._bind()
    tables = {stem: {label: bind(proc, path, own[stem])
                     for label, (proc, path) in phase_procs[stem].items()}
              for stem in phase_procs}
    OUT["build_s"] = time.perf_counter() - t0
    print(f"built in {OUT['build_s']:.1f} s", flush=True)

    if "mc" in targets:
        other_mf, other_rqs = others["vae_proposal"], others["rqs"]
        with torch.no_grad():
            vae, cases = proposal_cases(dev)
            mc_kernels(vae, cases, dev, other_mf, other_rqs, tables)
            del cases
            mc_turns(vae, dev, other_mf, other_rqs)
        elbo_turns(dev, other_mf, other_rqs)
        torch.cuda.empty_cache()

    if "md" in targets:
        other_cl = others["cell_lj"]
        # Kernel 6 at the MD paths' final states, then the paths in turns.
        gen = torch.Generator(device=dev).manual_seed(5)
        for sys_fn, seed in ((cs.molecular_system, 31), (cs.lj_system, 41)):
            sys_ = sys_fn()
            row, s = cs.md_path(sys_, dev, seed)
            label = sys_["name"]
            OUT["paths"][f"md {label} chip_smoke row"] = row
            args, kw = sys_["cell_energy"].cell_pair_inputs(sys_["build"](s.x),
                                                            s.x)
            want = cell_lj.cell_pair_energy_force_plain(*args, **kw)
            for name, mod in (("this", cell_lj), ("other", other_cl)):
                got = mod.cell_pair_energy_force_cuda(*args, **kw)
                e_err = float((got[0] - want[0]).abs().max())
                g_err = float((got[1] - want[1]).abs().max())
                print(f"kernel 6 {label} {name}: e err {e_err:.3e}, grad "
                      f"err {g_err:.3e}", flush=True)
            turns(f"cell_lj {label}", {
                "other": lambda: other_cl.cell_pair_energy_force_cuda(
                    *args, **kw),
                "this": lambda: cell_lj.cell_pair_energy_force_cuda(
                    *args, **kw)}, "cell_lj_kernel")
            phases(f"cell_lj {label}", cell_lj.KERNEL, tables["cell_lj"],
                   lambda: cell_lj.cell_pair_energy_force_cuda(*args, **kw),
                   "cell_lj_kernel")
            md_turns(label, sys_, s, gen, other_cl)
            del sys_, s, args, want
            torch.cuda.empty_cache()

    if "backmapping" in targets:
        other_pa = others["pair_attention"]
        # Kernel 5 at the notebook's shapes, N = 50 and N = 37.
        bm = backmapping_experiment_config().build(dev)
        lpd = bm.mask_and_embed
        g2 = torch.Generator(device=dev).manual_seed(9)
        with torch.no_grad():
            cases = []
            for B in (cs.PA_FRAMES, cs.BM_SITES):
                ref, coords, info, _ = cs.backmapping_frames(B, 21, dev)
                sel, valid, sel_info = lpd.select(coords, ref,
                                                  particle_info=info)
                values = lpd.embed.info_net(sel_info)
                for reduce in (False, True):
                    base = (lpd.embed.final_attn if reduce
                            else lpd.embed.blocks[0].attn)
                    attn = VectorAttention(base.score_net, base.value_net,
                                           reduce)
                    cases.append((f"N=10 H=40 B={B}", reduce, attn, sel,
                                  values, valid.float()))
            for N, H, B in (cs.PA_DENSE, cs.PA_RAGGED):
                attn, c, v, m = fresh_attention(g2, dev, N, H, B)
                for reduce in (False, True):
                    cases.append((f"N={N} H={H} B={B}", reduce,
                                  VectorAttention(attn.score_net,
                                                  attn.value_net, reduce),
                                  c, v, m))
            for shape, reduce, attn, c, v, m in cases:
                a, kw = attention_args(attn, c, v, m)
                want = pa.pair_attention_plain(*a, **kw)
                label = (f"pair_attention {'reduce' if reduce else 'row'} "
                         f"{shape}")
                plan = pa.kernel_plan(m.shape[0], m.shape[1], a[1].shape[-1],
                                      20)
                for name, mod in (("this", pa), ("other", other_pa)):
                    err = cs.compare(f"{label} {name}",
                                     mod.pair_attention_cuda(*a, **kw), want,
                                     1e-5, 1e-5)
                    print(f"kernel 5 {label} {name}: err {err:.3e}"
                          + (f"  plan {plan}" if name == "this" else ""),
                          flush=True)
                turns(label, {
                    "other": lambda: other_pa.pair_attention_cuda(*a, **kw),
                    "this": lambda: pa.pair_attention_cuda(*a, **kw)},
                    "pair_attention_kernel")
                OUT["kernels"][label].append({"plan": plan})
                if not reduce and shape.startswith("N=10"):
                    phases(label, pa.KERNEL, tables["pair_attention"],
                           lambda: pa.pair_attention_cuda(*a, **kw),
                           "pair_attention_kernel")
            regime_sweep(g2, dev)
        predict_turns(bm, dev, other_pa)

    opts.out.parent.mkdir(parents=True, exist_ok=True)
    opts.out.write_text(json.dumps(OUT, indent=1, default=str))
    print(f"wrote {opts.out}", flush=True)


if __name__ == "__main__":
    main()

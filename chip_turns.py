"""Kernels 5 and 6 of this checkout against another checkout's, on one
H100, in turns: the other, this, this, the other (twice over for the
paths' wall times).

    python3 chip_turns.py OTHER_DIR [--out chiprun_out/chip_turns.json]

OTHER_DIR holds another commit's tree, for example the parent's,
unpacked by ``git archive <commit> | tar -x -C OTHER_DIR`` into a
directory that git ignores.  Its ``csrc/cell_lj.cu`` and
``csrc/pair_attention.cu`` and their wrappers ``ops/cell_lj.py`` and
``ops/attention.py`` are built and loaded beside this checkout's.  In
one process, it measures:

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
  each checkout's kernel swapped into the path.

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
from vaemolsim_tpu_torch.config import backmapping_experiment_config
from vaemolsim_tpu_torch.nn.attention import VectorAttention
from vaemolsim_tpu_torch.ops import attention as pa
from vaemolsim_tpu_torch.ops import cell_lj

HERE = Path(__file__).resolve().parent
BUILD = HERE / "vaemolsim_tpu_torch" / "_build_cache" / "turns"
ORDER = ("other", "this", "this", "other")
DEVICE, SWEEP_B = "cuda:0", 1000
SWEEP_H, SWEEP_N = (16, 40, 64, 100, 128, 200), (6, 10, 20, 37, 50, 64)
OUT: dict = {"kernels": {}, "sweep": {}, "phases": {}, "paths": {}}

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
    """The other checkout's wrapper module ``ops/<module>.py``, its
    kernel bound to the library that ``proc`` built from its source; the
    launch-count registry keeps this checkout's kernels."""
    saved = dict(_build.KERNELS)
    spec = importlib.util.spec_from_file_location(
        f"other_{module}", other / "vaemolsim_tpu_torch" / "ops"
        / f"{module}.py")
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path,
                    default=HERE / "chiprun_out" / "chip_turns.json")
    opts = ap.parse_args()
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
    procs = {stem: nvcc(other_src / f"{stem}.cu",
                        BUILD / f"other_{stem}.so", other_src)
             for stem in ("cell_lj", "pair_attention")}
    phase_procs = {stem: build_phases(stem) for stem in PHASES}
    _build.build_all()
    for stem in ("cell_lj", "pair_attention"):
        for line in _build.BUILD_LOGS.get(stem, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {stem}: {line.strip()}", flush=True)
    other_cl = load_other(other, "cell_lj", procs["cell_lj"],
                          BUILD / "other_cell_lj.so")
    other_pa = load_other(other, "attention", procs["pair_attention"],
                          BUILD / "other_pair_attention.so")
    cell_lj.KERNEL._bind()
    pa.KERNEL._bind()
    tables = {stem: {label: bind(proc, path, k)
                     for label, (proc, path) in phase_procs[stem].items()}
              for stem, k in (("cell_lj", cell_lj.KERNEL),
                              ("pair_attention", pa.KERNEL))}
    OUT["build_s"] = time.perf_counter() - t0
    print(f"built in {OUT['build_s']:.1f} s", flush=True)

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
            print(f"kernel 6 {label} {name}: e err "
                  f"{float((got[0] - want[0]).abs().max()):.3e}, grad err "
                  f"{float((got[1] - want[1]).abs().max()):.3e}", flush=True)
        turns(f"cell_lj {label}", {
            "other": lambda: other_cl.cell_pair_energy_force_cuda(*args,
                                                                  **kw),
            "this": lambda: cell_lj.cell_pair_energy_force_cuda(*args, **kw)},
            "cell_lj_kernel")
        phases(f"cell_lj {label}", cell_lj.KERNEL, tables["cell_lj"],
               lambda: cell_lj.cell_pair_energy_force_cuda(*args, **kw),
               "cell_lj_kernel")
        md_turns(label, sys_, s, gen, other_cl)
        del sys_, s, args, want
        torch.cuda.empty_cache()

    # Kernel 5 at the notebook's shapes, N = 50 and N = 37.
    bm = backmapping_experiment_config().build(dev)
    lpd = bm.mask_and_embed
    g2 = torch.Generator(device=dev).manual_seed(9)
    with torch.no_grad():
        cases = []
        for B in (cs.PA_FRAMES, cs.BM_SITES):
            ref, coords, info, _ = cs.backmapping_frames(B, 21, dev)
            sel, valid, sel_info = lpd.select(coords, ref, particle_info=info)
            values = lpd.embed.info_net(sel_info)
            for reduce in (False, True):
                base = (lpd.embed.final_attn if reduce
                        else lpd.embed.blocks[0].attn)
                attn = VectorAttention(base.score_net, base.value_net, reduce)
                cases.append((f"N=10 H=40 B={B}", reduce, attn, sel, values,
                              valid.float()))
        for N, H, B in (cs.PA_DENSE, cs.PA_RAGGED):
            attn, c, v, m = fresh_attention(g2, dev, N, H, B)
            for reduce in (False, True):
                cases.append((f"N={N} H={H} B={B}", reduce,
                              VectorAttention(attn.score_net, attn.value_net,
                                              reduce), c, v, m))
        for shape, reduce, attn, c, v, m in cases:
            a, kw = attention_args(attn, c, v, m)
            want = pa.pair_attention_plain(*a, **kw)
            label = f"pair_attention {'reduce' if reduce else 'row'} {shape}"
            plan = pa.kernel_plan(m.shape[0], m.shape[1], a[1].shape[-1], 20)
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

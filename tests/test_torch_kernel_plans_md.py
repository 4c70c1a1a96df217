"""The cell-pair kernel's schedule (``csrc/cell_lj.cu``), emulated in
plain PyTorch on the CPU, against the plain version and JAX.

The emulation follows the kernel step by step: each cell's occupied
neighbour slots compacted in slot order through per-chunk ballot counts
(chunks of 32) and an exclusive scan; its occupied centres listed the
same way and dealt to (block rank, warp) of a cluster of
``cluster_split`` blocks; per centre, the cheap pass (wrap, r^2, cutoff,
ids, exclusions) over the compacted neighbours, the passing ones queued
in order and evaluated ``lanes`` at a time, lane l taking queue
positions l, l + lanes, ...; lane sums reduced by the warp's butterfly,
warp energies summed in order, then the cluster's blocks in rank order.
Each chunk of 32 compacted slots has a bounding box, and a centre skips
a chunk whose box lies beyond the cutoff by the kernel's margin.  A
small ``lanes`` forces many flushes.  If the compaction, the pruning, the
queue or the split dropped, repeated or reordered a pair, the pair set
would differ from the plain version's mask, which it must equal bit for
bit.
Float32; the tolerances are the kernel's (per-cell energies 1e-5 of the
largest, the total 1e-5, gradients 1e-4 of the largest + 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.ops.cell_lj_pallas import \
    cell_pair_energy_force as jax_cell_pair
from vaemolsim_tpu_torch import potentials as tp
from vaemolsim_tpu_torch.ops import cell_lj

torch.set_num_threads(1)

F32 = np.float32


def _wrap(d, b):
    return d - float(b) * torch.round(d * (1.0 / float(b)))


def _butterfly(v):
    """The warp's xor-shuffle sum of per-lane float32 values."""
    v = np.asarray(v, F32).copy()
    o = len(v) // 2
    while o:
        v = (v + v[np.arange(len(v)) ^ o]).astype(F32)
        o //= 2
    return v[0]


def _pair_terms(r2, sg, ep, qq, slope, kw):
    """(u, w) of the pairs in a vector, as the plain version computes
    them."""
    sig2 = sg * sg
    r2s = r2.clamp_min(1e-12)
    rcore2 = 0.09 * sig2
    irr = 1.0 / torch.maximum(r2s, torch.as_tensor(rcore2))
    ir2 = sig2 * irr
    ir6 = ir2 * ir2 * ir2
    u = 4.0 * ep * (ir6 * ir6 - ir6)
    if kw["shift"]:
        s6 = sig2 * sig2 * sig2 / float(kw["cutoff"]) ** 6
        u = u - 4.0 * ep * (s6 * s6 - s6)
    w = 24.0 * ep * (ir6 - 2.0 * ir6 * ir6) * irr
    rs = torch.rsqrt(r2s)
    core = r2s < rcore2
    u = u + torch.where(core, slope * (r2s * rs - 0.3 * sg), 0.0)
    w = torch.where(core, slope * rs, w)
    if qq is not None:
        a = float(kw["coulomb_alpha"])
        ar = a * r2s * rs
        erfc_t = torch.special.erfc(ar)
        u = u + qq * erfc_t * rs
        w = w - qq * (erfc_t * rs + 2.0 / np.sqrt(np.pi) * a
                      * torch.exp(-ar * ar)) * rs * rs
    return u, w


def _chunk_boxes(pos):
    """(centres, half-extents), float32 (n_chunks, 3) each, of the
    bounding boxes of the compacted slots in chunks of 32."""
    nb = -(-pos.shape[1] // 32)
    if nb == 0:
        return np.zeros((0, 3), F32), np.zeros((0, 3), F32)
    lo = np.stack([pos[:, 32 * k:32 * k + 32].min(1) for k in range(nb)])
    hi = np.stack([pos[:, 32 * k:32 * k + 32].max(1) for k in range(nb)])
    return ((F32(0.5) * (lo + hi)).astype(F32),
            (F32(0.5) * (hi - lo)).astype(F32))


def _chunks_kept(x, boxes, box, rc2):
    """The kernel's chunk test: keep a chunk unless its box lies beyond
    the cutoff by the kernel's margin."""
    centre, half = boxes
    L = np.asarray(box, F32)
    d = (x[None, :].astype(F32) - centre).astype(F32)
    d = np.abs(d - L * np.rint(d * (F32(1) / L))).astype(F32)
    gap = np.maximum(d - half, F32(0))
    rcs = F32(np.sqrt(F32(rc2))) * F32(1.001) + F32(1e-4) * L.max()
    return (gap * gap).sum(1) <= rcs * rcs


def emulate(args, kw, lanes=32, warps=8, split=None):
    """(e, grad, pairs, centres seen) of the kernel's schedule."""
    cxt, nxt, cid, nid, species, charge, excl = args
    n, box = kw["n_atoms"], kw["box"]
    rc2 = float(kw["cutoff"]) ** 2
    nc, _, C = cxt.shape
    K = nxt.shape[-1]
    S = split or cell_lj.cluster_split(n, nc)
    e = torch.zeros(nc, 1, 1)
    grad = torch.zeros(nc, 3, C)
    pairs = torch.zeros(nc, C, K, dtype=torch.bool)
    seen = torch.zeros(nc, C, dtype=torch.int64)
    for c in range(nc):
        real = (nid[c, 0] < n).numpy()
        nch = -(-K // 32)
        counts = [int(real[32 * k:32 * k + 32].sum()) for k in range(nch)]
        offs = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(int)
        comp = np.empty(int(sum(counts)), np.int64)
        for k in range(nch):
            comp[offs[k]:offs[k] + counts[k]] = 32 * k + np.flatnonzero(
                real[32 * k:32 * k + 32])
        comp_t = torch.as_tensor(comp)
        boxes = _chunk_boxes(nxt[c][:, comp_t].numpy())
        cen = np.flatnonzero((cid[c, 0] < n).numpy())
        lane_e = np.zeros((S, warps, lanes), F32)
        for ci_pos, i in enumerate(cen):
            rank, warp = (ci_pos // warps) % S, ci_pos % warps
            d = [_wrap(cxt[c, a, i] - nxt[c, a, comp_t], box[a])
                 for a in range(3)]
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            nj = nid[c, 0, comp_t]
            keep = np.repeat(_chunks_kept(cxt[c, :, i].numpy(), boxes, box,
                                          rc2), 32)[:len(comp)]
            ok = (nj != cid[c, 0, i]) & (r2 < rc2) & torch.as_tensor(keep)
            if excl is not None:
                for k in range(excl.shape[1]):
                    ok = ok & (excl[c, k, i] != nj)
            take = torch.nonzero(ok)[:, 0]      # queue order
            j = comp_t[take]
            pairs[c, i, j] = True
            seen[c, i] += 1
            if species is not None:
                csig, nsig, cse, nse = species
                sg = 0.5 * (csig[c, 0, i] + nsig[c, 0, j])
                ep = cse[c, 0, i] * nse[c, 0, j]
                slope = cell_lj.SLOPE_F * ep * torch.rsqrt(sg * sg)
            else:
                sg = torch.full(j.shape, float(kw["sigma"]))
                ep = torch.full(j.shape, float(kw["epsilon"]))
                slope = cell_lj.SLOPE_F * float(kw["epsilon"]) / float(
                    kw["sigma"])
            qq = None if charge is None else charge[0][c, 0, i] * \
                charge[1][c, 0, j]
            u, w = _pair_terms(r2[take], sg, ep, qq, slope, kw)
            u, w = u.numpy(), w.numpy()
            dd = [da[take].numpy() for da in d]
            g = np.zeros((3, lanes), F32)
            for q, (uq, wq) in enumerate(zip(u, w)):
                lane = q % lanes
                lane_e[rank, warp, lane] = F32(lane_e[rank, warp, lane] + uq)
                for a in range(3):
                    g[a, lane] = F32(g[a, lane] + F32(wq * dd[a][q]))
            for a in range(3):
                grad[c, a, i] = float(_butterfly(g[a]))
        blocks = []
        for r in range(S):
            s = F32(0)
            for wp in range(warps):
                s = F32(s + _butterfly(lane_e[r, wp]))
            blocks.append(s)
        tot = F32(0)
        for s in blocks:
            tot = F32(tot + s)
        e[c, 0, 0] = float(F32(0.5) * tot)
    return e, grad, pairs, seen


def plain_pairs(args, kw):
    """The plain version's pair mask, recomputed."""
    cxt, nxt, cid, nid, _, _, excl = args
    r2 = 0.0
    for a, b in enumerate(kw["box"]):
        d = _wrap(cxt[:, a, :, None] - nxt[:, a, None, :], b)
        r2 = r2 + d * d
    ci = cid.transpose(1, 2)
    n = kw["n_atoms"]
    mask = (ci < n) & (nid < n) & (ci != nid) & (r2 < kw["cutoff"] ** 2)
    if excl is not None:
        for k in range(excl.shape[1]):
            mask = mask & (excl[:, k, :, None] != nid)
    return mask


def assert_cell_close(got, want):
    (e, g), (ew, gw) = got, want
    assert bool(torch.isfinite(e).all() and torch.isfinite(g).all())
    torch.testing.assert_close(e, ew, rtol=1e-5,
                               atol=1e-5 * float(ew.abs().max()) + 1e-30)
    torch.testing.assert_close(e.sum(), ew.sum(), rtol=1e-5, atol=1e-30)
    torch.testing.assert_close(g, gw, rtol=0,
                               atol=1e-4 * float(gw.abs().max()) + 1e-5)


def lattice_system(branch, n=120, box=9.0, capacity=24, seed=0):
    """A jittered lattice in a box of 9 (27 cells of edge 3), cutoff 2.5,
    skin 0.5, in one branch of the kernel; the kernel's gathered inputs
    at displaced coordinates."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)[:n]
    x = ((g + 0.5) * box / 5 + 0.2 * rng.normal(size=(n, 3))).astype(F32)
    kw = {}
    if branch in ("species", "all"):
        sig = np.where(np.arange(n) % 3 == 0, 0.88, 1.0)
        kw.update(sigma=sig, epsilon=np.where(sig == 1.0, 1.0, 0.5))
    if branch in ("coulomb", "all"):
        kw.update(charges=np.tile([0.5, -0.5], n // 2), coulomb_alpha=0.9)
    if branch in ("exclusion", "all"):
        kw["exclude"] = np.array(
            [[3 * k, 3 * k + 1] for k in range(n // 3)]
            + [[3 * k + 1, 3 * k + 2] for k in range(n // 3)])
    build, energy = tp.lennard_jones_cell_neighbor(
        box=[box] * 3, cutoff=2.5, skin=0.5, capacity=capacity,
        device="cpu", **kw)
    xt = torch.tensor(x)
    x1 = xt + torch.tensor(0.05 * rng.normal(size=x.shape),
                           dtype=torch.float32)
    return energy.cell_pair_inputs(build(xt), x1)


def hand_blocks(n_cells, C, K, n, *, seed, spread, real, D=0):
    """Hand-made blocks (numpy-seeded), padding id n anywhere in a block,
    species and charges on, D exclusion ids per centre (-1 padding)."""
    rng = np.random.default_rng(seed)

    def ids(w):
        i = rng.integers(0, n, size=(n_cells, 1, w))
        return torch.tensor(np.where(rng.random((n_cells, 1, w)) < real, i,
                                     n).astype(np.int32))

    def f32(a):
        return torch.tensor(np.asarray(a, F32))

    args = [f32(rng.random((n_cells, 3, C)) * spread),
            f32(rng.random((n_cells, 3, K)) * spread), ids(C), ids(K),
            tuple(f32(rng.uniform(lo, 1.0, (n_cells, 1, w)))
                  for lo, w in ((0.85, C), (0.85, K), (0.7, C), (0.7, K))),
            (f32(rng.choice([-0.5, 0.5], (n_cells, 1, C))),
             f32(rng.choice([-0.5, 0.5], (n_cells, 1, K)))), None]
    if D:
        ex = rng.integers(0, n, size=(n_cells, D, C))
        args[6] = torch.tensor(np.where(rng.random(ex.shape) < 0.7, ex,
                                        -1).astype(np.int32))
    kw = dict(n_atoms=n, sigma=1.0, epsilon=1.0, cutoff=2.5,
              box=(12.0, 12.0, 12.0), shift=True, coulomb_alpha=1.2)
    return args, kw


def check(args, kw, **how):
    e, g, pairs, seen = emulate(args, kw, **how)
    torch.testing.assert_close(pairs, plain_pairs(args, kw), rtol=0, atol=0)
    real = (args[2][:, 0] < kw["n_atoms"]).long()
    assert torch.equal(seen, real), "a centre was skipped or repeated"
    assert_cell_close((e, g), cell_lj.cell_pair_energy_force_plain(*args,
                                                                   **kw))
    return e, g


@pytest.mark.parametrize("lanes", [32, 4])
@pytest.mark.parametrize("branch", ["scalar", "species", "coulomb",
                                    "exclusion", "all"])
def test_schedule_takes_the_plain_pairs_on_a_build(branch, lanes):
    """A port build's gathered inputs (capacity 24, padding at the end
    of each cell), with the kernel's 32 lanes and with 4 (a flush every
    4 queued pairs)."""
    args, kw = lattice_system(branch)
    check(args, kw, lanes=lanes)


@pytest.mark.parametrize("case", ["dense cluster", "interleaved padding",
                                  "ragged C and K", "empty cells"])
def test_schedule_on_hand_made_blocks(case):
    """Every slot of a cluster inside the cutoff (all 27 C slots real:
    the queue fills 32 at a time), padding scattered through the blocks,
    C = 13 and K = 351 (not multiples of 32 or of 8 warps), and cells with
    no real slot (zero energy and gradient)."""
    shape = dict(n_cells=3, C=8, K=27 * 8, n=200)
    how = dict(seed=sum(map(ord, case)), spread=6.0, real=0.6, D=2)
    if case == "dense cluster":
        how.update(spread=1.2, real=1.0, D=1)
    elif case == "ragged C and K":
        shape.update(C=13, K=351)
    elif case == "empty cells":
        how.update(real=0.0)
    args, kw = hand_blocks(**shape, **how)
    e, g = check(args, kw, lanes=8)
    if case == "dense cluster":
        assert int(plain_pairs(args, kw).sum()) > 0.9 * 3 * 8 * 27 * 8
    if case == "empty cells":
        assert float(e.abs().max()) == 0.0 and float(g.abs().max()) == 0.0


@pytest.mark.parametrize("split", [1, 3, 8])
def test_block_split_covers_each_centre_once(split):
    """The centres dealt over 1, 3 and 8 blocks of 8 warps (more warps
    than centres at 8): each centre once, the same pairs, the energy
    summed per block and then in rank order within the tolerances."""
    args, kw = lattice_system("all", capacity=24)
    check(args, kw, split=split, lanes=32)
    assert cell_lj.cluster_split(kw["n_atoms"], args[0].shape[0]) == 1
    assert cell_lj.cluster_split(8192, 216) == 3
    assert cell_lj.cluster_split(8192, 343) == 2
    assert cell_lj.cluster_split(10 ** 6, 8) == 8


def test_schedule_matches_pallas_interpret():
    """The emulation against the JAX package's Pallas kernel in interpret
    mode on the same gathered inputs, every branch on: per-cell energies
    to 1e-5 of the largest, gradients to 1e-5 of the largest."""
    args, kw = lattice_system("all")
    e, g, _, _ = emulate(args, kw, lanes=8)

    def jx(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(jnp.asarray(v.numpy()) for v in a)
        return jnp.asarray(a.numpy())

    ja = [jx(a) for a in args]
    je, jg = jax_cell_pair(*ja[:4], species=ja[4], charge=ja[5],
                           exclusion=ja[6], interpret=True, **kw)
    je, jg = np.asarray(je), np.asarray(jg)
    np.testing.assert_allclose(e.numpy(), je, rtol=1e-5,
                               atol=1e-5 * np.abs(je).max())
    np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                               atol=1e-5 * np.abs(jg).max())


def test_chunk_pruning_keeps_every_pair_at_the_cutoff():
    """One centre against three chunks of 32: a tight cluster just inside
    the cutoff (r = rc (1 - 1e-6)), one just outside (rc (1 + 1e-6)) and
    one far away.  The first two chunks are tested, the far one is
    skipped, and the pairs taken are the plain version's, the ones just
    inside and none just outside."""
    rng = np.random.default_rng(3)
    rc = 2.5
    centre = np.array([6.0, 6.0, 6.0])
    dirs = rng.normal(size=(3, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    jitter = [1e-7, 1e-7, 0.1]
    pts = [centre + r * d + s * rng.normal(size=(32, 3)) for r, d, s in
           zip((rc * (1 - 1e-6), rc * (1 + 1e-6), 2.2 * rc), dirs, jitter)]
    nxt = np.concatenate(pts).T[None].astype(F32)           # (1, 3, 96)
    cxt = centre[None, :, None].astype(F32)
    args = [torch.tensor(cxt), torch.tensor(nxt),
            torch.zeros(1, 1, 1, dtype=torch.int32),
            torch.arange(1, 97, dtype=torch.int32)[None, None], None, None,
            None]
    kw = dict(n_atoms=200, sigma=1.0, epsilon=1.0, cutoff=rc,
              box=(12.0, 12.0, 12.0), shift=True, coulomb_alpha=0.0)
    kept = _chunks_kept(cxt[0, :, 0], _chunk_boxes(nxt[0]), kw["box"],
                        rc * rc)
    assert kept.tolist() == [True, True, False]
    e, g = check(args, kw)
    taken = plain_pairs(args, kw)[0, 0]
    d = np.linalg.norm(nxt[0].T.astype(np.float64) - centre, axis=1)
    assert bool(taken[:32].all()) and not bool(taken[32:].any())
    assert (d[:32] < rc).all() and (d[32:64] > rc).all()

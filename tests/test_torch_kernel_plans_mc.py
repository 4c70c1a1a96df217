"""What the RQS kernel (``csrc/rqs.cu``) and the whole-proposal kernel
(``csrc/vae_proposal.cu``) take from Python, and emulations of what they
compute, on the CPU.

Kernel 1 on one broadcast row, and kernel 4 for the prior's blocks,
build a knot table once (``rqs.cuh`` ``rqs_table_knot``) and find each
input's bin by binary search (``rqs_bin``) instead of walking the bins
(``rqs_eval``).  A float32 transcription of both is held here bin for
bin: random rows, inputs on every knot, runs of equal knots, NaN, +-inf,
both tails, both directions.  The table's values then go through the
unchanged rational-quadratic map against the plain version and JAX's
Pallas kernel in interpret mode.

Kernel 4 runs chain i on thread i; a group of R neighbouring lanes
shares R chains and splits the hidden units (lane g takes g, g + R, ...,
units padded with zero records to a multiple of 2R), and a shuffle
butterfly adds the R partial sums.  The plan (``mcmc/fused.py``
``kernel_plan``) is checked for coverage, and a float32 emulation of
that order of sums is held against the plain version and JAX's Pallas
proposal in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaemolsim_tpu.flows.spline_flows import _bin_positions, _slopes
from vaemolsim_tpu.mcmc import fused as jmf
from vaemolsim_tpu.ops.rqs_pallas import (rqs_forward_pallas,
                                          rqs_inverse_pallas)
from vaemolsim_tpu_torch.mcmc import fused as tmf
from vaemolsim_tpu_torch.ops import rqs as trqs

torch.set_num_threads(1)
f32, f64 = np.float32, np.float64
RANGE_MIN = -5.0


def t(a):
    return torch.tensor(np.asarray(a, f32))


def spline_rows(rng, rows, K, spread=1.0):
    """Activated spline parameters (numpy) through the JAX activations."""
    def raw(k):
        return jnp.asarray(spread * rng.normal(size=(rows, k)), jnp.float32)

    return (np.asarray(_bin_positions(raw(K), RANGE_MIN, -RANGE_MIN, K)),
            np.asarray(_bin_positions(raw(K), RANGE_MIN, -RANGE_MIN, K)),
            np.asarray(_slopes(raw(K - 1))))


# ---------------------------------------------------------------------------
# Kernel 1: the knot table and its search against the walk
# ---------------------------------------------------------------------------


def walk(v, w, h, s, K, range_min, inverse):
    """rqs.cuh ``rqs_eval``'s bin walk, transcribed: (bin, xk, yk, wk,
    hk, dk, dk1, total) for one float32 v."""
    rm = f32(range_min)
    cw = ch = f32(0.0)
    xk = yk = rm
    k_at, wk, hk = 0, w[0], h[0]
    dk, dk1 = f32(1.0), (s[0] if K > 1 else f32(1.0))
    for k in range(1, K):
        cw = f32(cw + w[k - 1])
        ch = f32(ch + h[k - 1])
        kx, ky = f32(rm + cw), f32(rm + ch)
        if v >= (ky if inverse else kx):
            xk, yk, k_at, wk, hk = kx, ky, k, w[k], h[k]
            dk = s[k - 1]
            dk1 = s[k] if k < K - 1 else f32(1.0)
    total = (f32(rm + f32(ch + h[K - 1])) if inverse
             else f32(rm + f32(cw + w[K - 1])))
    return k_at, xk, yk, wk, hk, dk, dk1, total


def build_table(w, h, s, K, range_min):
    """rqs.cuh ``rqs_table_knot`` for k = 0..K, transcribed (each knot
    its own left-to-right sum): (kx, ky, bins), bins a (K, 6) array of
    (xk, yk, wk, hk, dk, dk1)."""
    rm = f32(range_min)
    kx, ky = np.zeros(K + 1, f32), np.zeros(K + 1, f32)
    bins = np.zeros((K, 6), f32)
    for k in range(K + 1):
        cw = ch = f32(0.0)
        for j in range(k):
            cw = f32(cw + w[j])
            ch = f32(ch + h[j])
        kx[k] = rm if k == 0 else f32(rm + cw)
        ky[k] = rm if k == 0 else f32(rm + ch)
        if k < K:
            bins[k] = (kx[k], ky[k], w[k], h[k], s[k - 1] if k > 0 else 1.0,
                       s[k] if k < K - 1 else 1.0)
    return kx, ky, bins


def search(knots, K, v):
    """rqs.cuh ``rqs_bin``, transcribed."""
    k = 0
    step = 1 << (K - 1).bit_length() - 1 if K > 1 else 0
    while step > 0:
        if k + step < K and knots[k + step] <= v:
            k += step
        step >>= 1
    return k


def probe_inputs(rng, kx, ky):
    """Uniform inputs over the range and both tails, every knot of both
    axes exactly, the float32 neighbours of each knot, NaN and +-inf."""
    knots = np.concatenate([kx, ky])
    near = np.concatenate([np.nextafter(knots, f32(-np.inf)),
                           np.nextafter(knots, f32(np.inf))])
    return np.concatenate([
        rng.uniform(-7.0, 7.0, 200).astype(f32), knots, near,
        np.array([np.nan, np.inf, -np.inf, -7.0, 7.0, -5.0], f32)])


def assert_same_bins(w, h, s, K, inputs):
    kx, ky, bins = build_table(w, h, s, K, RANGE_MIN)
    for inverse in (False, True):
        knots = ky if inverse else kx
        for v in inputs:
            k, xk, yk, wk, hk, dk, dk1, total = walk(v, w, h, s, K,
                                                     RANGE_MIN, inverse)
            got = search(knots, K, v)
            assert got == k, (inverse, v, got, k)
            np.testing.assert_array_equal(bins[got],
                                          [xk, yk, wk, hk, dk, dk1])
            assert knots[K] == total


@pytest.mark.parametrize("K", [2, 8, 32, 128])
def test_table_search_takes_the_walks_bin(K):
    """Random rows: the search's bin, the table's bin record and the
    table's upper edge equal the walk's, bit for bit, in both
    directions, for inputs on and beside every knot, NaN and +-inf."""
    rng = np.random.default_rng(K)
    w, h, s = spline_rows(rng, 3, K)
    for r in range(3):
        kx, ky, _ = build_table(w[r], h[r], s[r], K, RANGE_MIN)
        assert_same_bins(w[r], h[r], s[r], K, probe_inputs(rng, kx, ky))


@pytest.mark.parametrize("K", [8, 32, 128])
def test_equal_knots_take_the_last_bin(K):
    """Widths lost to rounding against the running sum (1e-9 after a
    width of 5) make runs of equal knots; both the walk and the search
    take the last knot of a run."""
    rng = np.random.default_rng(100 + K)
    w, h, s = (a[0] for a in spline_rows(rng, 1, K))
    w, h = w.copy(), h.copy()
    w[K // 4:K // 2] = 1e-9
    h[K // 2:3 * K // 4] = 1e-9
    h[1] = 1e-9
    kx, ky, _ = build_table(w, h, s, K, RANGE_MIN)
    assert len(np.unique(kx)) < len(kx) and len(np.unique(ky)) < len(ky)
    assert_same_bins(w, h, s, K, probe_inputs(rng, kx, ky))


def apply_rqs(v, xk, yk, wk, hk, dk, dk1, total, inverse):
    """rqs.cuh ``rqs_apply`` in float32 torch ops, elementwise."""
    inside = (v >= RANGE_MIN) & (v <= total)
    sl = hk / wk
    if not inverse:
        xi = (v - xk) / wk
        xi1m = 1.0 - xi
        num = hk * (sl * xi * xi + dk * xi * xi1m)
        den = sl + (dk1 + dk - 2.0 * sl) * xi * xi1m
        res = yk + num / den
        deriv = (sl * sl) * (dk1 * xi * xi + 2.0 * sl * xi * xi1m
                             + dk * xi1m * xi1m) / (den * den)
        lg = torch.log(deriv)
    else:
        tt = v - yk
        dsum = dk1 + dk - 2.0 * sl
        a = hk * (sl - dk) + tt * dsum
        b = hk * dk - tt * dsum
        c = -sl * tt
        disc = torch.clamp_min(b * b - 4.0 * a * c, 0.0)
        xi = torch.clamp((2.0 * c) / (-b - torch.sqrt(disc)), 0.0, 1.0)
        res = xk + xi * wk
        xi1m = 1.0 - xi
        den = sl + dsum * xi * xi1m
        deriv = (sl * sl) * (dk1 * xi * xi + 2.0 * sl * xi * xi1m
                             + dk * xi1m * xi1m) / (den * den)
        lg = -torch.log(deriv)
    return (torch.where(inside, res, v),
            torch.where(inside, lg, torch.zeros_like(lg)))


def table_eval(v, w, h, s, K, inverse):
    """rqs.cuh ``rqs_eval_table``: search, bin record, rqs_apply."""
    kx, ky, bins = build_table(w, h, s, K, RANGE_MIN)
    knots = ky if inverse else kx
    idx = np.array([search(knots, K, x) for x in v])
    cols = [t(bins[idx, c]) for c in range(6)]
    return apply_rqs(t(v), *cols, t(knots[K]), inverse)


@pytest.mark.parametrize("K", [2, 8, 32])
@pytest.mark.parametrize("inverse", [False, True])
def test_table_eval_matches_plain_and_pallas(K, inverse):
    """One broadcast row, x over [-7, 7] and on every knot: the
    emulation against the plain version (same bins, same knots, the same
    float32 formula: 2e-6 on values and log-dets, roundoff of a division
    and a log); the x over [-7, 7] against the Pallas kernel in interpret
    mode (knots as offsets from range_min, a different rounding that a
    steep bin magnifies: 5e-5 and 1e-4, as tests/test_torch_ops.py holds
    the plain version to it at K = 8; 2e-4 on log-dets at K = 32, whose
    bins are 4x narrower: the plain version itself is 1.05e-4 from
    Pallas on these rows; on a knot itself that rounding may pick the
    neighbouring bin)."""
    rng = np.random.default_rng(7 + K)
    w, h, s = spline_rows(rng, 1, K)
    kx, ky, _ = build_table(w[0], h[0], s[0], K, RANGE_MIN)
    x = np.concatenate([rng.uniform(-7.0, 7.0, 301).astype(f32),
                        ky if inverse else kx])
    got_y, got_l = table_eval(x, w[0], h[0], s[0], K, inverse)
    plain = trqs.rqs_inverse_plain if inverse else trqs.rqs_forward_plain
    want_y, want_l = plain(t(x), t(w), t(h), t(s), RANGE_MIN)
    np.testing.assert_allclose(got_y.numpy(), want_y.numpy(), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(got_l.numpy(), want_l.numpy(), atol=2e-6,
                               rtol=0)
    pallas = rqs_inverse_pallas if inverse else rqs_forward_pallas
    ref_y, ref_l = pallas(jnp.asarray(x[:301]), w, h, s, RANGE_MIN, True)
    np.testing.assert_allclose(got_y.numpy()[:301], np.asarray(ref_y),
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(got_l.numpy()[:301], np.asarray(ref_l),
                               atol=1e-4 if K <= 8 else 2e-4, rtol=0)


def test_table_eval_special_values():
    """NaN stays NaN with log-det 0; +-inf and both tails are the
    identity with log-det 0, as the walk gives them."""
    rng = np.random.default_rng(3)
    w, h, s = (a[0] for a in spline_rows(rng, 1, 16))
    x = np.array([np.nan, np.inf, -np.inf, -5.5, 5.5, -1e30, 1e30], f32)
    for inverse in (False, True):
        y, l = (a.numpy() for a in table_eval(x, w, h, s, 16, inverse))
        assert np.isnan(y[0]) and l[0] == 0.0
        np.testing.assert_array_equal(y[1:], x[1:])
        np.testing.assert_array_equal(l, 0.0)


@pytest.mark.parametrize("K", [2, 8, 32, 128])
def test_rqs_plan_covers_every_element_once(K):
    """The broadcast plan: a thread an element, threads a multiple of 32
    in [128, 256] and at least K + 1 up to 256, blocks covering n exactly
    (no block without elements); shared bytes of the knot table and the
    row.  A forced thread count is kept.  Per-element rows, and a
    broadcast row of more bins than a table in shared memory holds (4469):
    the walk, 256 threads a block, no shared memory."""
    table = 2 * (4 * ((K + 1 + 3) // 4)) + 8 * K
    for n in (1, 3, 4, 5, 4097, 10_000, 50_000, 50_003, 1_000_003):
        plan = trqs.kernel_plan(n, K, 1)
        T, nb = plan["threads"], plan["blocks"]
        assert T % 32 == 0 and max(128, min(K + 1, 256)) <= T <= 256
        assert (nb - 1) * T < n <= nb * T
        assert plan["smem"] == 4 * (table + 3 * K)
        assert plan["regime"] == "table"
        forced = trqs.kernel_plan(n, K, 1, threads=64)
        assert forced["threads"] == 64 and forced["blocks"] == -(-n // 64)
        row = trqs.kernel_plan(n, K, max(n, 2))
        assert row["threads"] == 256 and row["smem"] == 0
        assert row["regime"] == "walk"
        assert (row["blocks"] - 1) * 256 < n <= row["blocks"] * 256
    wide = trqs.kernel_plan(10, 4470, 1)
    assert wide["regime"] == "walk" and wide["smem"] == 0
    assert wide["threads"] == 256 and wide["blocks"] == 1
    assert trqs.kernel_plan(10, 4469, 1)["regime"] == "table"


# ---------------------------------------------------------------------------
# Kernel 4: the plan and the order of sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_x", range(1, 9))
def test_proposal_plan_covers_every_chain_once(d_x):
    """For H = 1..300 and N = 1..50k: every chain on exactly one thread
    (chain = block * threads + thread), lane groups of R neighbouring
    lanes inside one warp, each group's lanes splitting the padded units
    so that every unit is taken once, padding below one step (2R units),
    a block per SM where the chains allow it and no empty block, and the
    shared bytes of the records, tables, raw rows and biases."""
    table = 2 * (4 * ((32 + 1 + 3) // 4)) + 8 * 32
    for H in (1, 2, 3, 7, 8, 64, 199, 200, 255, 256, 300):
        for n in (1, 2, 31, 32, 33, 2001, 10_000, 50_000, 50_003):
            plan = tmf.kernel_plan(n, d_x, H, 2, 32)
            R, T, nb = plan["R"], plan["threads"], plan["blocks"]
            assert 32 % R == 0 and R == (4 if d_x <= 4 else 2)
            assert T in (32, 64, 128) and (nb - 1) * T < n <= nb * T
            if n >= 132 * 32:
                assert nb >= 132
            chains = (np.arange(nb)[:, None] * T + np.arange(T)).ravel()
            np.testing.assert_array_equal(np.sort(chains[chains < n]),
                                          np.arange(n))
            first = np.arange(T) - np.arange(T) % R
            assert (first // 32 == (first + R - 1) // 32).all()
            units = plan["units"]
            assert units % (2 * R) == 0 and H <= units < H + 2 * R
            taken = np.sort(np.concatenate([np.arange(g, units, R)
                                            for g in range(R)]))
            np.testing.assert_array_equal(taken, np.arange(units))
            enc, dec = plan["enc"], plan["dec"]
            assert enc % 4 == 0 and 3 + d_x <= enc < 3 + d_x + 4
            assert dec % 4 == 0 and 2 + 2 * d_x <= dec < 2 + 2 * d_x + 4
            assert plan["smem"] == 4 * (units * (enc + dec)
                                        + 2 * (table + 3 * 32 - 1)
                                        + 2 + 2 * d_x)
            assert not plan["refused"]
    assert tmf.kernel_plan(10, d_x, 20_000, 2, 32)["refused"]


def fma(a, b, c):
    """float32 fused multiply-add: the exact product and sum in float64,
    rounded once more to float32."""
    return (np.asarray(a, f64) * np.asarray(b, f64)
            + np.asarray(c, f64)).astype(f32)


def mlp_emulated(inp, w1, b1, w2, b2, act, R):
    """One pass of the kernel's ``mlp_pass`` over all chains: lane g of a
    group of R sums units g, g + R, ... < padded units in order (records
    of zeros past H), then the butterfly (offsets R/2, ..., 1) adds the
    lanes' sums; every lane must hold the same bits."""
    n, H = inp.shape[0], w1.shape[1]
    units = -(-H // (2 * R)) * 2 * R
    pad = units - H
    w1 = np.pad(w1, ((0, 0), (0, pad)))
    b1 = np.pad(b1, (0, pad))
    w2 = np.pad(w2, ((0, pad), (0, 0)))
    part = []
    for g in range(R):
        acc = np.zeros((n, w2.shape[1]), f32)
        for u in range(g, units, R):
            a = np.full(n, b1[u], f32)
            for i in range(inp.shape[1]):
                a = fma(inp[:, i], w1[i, u], a)
            a = np.maximum(a, f32(0)) if act == "relu" else np.tanh(a)
            acc = fma(a[:, None], w2[u], acc)
        part.append(acc)
    off = R // 2
    while off >= 1:
        part = [part[g] + part[g ^ off] for g in range(R)]
        off //= 2
    for g in range(1, R):
        np.testing.assert_array_equal(part[g], part[0])
    return part[0] + b2


def _softplus(v):
    return np.maximum(v, f32(0)) + np.log1p(np.exp(-np.abs(v)))


def _normal_lp(v, loc, scale):
    z = (v - loc) / scale
    return f32(-0.5) * z * z - np.log(scale) - f32(0.9189385332046727)


def proposal_emulated(x1, noise, enc_w, dec_w, tables, base, act, R):
    """The kernel's proposal in noise-input mode, float32: the passes by
    ``mlp_emulated``, the prior's blocks by knot-table search."""
    sw, sh, ss = tables
    B, K = sw.shape
    eps32 = f32(1.1920928955078125e-07)
    enc_act, dec_act = act

    def flow(v, inverse):
        ldj = np.zeros_like(v)
        for b in (reversed(range(B)) if inverse else range(B)):
            y, l = table_eval(v, sw[b], sh[b], ss[b], K, inverse)
            v = y.numpy()
            ldj = ldj + l.numpy()
        return v, ldj

    e = mlp_emulated(x1, *enc_w, enc_act, R)
    mu, sig = e[:, 0], _softplus(e[:, 1]) + eps32
    z1 = mu + sig * noise[:, 0]
    u = base[0] + base[1] * noise[:, 1]
    z2, fldj = flow(u, False)
    d = mlp_emulated(z2[:, None], *dec_w, dec_act, R)
    m, s = d[:, 0::2], _softplus(d[:, 1::2]) + eps32
    x2 = m + s * noise[:, 2:]
    fwd = (_normal_lp(z1, mu, sig) + (_normal_lp(u, base[0], base[1]) - fldj)
           + _normal_lp(x2, m, s).sum(-1))
    e2 = mlp_emulated(x2, *enc_w, enc_act, R)
    u1, ildj = flow(z1, True)
    d1 = mlp_emulated(z1[:, None], *dec_w, dec_act, R)
    rev = (_normal_lp(z2, e2[:, 0], _softplus(e2[:, 1]) + eps32)
           + (_normal_lp(u1, base[0], base[1]) + ildj)
           + _normal_lp(x1, d1[:, 0::2], _softplus(d1[:, 1::2])
                        + eps32).sum(-1))
    return x2, fwd, rev, z1[:, None], z2[:, None]


def proposal_weights(rng, d_x, H, B, K):
    """Glorot-scaled weights with non-zero biases (as the model's init
    gives them), spline rows of moderate bin contrast, a N(0.1, 0.9^2)
    base."""
    def dense(i, o):
        w = rng.normal(size=(i, o)) * np.sqrt(2.0 / (i + o))
        return w.astype(f32), (0.1 * rng.normal(size=o)).astype(f32)

    (ew1, eb1), (ew2, eb2) = dense(d_x, H), dense(H, 2)
    (dw1, db1), (dw2, db2) = dense(1, H), dense(H, 2 * d_x)
    tables = spline_rows(rng, B, K, spread=0.5)
    return ((ew1, eb1, ew2, eb2), (dw1, db1, dw2, db2), tables,
            np.array([0.1, 0.9], f32))


@pytest.mark.parametrize("d_x,H,acts,B,K", [
    (2, 200, ("relu", "relu"), 2, 32),   # the flagship's widths
    (1, 7, ("tanh", "relu"), 1, 8),      # padding: 7 units to 8
    (3, 37, ("relu", "tanh"), 3, 16),
    (5, 64, ("tanh", "tanh"), 2, 8),     # R = 2
    (8, 30, ("relu", "relu"), 2, 2),     # R = 2, padding 30 to 32
])
def test_proposal_order_of_sums_matches_plain_and_pallas(d_x, H, acts, B, K):
    """The emulated kernel (its lane split, butterfly, zero-padded units
    and table search) against the plain version and JAX's Pallas
    proposal in interpret mode, on the same normals, N = 77 (not a tile
    or a warp multiple): samples to 1e-5 + 1e-5|v| against the plain
    version (sums of H float32 terms in another order; the same knots),
    5e-5 + 1e-5|v| against Pallas (its knots are offsets from range_min,
    a rounding that B spline blocks magnify: tests/test_torch_ops.py's
    5e-5; the plain version is 2.6e-5 from it at B = 3, K = 16);
    log-densities (sums of six O(10) terms) to 2e-4 + 1e-5|v|, as
    tests/test_torch_flagship.py holds the plain version to Pallas."""
    rng = np.random.default_rng(d_x * 1000 + H)
    enc_w, dec_w, tables, base = proposal_weights(rng, d_x, H, B, K)
    n = 77
    x1 = rng.normal(size=(n, d_x)).astype(f32)
    noise = rng.normal(size=(n, 2 + d_x)).astype(f32)
    R = tmf.kernel_plan(n, d_x, H, B, K)["R"]
    got = proposal_emulated(x1, noise, enc_w, dec_w, tables, base, acts, R)
    spec_t = tmf._Spec(d_x, 1, acts[0], acts[1], K, RANGE_MIN)
    with torch.no_grad():
        plain = tmf.vae_proposal_plain(
            t(x1), torch.tensor([1, 2], dtype=torch.int32),
            [t(a) for a in enc_w], [t(a) for a in dec_w],
            [t(a) for a in tables], t(base), spec_t, noise=t(noise))
    jw = [[jnp.asarray(a) for a in ws] for ws in (enc_w, dec_w, tables)]
    pallas = jmf.fused_vae_proposal(
        jnp.asarray(x1), jnp.asarray([1, 2], jnp.int32), *jw,
        jnp.asarray(base), jmf._Spec(d_x, 1, acts[0], acts[1], K, RANGE_MIN),
        noise=jnp.asarray(noise), interpret=True)
    for name, g, p, j in zip(("x2", "fwd", "rev", "z1", "z2"), got, plain,
                             pallas):
        dens = name in ("fwd", "rev")
        g = np.asarray(g).reshape(np.shape(j))
        np.testing.assert_allclose(g, p.numpy().reshape(g.shape),
                                   atol=2e-4 if dens else 1e-5, rtol=1e-5,
                                   err_msg=f"{name} vs plain")
        np.testing.assert_allclose(g, np.asarray(j),
                                   atol=2e-4 if dens else 5e-5, rtol=1e-5,
                                   err_msg=f"{name} vs Pallas")

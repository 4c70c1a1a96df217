"""The spread over seeds of the OPES convergence check of
tests/test_opes.py (the 8 kT double well, 32 walkers, 12 000 steps): the
largest and mean error of the recovered profile against U(s) on |s| < 1.3,
for the JAX package (``--package jax``, seed = its PRNGKey) or the port on
the CPU (``--package torch``, seed = its torch.Generator).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/opes_error_spread.py \\
        --package jax 1 2 3

prints one line per seed: seed, max error, mean error (kT).
"""

import argparse

import numpy as np


def profile_error(s, f):
    sel = np.abs(s) < 1.3
    err = (f - 8.0 * (s ** 2 - 1.0) ** 2)[sel]
    err = err - err.mean()
    return float(np.abs(err).max()), float(np.abs(err).mean())


def run_jax(seed):
    import jax
    import jax.numpy as jnp
    from vaemolsim_tpu import opes

    def dw(x):
        return 8.0 * (x[..., 0, 0] ** 2 - 1.0) ** 2

    x0 = jnp.full((32, 1, 1), -1.0) + 0.05 * jax.random.normal(
        jax.random.PRNGKey(0), (32, 1, 1))
    g = opes.opes_grid(-1.8, 1.8, 121, barrier=12.0, gamma=10.0)
    _, g, _ = jax.jit(lambda x, k: opes.opes_baoab(
        dw, lambda y: y[..., 0, 0], x, jnp.zeros_like(x), k, dt=0.01,
        n_steps=12_000, deposit_every=20, grid=g, sigma=0.12,
        friction=2.0))(x0, jax.random.PRNGKey(seed))
    return profile_error(*map(np.asarray, opes.free_energy_from_opes(g)))


def run_torch(seed):
    import torch
    from vaemolsim_tpu_torch import opes

    def dw(x):
        return 8.0 * (x[..., 0, 0] ** 2 - 1.0) ** 2

    gen = torch.Generator().manual_seed(seed)
    x0 = -1.0 + 0.05 * torch.randn(32, 1, 1, generator=gen)
    g = opes.opes_grid(-1.8, 1.8, 121, barrier=12.0, gamma=10.0,
                       device="cpu")
    _, g, _ = opes.opes_baoab(dw, lambda y: y[..., 0, 0], x0,
                              torch.zeros_like(x0), gen, dt=0.01,
                              n_steps=12_000, deposit_every=20, grid=g,
                              sigma=0.12, friction=2.0)
    return profile_error(*(a.double().numpy()
                           for a in opes.free_energy_from_opes(g)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args()
    run = run_jax if args.package == "jax" else run_torch
    for seed in args.seeds:
        e_max, e_mean = run(seed)
        print(f"{args.package} {seed} {e_max:.4f} {e_mean:.4f}", flush=True)


if __name__ == "__main__":
    main()

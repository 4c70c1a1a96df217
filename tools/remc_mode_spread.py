"""The spread over seeds of example 05's result (examples/05_replica_
exchange.py at its default depths: 6 replicas x 256 chains x 150 steps,
all chains started in the left mode of the rough two-mode target): the
cold replica's right-mode fraction, for the JAX package (``--package
jax``, seed = its PRNGKey, as the example runs it) or the port on the
CPU (``--package torch``, seed = the torch.Generator of
``chip_smoke.example_05``, on one rank).  ``chip_smoke.py`` holds the
card's fraction to the band the JAX spread gives (``EX05_FRAC_BAND``).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/remc_mode_spread.py \\
        --package jax 0 1 2 3 4 5 6 7

prints one line per seed (seed, fraction, swap acceptance), then the
least, mean and largest fraction.
"""

import argparse

import numpy as np


def run_jax(seed):
    import jax
    import jax.numpy as jnp
    from vaemolsim_tpu.ops import distributions as d
    from vaemolsim_tpu.parallel import (REMCState, make_remc_step, run_remc,
                                        temperature_ladder)

    target = d.MixtureSameFamily(
        jnp.zeros(2), d.Normal(jnp.array([-6.0, 6.0]), 0.4 * jnp.ones(2)))

    def log_target(x):
        return target.log_prob(x[..., 0])

    def enc(x):
        z = jnp.zeros(x.shape[:-1] + (1,))
        return d.Independent(d.Normal(z, jnp.ones_like(z)), 1)

    def dec(z):
        loc = jnp.zeros(z.shape[:-1] + (1,))
        return d.Independent(d.Normal(loc, 3.0 * jnp.ones_like(loc)), 1)

    step = make_remc_step(enc, enc, dec, log_target, exchange_every=2)
    state = REMCState.create(jnp.full((6, 256, 1), -6.0), log_target,
                             temperature_ladder(6, beta_min=0.05),
                             jax.random.PRNGKey(seed))
    final = jax.jit(lambda s: run_remc(step, s, 150))(state)
    return (float(jnp.mean(final.configs[0, :, 0] > 0)),
            float(final.swap_acceptance_rate))


def run_torch(seed):
    import torch

    import chip_smoke

    row = chip_smoke.example_05(torch.device("cpu"), seed=seed, check=False)
    return row["right_mode_fraction"], row["swap_acceptance"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("jax", "torch"), default="jax")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args()
    run = run_jax if args.package == "jax" else run_torch
    fracs = []
    for seed in args.seeds:
        frac, swap = run(seed)
        fracs.append(frac)
        print(f"{seed} {frac:.4f} {swap:.4f}", flush=True)
    print(f"least {min(fracs):.4f} mean {np.mean(fracs):.4f} "
          f"largest {max(fracs):.4f}")


if __name__ == "__main__":
    main()

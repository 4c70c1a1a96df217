"""The spread over seeds of example 31's DiffTRe fit (examples/31_difftre_
top_down.py at its default depth) and of its four asserts: the fitted
epsilon and sigma, the last fresh loss over the first, and the fitted
potential's largest g(r) error beyond r = 0.85.  ``--package jax`` runs the
example's own code with its PRNGKeys 0, 3, 4 and 5 shifted by the seed
(seed 0 is the example as it stands), at the default depth or with
``--full`` at the example's --full depth; ``--package torch`` runs the port's
``chip_smoke.example_31`` on the CPU with ``torch.Generator`` seeded by
the seed (31 is chip_smoke's).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/difftre_seed_spread.py \\
        --package jax 0 1 2

prints one line per seed: seed, epsilon, sigma, loss ratio, max |dg| and
whether all four asserts hold.
"""

import argparse
import importlib.util
import os

import numpy as np


def run_jax(seed, full):
    import jax
    import jax.numpy as jnp
    from vaemolsim_tpu import difftre, md, potentials
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "31_difftre_top_down.py")
    spec = importlib.util.spec_from_file_location("example_31", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    if full:
        ex.N_OUTER, ex.INNER, ex.MD_STEPS = 14, 25, 1000
    N, BOX = ex.N, ex.BOX
    true_params = {"log_eps": jnp.asarray(0.0),
                   "log_sigma": jnp.asarray(0.0)}
    true_pot = ex.make_pot(true_params)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    x0 = BOX * jax.random.uniform(k1, (32, N, 3))
    x0 = potentials.minimize_energy(true_pot, x0, steps=300, lr=0.05)
    _, traj = jax.jit(lambda x, k: md.baoab(
        true_pot, x, jnp.zeros_like(x), k, dt=0.003, n_steps=3000,
        friction=1.0, kT=ex.KT, collect_every=100))(x0, k2)
    ref = traj[10:].reshape(-1, N, 3)
    g_target = jnp.mean(ex.frame_rdf(ref), axis=0)
    p_target = float(jnp.mean(ex.frame_pressure(true_params, ref)))
    params = {"log_eps": jnp.log(jnp.asarray(0.6)),
              "log_sigma": jnp.log(jnp.asarray(1.12))}
    x_warm = potentials.minimize_energy(
        ex.make_pot(params),
        BOX * jax.random.uniform(jax.random.PRNGKey(seed + 3),
                                 (ex.CHAINS, N, 3)), steps=300, lr=0.05)

    @jax.jit
    def run_md(params, x0, key):
        st, traj = md.baoab(ex.make_pot(params), x0, jnp.zeros_like(x0),
                            key, dt=0.003, n_steps=ex.MD_STEPS,
                            friction=1.0, kT=ex.KT,
                            collect_every=ex.COLLECT)
        traj = traj[traj.shape[0] // 3:]
        return traj.reshape(-1, N, 3), st.x

    def sample_fn(params, key, state):
        return run_md(params, x_warm if state is None else state, key)

    res = difftre.difftre_fit(
        ex.potential, params, sample_fn=sample_fn,
        observable_fns={"rdf": difftre.static_observable(ex.frame_rdf),
                        "pressure": ex.frame_pressure},
        targets={"rdf": g_target, "pressure": p_target},
        weights={"rdf": 1.0, "pressure": 1.0}, beta=ex.BETA,
        key=jax.random.PRNGKey(seed + 4), n_outer=ex.N_OUTER,
        inner_steps=ex.INNER, ess_frac=0.4, learning_rate=0.05)
    frames_fit, _ = run_md(res.params, x_warm, jax.random.PRNGKey(seed + 5))
    g_fit = jnp.mean(ex.frame_rdf(frames_fit), axis=0)
    sel = np.asarray(0.5 * (ex._edges[:-1] + ex._edges[1:])) > 0.85
    return (float(jnp.exp(res.params["log_eps"])),
            float(jnp.exp(res.params["log_sigma"])),
            res.history["loss"][-1] / res.history["loss"][0],
            float(jnp.max(jnp.abs(g_fit - g_target)[sel])))


def run_torch(seed, full):
    import torch
    import chip_smoke
    if full:
        chip_smoke.DT_OUTER, chip_smoke.DT_INNER = 14, 25
        chip_smoke.DT_MD_STEPS = 1000
    out, _ = chip_smoke.example_31(torch.device("cpu"), seed)
    losses = out["fresh_losses"]
    return (out["epsilon"], out["sigma"], losses[-1] / losses[0],
            out["max_dg"])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    ap.add_argument("--full", action="store_true",
                    help="the example's --full depth: 14 rounds of up to 25 "
                    "inner steps and 1000 MD steps a round")
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args()
    run = run_jax if args.package == "jax" else run_torch
    for seed in args.seeds:
        eps, sig, ratio, g_err = run(seed, args.full)
        ok = (abs(eps - 1.0) < 0.2 and abs(sig - 1.0) < 0.05
              and ratio < 0.1 and g_err < 0.35)
        print(f"{args.package} {seed} eps {eps:.4f} sigma {sig:.4f} loss "
              f"ratio {ratio:.4f} max_dg {g_err:.4f} ok {ok}", flush=True)


if __name__ == "__main__":
    main()

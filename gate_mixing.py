#!/usr/bin/env python3
"""How the posterior gate's quantities mix on a demo pulsar, on the CPU:
the float64 oracle's long chains, and the JAX package's many-chain kernel
as the reference for the port's rows of ``chip_smoke.py`` phase 24.

    python3 gate_mixing.py oracle --model beta --niter 40000 \\
        --seeds 5123 6123 7123 8123 [--pulsar-seed 42] [--burn 1000]
    JAX_PLATFORMS=cpu python3 gate_mixing.py jax --model beta \\
        --niter 2000 [--nchains 1024] [--float64] [--pulsar-seed 42] \\
        [--from 600]

``oracle`` runs the port's ``NumpyGibbs`` (bit for bit the JAX package's)
from a prior draw of each seed, one process a seed, on the demo pulsar
``make_demo_model_arrays(n=130, components=30, seed=--pulsar-seed)`` with
``run_sims.model_configs()[--model]``. ``jax`` runs the JAX package's
``JaxGibbs`` on the same pulsar and configuration from the gate's kernel
seed (124), ``record="compact"`` (``"full"`` in float64 under
``--float64``); it is a reference run on the CPU, never on the card.

Each prints, per window of sweeps (1,000 for the oracle, 100 for the
kernel), the df > 1 share, the df mean, alpha_log10_mean and theta; then,
past ``--burn`` (oracle) or ``--from`` (kernel), the df > 1 share and the
episodes of df > 1 (runs of consecutive sweeps: how many, their mean and
longest length; for the kernel, how many chains have any). The kernel also
prints the means over the rows tools/tpu_gate.py keeps of its 500 sweeps
(150, 170, ..., 490).
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def _fields(res):
    """(df, alpha_log10_mean, theta) arrays of a result, float64."""
    df = np.asarray(res.dfchain, np.float64)
    alpha = np.log10(np.maximum(np.asarray(res.alphachain, np.float64),
                                1e-300)).mean(axis=-1)
    return df, alpha, np.asarray(res.thetachain, np.float64)


def _windows(label, df, alpha, theta, width):
    for k in range(0, len(df), width):
        w = slice(k, k + width)
        print(f"{label} sweeps {k}-{k + width}: df>1 "
              f"{(df[w] > 1).mean():.4f} df {df[w].mean():.4f} alpha_log10 "
              f"{alpha[w].mean():.4f} theta {theta[w].mean():.4f}",
              flush=True)


def _episodes(on):
    """Lengths of the runs of True in the 1-D ``on``."""
    edges = np.flatnonzero(np.diff(on.astype(np.int8))) + 1
    return [len(r) for r in np.split(on, edges) if r.size and r[0]]


def _oracle_chain(model, niter, seed, pulsar_seed):
    sys.path.insert(0, HERE)
    from gibbs_student_t_tpu_torch.backends.numpy_backend import NumpyGibbs
    from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
    from gibbs_student_t_tpu_torch.drivers.run_sims import model_configs

    ma = make_demo_model_arrays(n=130, components=30, seed=pulsar_seed)
    res = NumpyGibbs(ma, model_configs()[model]).sample(
        ma.x_init(np.random.default_rng(seed)), niter, seed=seed)
    return seed, _fields(res)


def oracle(args):
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(args.seeds)) as pool:
        runs = pool.starmap(_oracle_chain, [
            (args.model, args.niter, s, args.pulsar_seed)
            for s in args.seeds])
    kept = []
    for seed, (df, alpha, theta) in runs:
        label = f"oracle {args.model} pulsar {args.pulsar_seed} seed {seed}"
        _windows(label, df, alpha, theta, 1000)
        on = df[args.burn:] > 1
        ep = _episodes(on)
        kept.append(on)
        print(f"{label}: past {args.burn}: df>1 {on.mean():.4f}, "
              f"{len(ep)} episodes, mean length "
              f"{np.mean(ep) if ep else 0:.1f}, longest "
              f"{max(ep) if ep else 0}", flush=True)
    print(f"oracle {args.model} pulsar {args.pulsar_seed}: pooled df>1 "
          f"past {args.burn}: {np.concatenate(kept).mean():.4f}")


def jax_kernel(args):
    sys.path.insert(0, HERE)
    import importlib.util

    import jax

    if args.float64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from gibbs_student_t_tpu.backends import JaxGibbs
    from gibbs_student_t_tpu.data.demo import make_demo_model_arrays

    spec = importlib.util.spec_from_file_location(
        "jax_run_sims", os.path.join(HERE, "run_sims.py"))
    run_sims = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run_sims)
    ma = make_demo_model_arrays(n=130, components=30, seed=args.pulsar_seed)
    cfg = run_sims.model_configs()[args.model]
    gb = (JaxGibbs(ma, cfg, nchains=args.nchains, chunk_size=100,
                   record="full", dtype=jnp.float64) if args.float64 else
          JaxGibbs(ma, cfg, nchains=args.nchains, chunk_size=100,
                   record="compact"))
    df, alpha, theta = _fields(gb.sample(niter=args.niter, seed=124))
    label = (f"jax{'64' if args.float64 else '32'} {args.model} pulsar "
             f"{args.pulsar_seed} {args.nchains} chains")
    _windows(label, df, alpha, theta, 100)
    g = slice(150, 500, 20)
    print(f"{label}: tpu_gate.py's rows (150, 170, ..., 490): df "
          f"{df[g].mean():.4f} alpha_log10 {alpha[g].mean():.4f} theta "
          f"{theta[g].mean():.4f}")
    on = df[args.start:] > 1
    visited = on.any(axis=0)
    ep = [n for c in range(on.shape[1]) for n in _episodes(on[:, c])]
    print(f"{label}: past {args.start}: df>1 {on.mean():.4f}, chains with "
          f"any {int(visited.sum())} of {on.shape[1]}, {len(ep)} episodes, "
          f"mean length {np.mean(ep) if ep else 0:.1f}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("side", choices=["oracle", "jax"])
    ap.add_argument("--model", default="beta")
    ap.add_argument("--pulsar-seed", type=int, default=42)
    ap.add_argument("--niter", type=int, default=10000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[123])
    ap.add_argument("--burn", type=int, default=1000)
    ap.add_argument("--nchains", type=int, default=1024)
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--from", dest="start", type=int, default=600)
    args = ap.parse_args(argv)
    (oracle if args.side == "oracle" else jax_kernel)(args)


if __name__ == "__main__":
    main()

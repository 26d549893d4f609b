"""Batch experiment driver: the port's ``run_sims.py``.

    python -m gibbs_student_t_tpu_torch.drivers.run_sims \\
        --nchains 1024 --niter 10000 --burn 100 --outdirs o1 o2

For each outlier fraction theta: simulate a dataset, load the outlier and
clean twins, build the reference's model (constant efac, uniform equad,
30-component power-law red noise, SVD timing basis with a flat prior;
reference run_sims.py:57-76), run the five model configurations (vvh17,
mixture-uniform, mixture-beta, gaussian, t; reference run_sims.py:86-107)
through ``TorchGibbs``, and save the seven chain arrays with ``--burn``
rows dropped into ``{outdir}/{model}/{theta}/{idx}/`` (reference
run_sims.py:114-124), with the chain axis after the row axis. With
``--ensemble N``, one theta's N pulsars (heterogeneous TOA counts) run as
one ``EnsembleGibbs`` population over a ``('pulsar', 'chain')`` mesh of
the GPUs (as the JAX driver builds it: the largest grid that divides both
populations; 1 x 1 on one GPU, or under ``--device cpu``) and each
pulsar's tree lands under ``{outdir}/ensemble/{model}/{theta}/{i:02d}_{name}``.

``--backend`` selects the sampler through ``backends.get_backend``:
``torch`` (the default) runs ``TorchGibbs`` as above; ``cpu`` runs the
float64 NumPy oracle (backends/numpy_backend.py), one chain a config on
the host, as the JAX package's ``run_sims.py --backend cpu`` runs it (the
same arrays for the same arguments), and refuses the flags that need the
chain axis (``--adapt``, ``--mtm``, ``--until-rhat``, ``--ensemble``,
``--telemetry-dir``). The torch backend runs on the GPU (``--device
cuda``, the default) and exits non-zero, naming CUDA, where CUDA is
absent; ``--device cpu`` runs the kernels' plain versions on the CPU.
The JAX script's default backend is ``cpu``; this driver's is ``torch``.
A flag of the JAX package's run_sims.py that this driver does not take:

  --unroll      the ensemble's unrolled form bakes each pulsar's
                constants into its own XLA trace; eager PyTorch has no
                trace, so only the grouped form exists

``--introspect`` prints what the run built and launched (obs/introspect.py:
each chunk program's first chunk, the kernels' build, every kernel with
its implementation and launch form, the linalg implementations) to stderr
after the run; the ledger record carries the same ``cuda`` block whether
or not it is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

from gibbs_student_t_tpu_torch.drivers.simulate_data import (
    check_device,
    ensure_base_dataset,
)


def build_pta(psr, components: int = 30):
    """The reference's simulated-data model (reference run_sims.py:57-76)."""
    from gibbs_student_t_tpu_torch.data.demo import make_reference_pta

    return make_reference_pta(psr, components)


def model_configs(pspin: float = 0.00457):
    """The five sampler configurations of reference run_sims.py:86-107."""
    from gibbs_student_t_tpu_torch.config import GibbsConfig

    return {
        "vvh17": GibbsConfig(model="vvh17", vary_df=False,
                             theta_prior="uniform", vary_alpha=False,
                             alpha=1e10, pspin=pspin),
        "uniform": GibbsConfig(model="mixture", vary_df=True,
                               theta_prior="uniform"),
        "beta": GibbsConfig(model="mixture", vary_df=True,
                            theta_prior="beta"),
        "gaussian": GibbsConfig(model="gaussian", vary_df=True,
                                theta_prior="beta"),
        "t": GibbsConfig(model="t", vary_df=True, theta_prior="beta"),
    }


def run_one(ma, cfg, device: str, niter: int, nchains: int, seed: int,
            record: str = "compact8", record_thin: int = 1,
            until_rhat: float = 0.0, check_every: int = 500,
            min_ess: float = 0.0, telemetry: bool = True, metrics=None,
            backend: str = "torch"):
    """One configuration's run through ``backend`` (``get_backend``):
    ``TorchGibbs``'s ``niter`` sweeps, or, with ``until_rhat``, until
    split-R-hat clears it (``niter`` is then the cap); the NumPy oracle's
    single chain of ``niter`` sweeps from a prior draw of ``seed``, as the
    JAX script runs it."""
    from gibbs_student_t_tpu_torch.backends import get_backend

    cls = get_backend(backend)
    if not cls.supports_chains:
        return cls(ma, cfg).sample(ma.x_init(np.random.default_rng(seed)),
                                   niter, seed=seed)
    gb = cls(ma, cfg, nchains=nchains, device=device, record=record,
             record_thin=record_thin, telemetry=telemetry, metrics=metrics)
    if until_rhat:
        return gb.sample_until(rhat_target=until_rhat, max_sweeps=niter,
                               check_every=check_every, seed=seed,
                               min_ess=min_ess or None)
    return gb.sample(niter=niter, seed=seed)


def _synced(device: str) -> None:
    """Wait for the devices, so a wall read next covers their work (an
    ensemble's mesh may hold every card)."""
    if device == "cuda":
        import torch

        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _summarize(key: str, res, dt: float, niter: int) -> str:
    """One observability line per config: wall, throughput and MH
    acceptance rates."""
    parts = [f"{key}: {dt:.1f}s, {niter / dt:.1f} sweeps/s"]
    parts += [f"acc[{blk}]={acc.mean():.2f}"
              for blk, acc in res.acceptance_rates().items()]
    if "rhat" in res.stats:
        # a convergence-stopped run did fewer sweeps than the --niter cap
        sweeps = res.chain.shape[0] * int(res.stats.get("record_thin", 1))
        parts[0] = f"{key}: {dt:.1f}s, {sweeps / dt:.1f} sweeps/s"
        parts.append(f"rhat_max={float(np.max(res.stats['rhat'])):.3f}"
                     f" converged={bool(res.stats['converged'])}"
                     f" rows={res.chain.shape[0]}")
    return "  # " + ", ".join(parts)


def _health_line(res) -> str | None:
    """Per-config chain-health verdict from the drained telemetry
    (obs/health.py); None when the run carried none."""
    if "tele_diverged" not in res.stats:
        return None
    from gibbs_student_t_tpu_torch.obs.health import (
        chain_health,
        format_health,
    )

    window = None
    if res.chain.ndim == 3 and res.chain.shape[0] >= 8:
        window = res.chain[res.chain.shape[0] // 2:]
    return "  # " + format_health(chain_health(res.stats, window=window))


def _tele_chain_fields(res) -> dict:
    """Per-chain telemetry for the ``config_end`` event: run-mean accept
    rates and the non-finite/diverged counters, one entry per chain."""
    tele = res.stats
    if "tele_diverged" not in tele:
        return {}
    return {"chains": {
        "accept_white": np.round(np.asarray(tele["tele_accept_white"],
                                            np.float64), 4),
        "accept_hyper": np.round(np.asarray(tele["tele_accept_hyper"],
                                            np.float64), 4),
        "nonfinite": tele["tele_nonfinite"],
        "diverged": tele["tele_diverged"],
    }}


def run_ensemble(args, configs, parfile, timfile, rng):
    """``--ensemble N``: an N-pulsar array sampled as one
    ``EnsembleGibbs`` population over a mesh (the grouped kernels in each
    block). Pulsar datasets get distinct noise realizations and
    heterogeneous TOA counts (``ntoa - (i % 3) * (ntoa // 13)``); the
    ensemble masks the padding and each pulsar's tree is saved
    unpadded."""
    import torch

    from gibbs_student_t_tpu_torch.data.pulsar import Pulsar
    from gibbs_student_t_tpu_torch.data.simulate import simulate_data
    from gibbs_student_t_tpu_torch.obs.tracing import trace_to
    from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs, make_mesh

    theta = args.thetas[0]
    mas = []
    for i in range(args.ensemble):
        idx = int(rng.integers(0, 2 ** 32))
        out1, _ = simulate_data(parfile, timfile, theta=theta, idx=idx,
                                sigma_out=args.sigma_out,
                                outdir=args.simdir, rng=rng,
                                keep=args.ntoa - (i % 3) * (args.ntoa // 13))
        name = os.path.splitext(
            [f for f in os.listdir(out1) if f.endswith(".par")][0])[0]
        psr = Pulsar(f"{out1}/{name}.par", f"{out1}/{name}.tim")
        mas.append(build_pta(psr, args.components).frozen())
    # the largest device grid whose axes divide the pulsar and chain
    # populations (even blocks); unused devices are left idle
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if args.device == "cuda" else [torch.device("cpu")])
    ndev = len(devices)
    n_p = n_c = 1
    for cp in range(1, ndev + 1):
        if args.ensemble % cp:
            continue
        for cc in range(1, ndev // cp + 1):
            if args.nchains % cc == 0 and cp * cc > n_p * n_c:
                n_p, n_c = cp, cc
    # always a mesh, even of one device (1 x 1): the run on the card takes
    # the sharded path the CPU mesh tests hold
    mesh = make_mesh({"pulsar": n_p, "chain": n_c},
                     devices=devices[:n_p * n_c])
    print(f"# ensemble: {args.ensemble} pulsars x {args.nchains} chains "
          f"on {ndev} device(s), mesh {mesh.shape}", file=sys.stderr,
          flush=True)

    for key, cfg in configs.items():
        seed = int(rng.integers(0, 2 ** 31))
        ens = EnsembleGibbs(mas, cfg, nchains=args.nchains, mesh=mesh,
                            record=args.record,
                            record_thin=args.record_thin,
                            telemetry=args.telemetry, metrics=args.registry)
        if args.registry is not None:
            args.registry.emit("config_start", config=key, seed=seed,
                               ensemble=args.ensemble)
        t0 = time.perf_counter()
        with trace_to(args.trace_dir):
            if args.until_rhat:
                res = ens.sample_until(rhat_target=args.until_rhat,
                                       max_sweeps=args.niter,
                                       check_every=args.check_every,
                                       seed=seed,
                                       min_ess=args.min_ess or None)
            else:
                res = ens.sample(niter=args.niter, seed=seed)
            _synced(args.device)
        dt = time.perf_counter() - t0
        sweeps = (res.chain.shape[0] * args.record_thin
                  * args.ensemble * args.nchains)
        extra = ""
        if "rhat" in res.stats:
            extra = (f", rhat_max={float(np.max(res.stats['rhat'])):.3f}"
                     f" converged={bool(res.stats['converged'])}")
        print(f"  # {key}: {dt:.1f}s, {sweeps / dt:.0f} "
              f"pulsar-chain-sweeps/s{extra}", file=sys.stderr, flush=True)
        health = _health_line(res)
        if health:
            print(health, file=sys.stderr, flush=True)
        if args.registry is not None:
            args.registry.emit("config_end", config=key, seconds=round(dt, 2),
                               pulsar_chain_sweeps_per_sec=round(
                                   sweeps / dt, 1),
                               **_tele_chain_fields(res))
        args.ledger_rows.append({
            "config": key, "ensemble": args.ensemble,
            "seconds": round(dt, 2),
            "pulsar_chain_sweeps_per_sec": round(sweeps / dt, 1)})
        burned = res.burn(args.burn)
        for i, ma in enumerate(mas):
            # simulated pulsars share the base pulsar's name; the index
            # keeps their trees apart
            out = os.path.join(args.outdirs[0], "ensemble", key,
                               str(theta), f"{i:02d}_{ma.name or 'pulsar'}")
            burned.select_pulsar(i).save(out)
            print(out, flush=True)


def run_sequential(args, configs, rng, parfile, timfile):
    from gibbs_student_t_tpu_torch.data.pulsar import Pulsar
    from gibbs_student_t_tpu_torch.data.simulate import simulate_data
    from gibbs_student_t_tpu_torch.obs.tracing import trace_to

    for theta in args.thetas:
        idx = int(rng.integers(0, 2 ** 32))
        out1, out2 = simulate_data(parfile, timfile, theta=theta, idx=idx,
                                   sigma_out=args.sigma_out,
                                   outdir=args.simdir, rng=rng)
        name = os.path.splitext(
            [f for f in os.listdir(out1) if f.endswith(".par")][0])[0]
        psrs = [Pulsar(f"{d}/{name}.par", f"{d}/{name}.tim")
                for d in (out1, out2)]

        for psr, outdir in zip(psrs, args.outdirs):
            ma = build_pta(psr, args.components).frozen()
            for key, cfg in configs.items():
                seed = int(rng.integers(0, 2 ** 31))
                if args.registry is not None:
                    args.registry.emit("config_start", config=key,
                                       theta=theta, seed=seed,
                                       outdir=outdir)
                t0 = time.perf_counter()
                with trace_to(args.trace_dir):
                    res = run_one(ma, cfg, args.device, args.niter,
                                  args.nchains, seed, record=args.record,
                                  record_thin=args.record_thin,
                                  until_rhat=args.until_rhat,
                                  check_every=args.check_every,
                                  min_ess=args.min_ess,
                                  telemetry=args.telemetry,
                                  metrics=args.registry,
                                  backend=args.backend)
                    _synced(args.device)
                dt = time.perf_counter() - t0
                out = os.path.join(outdir, key, str(theta), str(idx))
                res.burn(args.burn).save(out)
                print(out, flush=True)
                print(_summarize(key, res, dt, args.niter), file=sys.stderr,
                      flush=True)
                health = _health_line(res)
                if health:
                    print(health, file=sys.stderr, flush=True)
                if args.registry is not None:
                    args.registry.emit("config_end", config=key,
                                       theta=theta, seconds=round(dt, 2),
                                       sweeps_per_sec=round(
                                           args.niter / dt, 2),
                                       **_tele_chain_fields(res))
                args.ledger_rows.append({
                    "config": key, "theta": theta,
                    "seconds": round(dt, 2),
                    "sweeps_per_sec": round(args.niter / dt, 2)})


def _write_ledger(args):
    """One run-ledger record for this invocation: the per-config
    throughput rows with provenance (obs/ledger.py)."""
    if args.ledger == "":
        return
    try:
        from gibbs_student_t_tpu_torch.obs import ledger as ledger_mod

        cfg = {k: v for k, v in vars(args).items()
               if k not in ("registry", "ledger_rows")}
        path = ledger_mod.append_record(ledger_mod.make_record(
            "run_sims",
            {"configs": args.ledger_rows,
             "n_configs_done": len(args.ledger_rows)},
            platform=args.device, config=cfg), args.ledger)
        print(f"# ledger record -> {path}", file=sys.stderr)
    except Exception as e:  # noqa: BLE001 - never fail the run over it
        print(f"# ledger write failed: {type(e).__name__}: {e}",
              file=sys.stderr)


def parse_args(argv=None):
    """The driver's arguments, validated: a bad combination exits through
    ``argparse`` before any dataset work."""
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--thetas", type=float, nargs="+",
                    default=[0.05, 0.1, 0.15])
    ap.add_argument("--niter", type=int, default=10000)
    ap.add_argument("--burn", type=int, default=100)
    ap.add_argument("--backend", choices=["cpu", "torch"], default="torch",
                    help="torch: TorchGibbs, many chains (default); cpu: "
                         "the float64 NumPy oracle, one chain a config on "
                         "the host (--device does not apply)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the torch backend runs: the GPU (default; "
                         "exits if CUDA is absent) or the CPU (the "
                         "kernels' plain versions)")
    ap.add_argument("--nchains", type=int, default=64,
                    help="chains per config")
    ap.add_argument("--ensemble", type=int, default=0, metavar="N",
                    help="sample an N-pulsar array as one (pulsar x chain) "
                         "population instead of the per-dataset pipeline "
                         "(uses --thetas[0])")
    ap.add_argument("--adapt", type=int, default=None, metavar="N",
                    help="adapt MH jump scales for the first N sweeps "
                         "(Robbins-Monro, then frozen; set --burn to at "
                         "least N rows). Default min(100, burn * "
                         "record_thin), so kept rows are post-freeze; 0 = "
                         "the reference's fixed scales")
    ap.add_argument("--adapt-cov", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="with --adapt: population-covariance joint "
                         "proposals (per pulsar under --ensemble). "
                         "Default: on whenever --adapt > 0")
    ap.add_argument("--mtm", type=int, default=0, metavar="K",
                    help="multiple-try Metropolis with K candidates per "
                         "MH step; 0 = the reference's single-try kernel")
    ap.add_argument("--mtm-blocks", nargs="+",
                    default=["white", "hyper"],
                    choices=("white", "hyper"),
                    help="which MH blocks go multiple-try under --mtm")
    ap.add_argument("--until-rhat", type=float, default=0.0,
                    metavar="TARGET",
                    help="stop each config once every parameter's "
                         "split-R-hat over the chain axis drops below "
                         "TARGET (--niter becomes the cap; checked every "
                         "--check-every sweeps)")
    ap.add_argument("--min-ess", type=float, default=0.0,
                    help="with --until-rhat: also require this many "
                         "pooled effective samples of every parameter")
    ap.add_argument("--check-every", type=int, default=500,
                    help="sweeps between R-hat checks for --until-rhat")
    ap.add_argument("--record", default="compact8",
                    choices=["compact", "compact8", "full", "light"],
                    help="chain recording tier: narrow wire dtypes, full "
                         "precision, or O(1) fields only")
    ap.add_argument("--record-thin", type=int, default=1,
                    help="record every Nth sweep. --niter stays in SWEEPS "
                         "(a multiple of N); --burn counts recorded ROWS")
    ap.add_argument("--telemetry", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="carry the in-run telemetry (accept sums, "
                         "per-chain non-finite flags, log-posterior) and "
                         "print a chain-health line per config")
    ap.add_argument("--telemetry-dir", metavar="DIR", default=None,
                    help="write manifest.json and stream per-chunk events "
                         "(events.jsonl) into DIR (obs/metrics.py)")
    ap.add_argument("--trace-dir", metavar="DIR", default=None,
                    help="capture a torch.profiler Chrome trace of each "
                         "config's sampling into DIR; the sweep stages "
                         "carry gibbs/* spans (obs/tracing.py)")
    ap.add_argument("--ledger", metavar="PATH", default=None,
                    help="append one run-ledger record per invocation "
                         "(obs/ledger.py). Default: GST_LEDGER_PATH or "
                         "artifacts/ledger.jsonl; '' disables")
    ap.add_argument("--introspect", action="store_true",
                    help="print what the run built and launched (each "
                         "chunk program's first chunk, the kernels' "
                         "build, every kernel with its implementation and "
                         "launch form; obs/introspect.py) to stderr after "
                         "the run; the ledger record carries it either "
                         "way")
    ap.add_argument("--models", nargs="+",
                    default=["vvh17", "uniform", "beta", "gaussian", "t"])
    ap.add_argument("--par", default=None)
    ap.add_argument("--tim", default=None)
    ap.add_argument("--ntoa", type=int, default=130)
    ap.add_argument("--components", type=int, default=30)
    ap.add_argument("--sigma-out", type=float, default=1e-6)
    ap.add_argument("--simdir", default="simulated_data")
    ap.add_argument("--outdirs", nargs=2,
                    default=["output_outlier", "output_no_outlier"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pspin", type=float, default=0.00457)
    args = ap.parse_args(argv)

    oracle = args.backend == "cpu"
    if oracle:
        args.device = "cpu"         # the oracle runs on the host
    check_device(ap, args.device)
    if args.adapt is None:
        # capped by the burn window (rows x thin = sweeps), so the kept
        # rows are always post-freeze; the oracle keeps the reference's
        # fixed scales
        args.adapt = (0 if oracle
                      else min(100, args.burn * max(args.record_thin, 1)))
    if args.adapt_cov is None:
        args.adapt_cov = args.adapt > 0
    if args.adapt_cov and not args.adapt:
        ap.error("--adapt-cov requires --adapt N")
    if args.min_ess and not args.until_rhat:
        ap.error("--min-ess composes with --until-rhat (it is an extra "
                 "stopping criterion, not a standalone mode)")
    if set(args.mtm_blocks) != {"white", "hyper"} and not args.mtm:
        ap.error("--mtm-blocks requires --mtm K")
    if oracle:
        for flag, given in (("--mtm", args.mtm), ("--adapt", args.adapt),
                            ("--until-rhat", args.until_rhat),
                            ("--ensemble", args.ensemble),
                            ("--telemetry-dir", args.telemetry_dir)):
            if given:
                ap.error(f"{flag} needs the torch backend; the NumPy "
                         "oracle runs the reference's single-chain "
                         "kernel with fixed jump scales")
    if args.until_rhat:
        thin = max(args.record_thin, 1)
        if (args.check_every < 1 or args.check_every % thin
                or args.check_every // thin < 8):
            ap.error("--check-every must be a multiple of --record-thin "
                     "covering >= 8 recorded rows")
        if args.niter % thin or args.niter < 1:
            ap.error("--niter (the sweep cap) must be a positive "
                     "multiple of --record-thin")
        if args.burn >= 2 * args.check_every // thin:
            ap.error(
                f"--burn ({args.burn} rows) must be smaller than the "
                f"earliest possible --until-rhat stop "
                f"(2 x check-every / record-thin = "
                f"{2 * args.check_every // thin} rows), or an early "
                "convergence would save empty chains")
    if args.telemetry_dir and not args.telemetry:
        ap.error("--telemetry-dir needs telemetry (drop --no-telemetry)")
    configs = model_configs(args.pspin)
    unknown = set(args.models) - set(configs)
    if unknown:
        ap.error(f"unknown --models {sorted(unknown)}; "
                 f"choose from {sorted(configs)}")
    return args


def main(argv=None):
    args = parse_args(argv)
    configs = model_configs(args.pspin)
    if args.adapt:
        configs = {k: v.with_adapt(args.adapt, adapt_cov=args.adapt_cov)
                   for k, v in configs.items()}
    if args.mtm:
        configs = {k: v.with_mtm(args.mtm, blocks=tuple(args.mtm_blocks))
                   for k, v in configs.items()}
    configs = {k: v for k, v in configs.items() if k in args.models}

    rng = np.random.default_rng(args.seed)
    parfile, timfile = ensure_base_dataset(args.par, args.tim, args.simdir,
                                           args.ntoa, args.seed)

    # run-level observability sink: the manifest once, then per-chunk
    # events from the samplers (obs/metrics.py)
    args.ledger_rows = []
    args.registry = None
    if args.telemetry_dir:
        from gibbs_student_t_tpu_torch.obs import MetricsRegistry

        args.registry = MetricsRegistry(run_dir=args.telemetry_dir)
        args.registry.write_manifest(
            config={k: dataclasses.asdict(v) for k, v in configs.items()},
            seeds=args.seed,
            extra={"device": args.device, "nchains": args.nchains,
                   "niter": args.niter, "thetas": args.thetas,
                   "ensemble": args.ensemble})
        print(f"# telemetry -> {args.telemetry_dir} "
              "(manifest.json, events.jsonl)", file=sys.stderr)

    try:
        if args.ensemble:
            run_ensemble(args, configs, parfile, timfile, rng)
        else:
            run_sequential(args, configs, rng, parfile, timfile)
    finally:
        if args.registry is not None:
            args.registry.close()
        # the record lands even when a config failed, so the configs that
        # did complete are documented
        _write_ledger(args)
        if args.introspect:
            from gibbs_student_t_tpu_torch.obs.introspect import (
                format_summary,
            )

            for ln in format_summary("  # "):
                print(ln, file=sys.stderr)


if __name__ == "__main__":
    main()

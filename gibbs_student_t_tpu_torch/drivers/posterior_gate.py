"""The posterior gate: the port's sampler against the float64 NumPy oracle,
in law.

    python -m gibbs_student_t_tpu_torch.drivers.posterior_gate \\
        [--device cuda] [--models beta ...] [--out posterior_gate.json]

The counterpart of the JAX package's ``tools/tpu_gate.py`` (``--device
cuda``, the default: the hand-written kernels on the GPU, 1024 chains, the
flagship mixture/beta model) and of ``tools/j1713_gate.py`` (``--device
cpu``: the kernels' plain versions, 32 chains, the five models of
``run_sims.model_configs()``, with the oracle-vs-oracle null control).
Each model runs ``NumpyGibbs`` (backends/numpy_backend.py, one chain, the
reference's fixed jump scales) and ``TorchGibbs`` on a demo pulsar (130
TOAs, 30 red-noise components; ``--pulsar-seed``, default 42: the pulsar
of ``bench.py``), and gates, per quantity:

- every parameter column;
- ``theta`` and the per-draw outlier summaries ``pout_mean`` and
  ``z_frac`` (outlier models: mixture, vvh17);
- ``df`` (configurations with ``vary_df``);
- ``alpha_log10_mean`` (where the inverse-gamma draw fires: ``vary_alpha``
  with the mixture or t model).

A quantity passes when its posterior means are at most 0.33 posterior sd
apart and the two-sample KS p-value is at least 0.001 (the JAX tools'
rule: the mean gap is the calibrated criterion; KS on thinned MCMC draws
is not uniform under the null, so it only catches gross errors). The
kernel's draws are subsampled to 4,000 before the test. vvh17 starts from
``z_init="zeros"`` on both sides (the dominant all-inlier mode; see
``GibbsConfig.z_init``). ``--null-control`` runs a second oracle seed and
adds its KS p against the first to every row, the scale against which
``ks_p`` reads. Every chain is gated; the number that the telemetry's
sticky ``diverged`` flag marks is printed beside each model.

The kernel's lengths default to 1,000 sweeps, burn 500, thin 20 on both
devices (the oracle's are the JAX tools': 10,000 or 12,000 sweeps, burn
1,000, thin 20). From the reference's start (z = 1, alpha = 1, df = 4)
mixture/beta's df and alpha reach their posterior on the default pulsar
only after ~500 sweeps, in the JAX package's kernel as in this one, so the
JAX tools' kernel burn (150 or 200) fails them there. The uniform model's
posterior on that pulsar has two modes (df 1 with theta ~0.2, df 2 with
theta ~0.4) that the oracle stays in for ~800-2,000 sweeps at a time: no
oracle run of this length weighs them (its own seeds disagree), so gate
uniform on another pulsar (``--pulsar-seed 100``).

The oracles run in a pool of processes (``spawn``; one BLAS thread each)
while the kernel runs, so a model's wall is the longer of the two. The
JSON artifact (``--out``) carries every row, the seconds of each side and
the card as ``torch.cuda.get_device_name`` and ``nvidia-smi`` report it.
It exits 1 when any quantity fails, 0 otherwise.

:func:`gate_rows` is the statistic, importable: ``chip_smoke.py`` and the
tests call it on their own runs.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import json
import multiprocessing
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from gibbs_student_t_tpu_torch.backends.base import (
    META_STATS,
    TELE_PREFIX,
    ChainResult,
)

#: the pass rule: the posterior means at most this many posterior sd apart
GAP_MAX = 0.33
#: ... and a two-sample KS p-value at least this
KS_MIN = 1e-3
#: the kernel's draws are subsampled to this many before the KS test, so
#: the two samples are of comparable size
KS_SUBSAMPLE = 4000
#: the BLAS and OpenMP thread variables an oracle process starts with
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

#: the defaults of each device: tools/tpu_gate.py's on the GPU,
#: tools/j1713_gate.py's on the CPU, with the kernel's burn at 500 (the
#: module docstring)
DEFAULTS = {
    "cuda": dict(models=["beta"], niter_np=10000, burn_np=1000, thin_np=20,
                 nchains=1024, niter_j=1000, burn_j=500, thin_j=20,
                 null_control=False),
    "cpu": dict(models=["vvh17", "uniform", "beta", "gaussian", "t"],
                niter_np=12000, burn_np=1000, thin_np=20, nchains=32,
                niter_j=1000, burn_j=500, thin_j=20, null_control=True),
}


def gate_config(cfg):
    """The configuration both sides of the gate run: vvh17 from
    ``z_init="zeros"``, every other model as given."""
    if cfg.model == "vvh17":
        return dataclasses.replace(cfg, z_init="zeros")
    return cfg


def keep_rows(res: ChainResult, burn: int, thin: int) -> ChainResult:
    """The draws a gate reads: sweeps ``burn, burn + thin, ...`` of
    ``res``, as float64. A run recorded every ``record_thin``-th sweep
    (``res.stats["record_thin"]``) holds those sweeps at rows ``burn /
    record_thin, ...``; both must be multiples of it. Run-level stats
    (telemetry, ``n_toa``) ride along; per-sweep stats are dropped."""
    t = int(res.stats.get("record_thin", 1))
    if burn % t or thin % t:
        raise ValueError(f"burn ({burn}) and thin ({thin}) must be "
                         f"multiples of the run's record_thin ({t})")
    rows = slice(burn // t, None, thin // t)
    fields = {f.name: np.asarray(getattr(res, f.name)[rows], np.float64)
              for f in dataclasses.fields(res) if f.name != "stats"}
    stats = {k: v for k, v in res.stats.items()
             if k in META_STATS or k.startswith(TELE_PREFIX)}
    return ChainResult(**fields, stats=stats)


def gated_quantities(res: ChainResult, cfg,
                     names: Sequence[str]) -> Dict[str, np.ndarray]:
    """Each gated quantity's draws (any leading row and chain axes), in the
    JAX tools' order: the parameter columns, then theta, pout_mean and
    z_frac (outlier models), df (``vary_df``), alpha_log10_mean (mixture
    and t with ``vary_alpha``)."""
    out = {name: res.chain[..., i] for i, name in enumerate(names)}
    if cfg.is_outlier_model:
        out["theta"] = res.thetachain
        out["pout_mean"] = res.poutchain.mean(axis=-1)
        out["z_frac"] = res.zchain.mean(axis=-1)
    if cfg.vary_df:
        out["df"] = res.dfchain
    if cfg.vary_alpha and cfg.model in ("mixture", "t"):
        out["alpha_log10_mean"] = np.log10(
            np.maximum(res.alphachain, 1e-300)).mean(axis=-1)
    return out


def gate_rows(oracle_res: ChainResult, kernel_res: ChainResult, cfg,
              names: Sequence[str], null_res: Optional[ChainResult] = None,
              sub: Optional[np.random.Generator] = None) -> List[dict]:
    """One row per gated quantity of ``cfg`` (:func:`gated_quantities`):
    the oracle's and the kernel's mean and sd, the gap between the means
    in posterior sd (the larger of the two sds), the two-sample KS p, and
    ``ok`` (gap <= ``GAP_MAX`` and p >= ``KS_MIN``); with ``null_res`` (a
    second oracle run) also ``ks_p_null``, the oracle-vs-oracle p.

    The results hold the kept draws only (:func:`keep_rows`). The kernel's
    draws of a quantity, every chain pooled, are subsampled to
    ``KS_SUBSAMPLE`` without replacement by ``sub`` (default
    ``np.random.default_rng(0)``; pass one generator through several
    calls to draw as the JAX tools do across models)."""
    from scipy import stats

    sub = np.random.default_rng(0) if sub is None else sub
    oracle = gated_quantities(oracle_res, cfg, names)
    kernel = gated_quantities(kernel_res, cfg, names)
    null = (gated_quantities(null_res, cfg, names)
            if null_res is not None else None)
    rows = []
    for name, a in oracle.items():
        a = np.asarray(a, np.float64).ravel()
        b = np.asarray(kernel[name], np.float64).ravel()
        if b.size > KS_SUBSAMPLE:
            b = sub.choice(b, KS_SUBSAMPLE, replace=False)
        sd = max(a.std(), b.std(), 1e-12)
        gap = float(abs(a.mean() - b.mean()) / sd)
        p = float(stats.ks_2samp(a, b).pvalue)
        row = {"quantity": name, "oracle_mean": float(a.mean()),
               "oracle_sd": float(a.std()), "kernel_mean": float(b.mean()),
               "kernel_sd": float(b.std()), "gap_sd": gap, "ks_p": p}
        if null is not None:
            a2 = np.asarray(null[name], np.float64).ravel()
            row["ks_p_null"] = float(stats.ks_2samp(a, a2).pvalue)
        row["ok"] = bool(gap <= GAP_MAX and p >= KS_MIN)
        rows.append(row)
    return rows


def diverged_chains(res: ChainResult) -> Optional[int]:
    """Chains the telemetry's sticky ``diverged`` flag marks (None when the
    run carried no telemetry)."""
    flag = res.stats.get("tele_diverged")
    return None if flag is None else int(np.count_nonzero(flag))


def format_row(label: str, row: dict) -> str:
    """One printed line of a gate row."""
    null = (f" null_p={row['ks_p_null']:.4f}" if "ks_p_null" in row else "")
    return (f"{label} {row['quantity']}: oracle {row['oracle_mean']:.5g} "
            f"kernel {row['kernel_mean']:.5g} gap {row['gap_sd']:.3f} sd "
            f"ks_p={row['ks_p']:.4f}{null} ok={row['ok']}")


# ---------------------------------------------------------------------------
# the oracle side, in a pool of processes
# ---------------------------------------------------------------------------

def oracle_run(ma, cfg, niter: int, burn: int, thin: int, seed: int):
    """``(kept draws, seconds)`` of one oracle chain: ``NumpyGibbs`` from a
    prior draw of ``seed`` (``tools/tpu_gate.py``'s start), ``niter``
    sweeps, kept from ``burn`` every ``thin``. A pool task: only the kept
    rows travel back."""
    from gibbs_student_t_tpu_torch.backends.numpy_backend import NumpyGibbs

    t0 = time.perf_counter()
    res = NumpyGibbs(ma, cfg).sample(ma.x_init(np.random.default_rng(seed)),
                                     niter, seed=seed)
    return keep_rows(res, burn, thin), time.perf_counter() - t0


@contextlib.contextmanager
def _one_thread_each():
    """Children started inside take one BLAS/OpenMP thread each (they read
    the variables at start-up); the parent's own are restored after."""
    saved = {k: os.environ.get(k) for k in _THREAD_VARS}
    os.environ.update({k: "1" for k in _THREAD_VARS})
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start_oracles(tasks: Dict[str, tuple], workers: int):
    """Submit ``{label: oracle_run arguments}`` to a new pool of
    ``workers`` spawned processes: ``(executor, {label: future})``. Every
    worker starts during the submissions, so the caller's own work
    overlaps them from the return on; shut the executor down when done."""
    ex = concurrent.futures.ProcessPoolExecutor(
        max_workers=max(1, workers),
        mp_context=multiprocessing.get_context("spawn"))
    with _one_thread_each():
        futures = {label: ex.submit(oracle_run, *args)
                   for label, args in tasks.items()}
    return ex, futures


def stop_oracles(ex) -> None:
    """End the pool now: cancel the runs not started and terminate the
    workers (a run cut short is lost), then wait for them to exit."""
    procs = list((getattr(ex, "_processes", None) or {}).values())
    ex.shutdown(wait=False, cancel_futures=True)
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
    for proc in procs:
        proc.join(timeout=30)


def default_workers(ntasks: int) -> int:
    """Processes for ``ntasks`` oracle runs beside the process that drives
    the device: one core is left to it."""
    return max(1, min(ntasks, (os.cpu_count() or 2) - 1))


def card_line() -> Optional[str]:
    """``name, power.limit`` of the first card as ``nvidia-smi`` reports
    it, or None where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where TorchGibbs runs: the GPU (default; exits "
                         "if CUDA is absent) or the CPU (the kernels' "
                         "plain versions); also picks the defaults below")
    ap.add_argument("--out", default="posterior_gate.json",
                    help="the JSON artifact ('' writes none)")
    ap.add_argument("--models", nargs="+", default=None,
                    help="run_sims.model_configs() keys to gate (default: "
                         "beta on cuda, all five on cpu)")
    ap.add_argument("--niter-np", type=int, default=None)
    ap.add_argument("--burn-np", type=int, default=None)
    ap.add_argument("--thin-np", type=int, default=None)
    ap.add_argument("--nchains", type=int, default=None)
    ap.add_argument("--niter-j", type=int, default=None)
    ap.add_argument("--burn-j", type=int, default=None)
    ap.add_argument("--thin-j", type=int, default=None)
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--pulsar-seed", type=int, default=42,
                    help="the demo pulsar's seed (130 TOAs, 30 "
                         "components); 42 is bench.py's")
    ap.add_argument("--adapt-cov", type=int, default=0, metavar="N",
                    help="run TorchGibbs with population-covariance "
                         "proposals adapting for the first N sweeps (set "
                         "--burn-j >= N)")
    ap.add_argument("--mtm", type=int, default=0, metavar="K",
                    help="run TorchGibbs with multiple-try Metropolis, K "
                         "candidates a step")
    ap.add_argument("--mtm-blocks", nargs="+", default=["white", "hyper"],
                    choices=("white", "hyper"))
    ap.add_argument("--null-control", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="a second oracle seed (seed + 1000) and its KS p "
                         "against the first in every row (default: on for "
                         "cpu, off for cuda)")
    args = ap.parse_args(argv)
    for key, value in DEFAULTS[args.device].items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    from gibbs_student_t_tpu_torch.drivers.run_sims import model_configs
    from gibbs_student_t_tpu_torch.drivers.simulate_data import check_device

    unknown = sorted(set(args.models) - set(model_configs()))
    if unknown:
        ap.error(f"unknown models {unknown}; have {sorted(model_configs())}")
    if args.adapt_cov and args.burn_j < args.adapt_cov:
        ap.error("--burn-j must discard the adapting sweeps")
    if set(args.mtm_blocks) != {"white", "hyper"} and not args.mtm:
        ap.error("--mtm-blocks requires --mtm K")
    if args.burn_np >= args.niter_np or args.burn_j >= args.niter_j:
        ap.error("each side's burn must leave draws to gate")
    check_device(ap, args.device)
    return args


def kernel_run(ma, cfg, args):
    """``(result, seconds)``: ``TorchGibbs`` on ``args.device`` and ``cfg``
    (with the run's adaptation and MTM), recorded every ``t``-th sweep,
    ``t`` the largest that keeps the gate's sweeps (``gcd`` of burn, thin,
    sweeps and the 100-sweep chunk), at ``record="compact"`` (pout in
    float16, as the JAX tools record it). The result is on the host, so
    the wall covers the device's work."""
    import math

    from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs

    if args.adapt_cov:
        cfg = cfg.with_adapt(args.adapt_cov, adapt_cov=True)
    if args.mtm:
        cfg = cfg.with_mtm(args.mtm, blocks=tuple(args.mtm_blocks))
    thin = math.gcd(args.burn_j, args.thin_j, args.niter_j, 100)
    gb = TorchGibbs(ma, cfg, nchains=args.nchains, device=args.device,
                    chunk_size=100, record="compact", record_thin=thin)
    t0 = time.perf_counter()
    res = gb.sample(niter=args.niter_j, seed=args.seed + 1)
    return res, time.perf_counter() - t0


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
    from gibbs_student_t_tpu_torch.drivers.run_sims import model_configs

    ma = make_demo_model_arrays(n=130, components=30, seed=args.pulsar_seed)
    configs = {k: gate_config(model_configs()[k]) for k in args.models}
    seeds = [args.seed] + ([args.seed + 1000] if args.null_control else [])
    tasks = {(key, s): (ma, cfg, args.niter_np, args.burn_np, args.thin_np,
                        s)
             for key, cfg in configs.items() for s in seeds}
    out = {"config": vars(args), "models": {},
           "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime()),
           "device": {"type": args.device,
                      "name": (torch.cuda.get_device_name(0)
                               if args.device == "cuda" else "cpu"),
                      "nvidia_smi": (card_line() if args.device == "cuda"
                                     else None)}}
    print(f"# posterior gate on {out['device']['name']} "
          f"({out['device']['nvidia_smi']}): models {args.models}, oracle "
          f"{args.niter_np}/{args.burn_np}/{args.thin_np}, kernel "
          f"{args.nchains} chains {args.niter_j}/{args.burn_j}/"
          f"{args.thin_j}", flush=True)
    ex, futures = start_oracles(tasks, default_workers(len(tasks)))
    sub = np.random.default_rng(0)
    try:
        kernels = {}
        for key, cfg in configs.items():
            res, dt = kernel_run(ma, cfg, args)
            kernels[key] = (keep_rows(res, args.burn_j, args.thin_j), dt)
            print(f"[{key}][kernel] {args.niter_j} sweeps x {args.nchains} "
                  f"chains in {dt:.1f} s", flush=True)
        for key, cfg in configs.items():
            oracle, o_s = futures[(key, args.seed)].result()
            null = (futures[(key, args.seed + 1000)].result()[0]
                    if args.null_control else None)
            kept, k_s = kernels[key]
            rows = gate_rows(oracle, kept, cfg, ma.param_names,
                             null_res=null, sub=sub)
            ok = all(r["ok"] for r in rows)
            out["models"][key] = {
                "gibbs_config": dataclasses.asdict(cfg), "rows": rows,
                "ok": ok, "oracle_seconds": o_s, "kernel_seconds": k_s,
                "diverged_chains": diverged_chains(kept)}
            for r in rows:
                print(format_row(f"[{key}]", r), flush=True)
            print(f"[{key}] ok={ok} oracle {o_s:.1f} s kernel {k_s:.1f} s "
                  f"diverged chains {diverged_chains(kept)}", flush=True)
    finally:
        stop_oracles(ex)
    out["ok"] = all(m["ok"] for m in out["models"].values())
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(f"[gate] ok={out['ok']} models="
          + ",".join(f"{k}:{v['ok']}" for k, v in out["models"].items()),
          flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no final ``ok`` line):

1. device and card: CUDA must be present; prints the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build ``libgst_cuda.so`` from ``gibbs_student_t_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the build seconds;
3. kernel-vs-plain parity on the card: the four kernels' inputs are
   captured from a sweep of the flagship run itself (demo pulsar,
   ``mixture``, 1024 chains), and each kernel is held against its plain
   PyTorch version on those inputs (the MH blocks' accept decisions also
   against a float64 run of the plain version);
4. one deterministic sweep on the card against the same sweep on the CPU
   (plain versions), with identical state and draws: every chain's accept
   counts equal;
5. the flagship run through ``TorchGibbs.sample``: 1024 chains, adapt 100
   sweeps with population-covariance proposals, then 200 more; every
   kernel's launch count must equal its launches per sweep x sweeps
   (chol_fused 2, tri_solve_T 2, white_mh 1, hyper_mh 1), every chain
   must stay finite;
6. timings of each kernel, its plain version and, where one PyTorch call
   computes the same function, that call (a yardstick only);
7. torch.profiler over 20 flagship sweeps: device time per sweep, launches
   per sweep and the device's idle share against phase 5's wall.

The last stdout lines are the ``kernels`` JSON line, the card line, and
``{"ok": true, "device": {...}}``. Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# launches of each kernel per sweep on the flagship path, and the TPU
# kernel each one replaces
KERNELS = {
    "chol_fused": dict(
        per_sweep=2, source="gibbs_student_t_tpu_torch/csrc/chol.cu",
        replaces="gibbs_student_t_tpu/ops/pallas_chol.py:81 _chol_kernel"),
    "tri_solve_T": dict(
        per_sweep=2, source="gibbs_student_t_tpu_torch/csrc/chol.cu",
        replaces="gibbs_student_t_tpu/ops/pallas_chol.py:117 _backsolve_kernel"),
    "white_mh": dict(
        per_sweep=1, source="gibbs_student_t_tpu_torch/csrc/white_mh.cu",
        replaces="gibbs_student_t_tpu/ops/pallas_white.py:322 _white_kernel"),
    "hyper_mh": dict(
        per_sweep=1, source="gibbs_student_t_tpu_torch/csrc/hyper_mh.cu",
        replaces="gibbs_student_t_tpu/ops/pallas_hyper.py:290 _hyper_kernel"),
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
FP32_FLOPS = 67e12             # H100 SXM float32 rate outside tensor cores
NCHAINS = 1024
ADAPT, MORE = 100, 200
# the stream hold before a timed loop: 5e7 cycles, at least 25 ms below the
# H100's 1.98 GHz top SM clock
SLEEP_CYCLES, SLEEP_MS = 50_000_000, 25.0


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def pooled_ess(chains, c: float = 5.0) -> float:
    """Effective sample size of ``(niter, nchains)`` draws: each chain's
    draws discounted by its integrated autocorrelation time (FFT
    autocorrelation, Sokal window ``c``), summed over chains."""
    import numpy as np

    x = np.asarray(chains, np.float64)
    n = x.shape[0]
    x = x - x.mean(0)
    f = np.fft.rfft(x, n=2 * n, axis=0)
    acf = np.fft.irfft(f * np.conj(f), axis=0)[:n]
    a0 = acf[0]
    dead = a0 <= 0
    acf = acf / np.where(dead, 1.0, a0)
    tau = 2.0 * np.cumsum(acf, axis=0) - 1.0
    window = np.arange(n)[:, None] >= c * tau
    idx = np.where(window.any(0), np.argmax(window, 0), n - 1)
    taus = np.maximum(tau[idx, np.arange(x.shape[1])], 1.0)
    taus = np.where(dead, 1.0, taus)
    return float((n / taus).sum())


def profile_sweeps(torch, sampler, nsweeps: int) -> dict:
    """Device time by kernel over ``nsweeps`` steady-state sweeps of the
    flagship sampler (torch.profiler, CUDA activity), the wall time of the
    same window, and the device's idle share within it."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=sampler.device).manual_seed(3)
    st = sampler.init_state(seed=3)
    for i in range(3):
        st = sampler._sweep(st, sampler._draw(gen, st), sweep=500 + i)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(nsweeps):
            st = sampler._sweep(st, sampler._draw(gen, st), sweep=500 + i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    rows = []
    dev_total = 0.0
    launches = 0
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy/memset): the CPU ops
        # that launched them carry the same device time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt <= 0:
            continue
        dev_total += dt
        launches += ev.count
        rows.append({"name": ev.key, "ms_per_sweep": dt / 1e3 / nsweeps,
                     "calls_per_sweep": ev.count / nsweeps})
    rows.sort(key=lambda r: -r["ms_per_sweep"])
    dev_ms = dev_total / 1e3 / nsweeps
    return {"sweeps": nsweeps, "wall_ms_per_sweep": wall * 1e3 / nsweeps,
            "device_ms_per_sweep": dev_ms,
            "launches_per_sweep": launches / nsweeps, "top": rows[:12]}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    if not torch.cuda.is_available():
        fail("CUDA is not available; this script runs only on a GPU")
    sys.path.insert(0, HERE)
    try:
        from gibbs_student_t_tpu_torch.backends import torch_backend as tb
        from gibbs_student_t_tpu_torch.config import GibbsConfig
        from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
        from gibbs_student_t_tpu_torch.ops import _cuda, chol, hyper_mh, linalg
        from gibbs_student_t_tpu_torch.ops import white_mh
    except ImportError as exc:
        fail(f"the port's package is not importable here: {exc}")

    import numpy as np

    dev = torch.device("cuda")
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        fail(f"nvidia-smi did not report the card: {exc!r}")
    report = {"card": card, "kind": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    print(f"# card: {report['card']} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # --- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    try:
        _cuda.build(force=True)
        _cuda.lib()
    except Exception as exc:  # noqa: BLE001
        fail(f"kernel build failed: {exc}")
    report["build_s"] = time.perf_counter() - t0
    print(f"# build: libgst_cuda.so in {report['build_s']:.2f} s", flush=True)
    for line in _cuda.ptxas_report.splitlines():
        if "Used" in line or "spill" in line:
            print(f"# ptxas: {line.strip()}")

    wrappers = {"chol_fused": (linalg, "chol_fused", chol.chol_fused),
                "tri_solve_T": (linalg, "tri_solve_T", chol.tri_solve_T),
                "white_mh": (tb, "white_mh", white_mh.white_mh),
                "hyper_mh": (tb, "hyper_mh", hyper_mh.hyper_mh)}
    plains = {"chol_fused": chol.chol_fused_plain,
              "tri_solve_T": chol.tri_solve_T_plain,
              "white_mh": white_mh.white_mh_loop,
              "hyper_mh": hyper_mh.hyper_mh_loop}

    def reset_counts():
        for _, _, fn in wrappers.values():
            fn.launches = 0

    # --- the flagship model ----------------------------------------------
    ma = make_demo_model_arrays()
    cfg = GibbsConfig(model="mixture", vary_df=True,
                      theta_prior="beta").with_adapt(ADAPT, adapt_cov=True)
    sampler = tb.TorchGibbs(ma, cfg, nchains=NCHAINS, device=dev)
    print(f"# flagship: n={ma.n} m={ma.m} p={ma.nparam} chains={NCHAINS} "
          f"schur={len(sampler._schur[0])}+{len(sampler._schur[1])}",
          flush=True)

    # --- 3. capture the kernels' inputs from the main path, then parity ---
    captured = {}

    def recorder(name, fn):
        def rec(*args):
            # the last sweep's operands of each call shape are kept
            captured[(name, tuple(args[0].shape))] = tuple(
                a.clone() if torch.is_tensor(a) else a for a in args)
            return fn(*args)
        return rec

    for name, (mod, attr, fn) in wrappers.items():
        setattr(mod, attr, recorder(name, fn))
    try:
        gen = torch.Generator(device=dev).manual_seed(7)
        st = sampler.init_state(seed=7)
        st = sampler._prop_cov_update(st)
        for i in range(5):
            st = sampler._sweep(st, sampler._draw(gen, st), sweep=i)
        torch.cuda.synchronize()
    finally:
        for name, (mod, attr, fn) in wrappers.items():
            setattr(mod, attr, fn)
    shapes = sorted(k for k in captured)
    print(f"# captured kernel inputs: {shapes}", flush=True)
    for name in KERNELS:
        if not any(k[0] == name for k in captured):
            fail(f"{name} was not reached by the sweep")

    def rel_err(a, b):
        fa, fb = torch.isfinite(a), torch.isfinite(b)
        both = fa & fb
        mism = int((fa != fb).sum())
        if not both.any():
            return 0.0, 0.0, mism
        d = (a - b).abs()[both]
        return (float(d.max()), float((d / (1.0 + b.abs()[both])).max()),
                mism)

    parity = {}
    for (name, shape), args in sorted(captured.items()):
        fn = wrappers[name][2]
        out_k = fn(*args)
        out_p = plains[name](*args)
        torch.cuda.synchronize()
        out_k = out_k if isinstance(out_k, tuple) else (out_k,)
        out_p = out_p if isinstance(out_p, tuple) else (out_p,)
        errs = [rel_err(a, b) for a, b in zip(out_k, out_p)]
        rec = {"shape": list(shape),
               "max_abs_err": max(e[0] for e in errs),
               "max_rel_err": max(e[1] for e in errs),
               "nonfinite_mismatch": sum(e[2] for e in errs)}
        if name in ("white_mh", "hyper_mh"):
            acc_k, acc_p = out_k[1], out_p[1]
            steps = args[3].shape[1] if name == "white_mh" else args[5].shape[1]
            # the float64 plain version is the referee for decisions the
            # float32 likelihood cannot resolve (near-ties, ill-conditioned
            # proposals)
            args64 = tuple(a.double() if torch.is_tensor(a) else a
                           for a in args)
            x_64, acc_64 = plains[name](*args64)
            # per-chain accept counts (rates x steps, rounded: a rate is
            # count / steps, and torch may divide by multiplying with 1/steps)
            n_k, n_p, n_64 = (torch.round(a.double() * steps).long()
                              for a in (acc_k, acc_p, acc_64))
            rec["accepts_kernel"] = int(n_k.sum())
            rec["accepts_plain"] = int(n_p.sum())
            rec["accepts_f64"] = int(n_64.sum())
            rec["chains_acc_mismatch"] = int((n_k != n_p).sum())
            rec["chains_kernel_vs_f64"] = int((n_k != n_64).sum())
            rec["chains_plain_vs_f64"] = int((n_p != n_64).sum())
            agree = n_k == n_64
            rec["x_max_rel_err_vs_f64"] = rel_err(
                out_k[0][agree], x_64[agree].float())[1]
            # tolerance: the kernel's float32 decisions depart from the
            # float64 referee on no more chains than the plain float32
            # version's do (0 of 1024 at the flagship inputs in every
            # reading so far), and x of every chain whose count agrees with
            # the referee's matches the referee's x to 1e-4 relative
            ok = (rec["chains_kernel_vs_f64"] <= rec["chains_plain_vs_f64"]
                  and rec["x_max_rel_err_vs_f64"] <= 1e-4)
        else:
            # tolerance: 1e-3 relative (|a-b| / (1+|b|)) on every output;
            # non-finite pattern (failed pivots) identical
            ok = rec["max_rel_err"] <= 1e-3 and rec["nonfinite_mismatch"] == 0
        rec["ok"] = bool(ok)
        parity.setdefault(name, []).append(rec)
        print(f"# parity {name} {list(shape)}: {json.dumps(rec)}", flush=True)
        if not ok:
            fail(f"{name} disagrees with its plain version at {shape}")
    report["parity"] = parity

    # --- 4. one sweep on the card vs the same sweep on the CPU -----------
    small = tb.TorchGibbs(ma, cfg, nchains=64, device=dev)
    small_cpu = tb.TorchGibbs(ma, cfg, nchains=64, device="cpu")
    gen = torch.Generator(device=dev).manual_seed(11)
    st = small._prop_cov_update(small.init_state(seed=11))
    for i in range(3):
        st = small._sweep(st, small._draw(gen, st), sweep=i)
    dr = small._draw(gen, st)
    out_g = small._sweep(st, dr, sweep=3)
    to_cpu = lambda t: t.detach().cpu()  # noqa: E731
    out_c = small_cpu._sweep(type(st)(*map(to_cpu, st)),
                             type(dr)(*map(to_cpu, dr)), sweep=3)
    nw, nh = cfg.mh.n_white_steps, cfg.mh.n_hyper_steps
    agree = ((torch.round(to_cpu(out_g.acc_white) * nw)
              == torch.round(out_c.acc_white * nw))
             & (torch.round(to_cpu(out_g.acc_hyper) * nh)
                == torch.round(out_c.acc_hyper * nh)))
    sweep_cmp = {f: rel_err(to_cpu(getattr(out_g, f)),
                            getattr(out_c, f))[:2]
                 for f in ("x", "b")}
    sweep_cmp["chains_acc_mismatch"] = int((~agree).sum())
    print(f"# sweep card-vs-cpu (64 chains): {json.dumps(sweep_cmp)}",
          flush=True)
    report["sweep_card_vs_cpu"] = sweep_cmp
    # tolerance: every chain's accept counts equal (0 of 64 differed in
    # every reading so far); x of every chain to 1e-4 relative, b (drawn
    # through the chol kernels vs their plain versions on the CPU) to 1e-3
    if (sweep_cmp["chains_acc_mismatch"] > 0 or sweep_cmp["x"][1] > 1e-4
            or sweep_cmp["b"][1] > 1e-3):
        fail("one sweep on the card disagrees with the same sweep on the CPU")

    # --- 5. the flagship run ----------------------------------------------
    # adaptation (100 sweeps) then 200 timed sweeps, as bench.py times the
    # JAX sampler: the metrics come from the steady post-adaptation window
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sampler.sample(niter=ADAPT, seed=1)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = sampler.sample(niter=MORE, seed=1, state=sampler.last_state,
                         start_sweep=ADAPT)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    niter = ADAPT + MORE
    launches = {n: w[2].launches for n, w in wrappers.items()}
    st = sampler.last_state
    finite = torch.ones(NCHAINS, dtype=torch.bool, device=dev)
    for f in ("x", "b", "alpha", "theta", "df"):
        v = getattr(st, f)
        finite &= torch.isfinite(v.reshape(NCHAINS, -1)).all(-1)
    share_finite = float(finite.float().mean())
    ia = [i for i, nm in enumerate(ma.param_names) if "log10_A" in nm][0]
    ess_a = pooled_ess(res.chain[..., ia])
    run = {"sweeps": niter, "adapt_wall_s": t1 - t0, "timed_sweeps": MORE,
           "timed_wall_s": t2 - t1,
           "chain_sweeps_per_s": NCHAINS * MORE / (t2 - t1),
           "ess_log10A": ess_a, "ess_log10A_per_s": ess_a / (t2 - t1),
           "acc_white": float(res.stats["acc_white"].mean()),
           "acc_hyper": float(res.stats["acc_hyper"].mean()),
           "theta_mean": float(res.thetachain.mean()),
           "param_means": dict(zip(ma.param_names,
                                   map(float, res.chain.mean((0, 1))))),
           "share_finite": share_finite,
           "peak_device_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "records_finite": bool(np.isfinite(res.chain).all()
                                  and np.isfinite(res.bchain).all()),
           "launches": launches}
    print(f"# flagship run: {json.dumps(run)}", flush=True)
    report["run"] = run
    for name, meta in KERNELS.items():
        want = meta["per_sweep"] * niter
        if launches[name] != want:
            fail(f"{name} launched {launches[name]} times in the run, "
                 f"expected {want}")
    if share_finite != 1.0 or not run["records_finite"]:
        fail(f"non-finite chains after the run (finite share {share_finite})")
    if res.chain.shape != (MORE, NCHAINS, ma.nparam):
        fail(f"unexpected chain shape {res.chain.shape}")
    if not 0.0 < run["theta_mean"] < 0.5:
        fail(f"theta mean {run['theta_mean']} outside (0, 0.5)")

    # --- 6. timings at the flagship shapes --------------------------------
    def timed(fn, args, reps, queue_ahead=True):
        """Milliseconds per call of ``fn(*args)``: CUDA events around
        ``reps`` back-to-back calls. With ``queue_ahead`` a sleep kernel
        holds the stream while the host enqueues the calls, so the events
        bracket device work only and not the host's launch overhead (a
        30 us kernel is otherwise timed at the host's launch rate). The
        plain versions, launch-bound by nature, are timed without it."""
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        if queue_ahead:
            torch.cuda._sleep(SLEEP_CYCLES)
        e0.record()
        h0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        e1.record()
        enqueue_ms = (time.perf_counter() - h0) * 1e3
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        if queue_ahead and enqueue_ms > SLEEP_MS:
            # the hold ended before the host had enqueued every call (a
            # call that synchronises): the time then includes launch gaps
            print(f"# timing note: {getattr(fn, '__name__', fn)} took "
                  f"{enqueue_ms:.1f} ms to enqueue {reps} calls, past the "
                  f"{SLEEP_MS} ms hold", flush=True)
        return ms / reps

    def work(name, args):
        """(bytes moved, float32 operations) of one call: each input read
        once, each output written once; operations counted from shapes.
        A symmetric or triangular input counts its lower triangle only
        (m(m+1)/2 floats): that is all the function reads of S, L and S0.
        chol_fused's L is counted in full, zeros above the diagonal
        included: the output is the dense factor, which its callers read
        as a dense matrix (the robust draw's finiteness test, the products
        of the b draw)."""
        f4 = 4
        if name == "chol_fused":
            S = args[0]
            m = S.shape[-1]
            B = S.numel() // (m * m)
            tri = m * (m + 1) // 2
            return (f4 * (B * tri + B * m * m + 2 * B * m + B),
                    B * (m ** 3 / 3 + m * m))
        if name == "tri_solve_T":
            L = args[0]
            m = L.shape[-1]
            B = L.numel() // (m * m)
            tri = m * (m + 1) // 2
            return f4 * (B * tri + 2 * B * m), B * m * m
        if name == "white_mh":
            x, az, y2, dx, lu, rows, specs, var = args
            C, p = x.shape
            n, S = az.shape[1], dx.shape[1]
            byts = f4 * (sum(t.numel() for t in (x, az, y2, dx, lu, rows,
                                                  specs)) + C * p + C)
            return byts, C * (S + 1) * n * (10 + 2 * len(var))
        if name == "hyper_mh":
            x, S0 = args[0], args[1]
            C, v = S0.shape[0], S0.shape[-1]
            S = args[5].shape[1]
            byts = f4 * (sum(t.numel() for t in args[:10]) - C * v * v
                         + C * v * (v + 1) // 2 + C * x.shape[1] + C)
            return byts, C * (S + 1) * (v ** 3 / 3 + 4 * v * v)
        raise KeyError(name)

    def library(name, args):
        if name == "chol_fused":
            return lambda S, r: torch.linalg.cholesky_ex(S)
        if name == "tri_solve_T":
            return lambda L, r: torch.linalg.solve_triangular(
                L.transpose(-1, -2), r[..., None], upper=True)
        return None

    timing = {}
    kernels_line = []
    for name, meta in KERNELS.items():
        rows = []
        for (nm, shape), args in sorted(captured.items()):
            if nm != name:
                continue
            byts, flops = work(name, args)
            bound = max(byts / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
            lib_fn = library(name, args)
            rows.append(dict(
                shape=list(shape),
                ms=timed(wrappers[name][2], args, 50),
                plain_ms=timed(plains[name], args, 3, queue_ahead=False),
                library_ms=(timed(lib_fn, args[:2], 50) if lib_fn
                            else None),
                bound_ms=bound,
                bound_by="bytes" if byts / HBM_BYTES_PER_S
                >= flops / FP32_FLOPS else "operations",
                bytes=byts, flops=flops))
            print(f"# time {name} {list(shape)}: {json.dumps(rows[-1])}",
                  flush=True)
        timing[name] = rows
        # one entry per kernel: the mean over the shapes of one sweep's
        # launches (each shape is launched once per sweep)
        k = len(rows)
        errs = [r["max_abs_err"] for r in parity[name]]
        lib_ms = ([r["library_ms"] for r in rows]
                  if rows[0]["library_ms"] is not None else None)
        bound_by = max(rows, key=lambda r: r["bound_ms"])["bound_by"]
        kernels_line.append({
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"], "launches": launches[name],
            "max_abs_err": max(errs),
            "ms": sum(r["ms"] for r in rows) / k,
            "plain_ms": sum(r["plain_ms"] for r in rows) / k,
            "bound_ms": sum(r["bound_ms"] for r in rows) / k,
            "bound_by": bound_by,
            "library_ms": None if lib_ms is None else sum(lib_ms) / k,
            "shapes": [r["shape"] for r in rows]})
    report["timing"] = timing
    report["kernels"] = kernels_line

    # --- 7. where a flagship sweep's time goes (profiler) -----------------
    try:
        prof = report["profile"] = profile_sweeps(torch, sampler, 20)
    except Exception as exc:  # noqa: BLE001
        fail(f"the profiler did not trace the flagship sweeps: {exc!r}")
    if prof["device_ms_per_sweep"] <= 0 or prof["launches_per_sweep"] <= 0:
        fail("the profiler saw no device time in the flagship sweeps")
    # idle share against the unprofiled wall of phase 5 (the profiler's
    # own host overhead stretches the profiled wall)
    wall_ms = 1e3 * run["timed_wall_s"] / MORE
    prof["idle_share"] = max(0.0, 1.0 - prof["device_ms_per_sweep"]
                             / wall_ms)
    print(f"# profile ({prof['sweeps']} sweeps, {NCHAINS} chains): "
          f"device busy {prof['device_ms_per_sweep']:.4f} ms/sweep, "
          f"{prof['launches_per_sweep']:.1f} launches/sweep; wall "
          f"{wall_ms:.4f} ms/sweep unprofiled "
          f"({prof['wall_ms_per_sweep']:.4f} profiled); idle share "
          f"{prof['idle_share']:.4f}")
    for row in prof["top"]:
        print(f"#   {row['ms_per_sweep']:8.4f} ms/sweep "
              f"{row['calls_per_sweep']:6.1f} calls  {row['name'][:90]}")

    try:
        os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
        with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"),
                  "w") as fh:
            json.dump(report, fh, indent=1)
    except OSError as exc:
        print(f"# could not write chiprun_out/chip_smoke.json: {exc}")

    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's factor, back-solve, hyper-block and Gram
kernels of one checkout, to compare two versions of the kernels on the
same card.

    python3 tools/torch_kernel_ab.py [--root DIR] [--label NAME]

``--root`` is the directory holding the ``gibbs_student_t_tpu_torch``
package to time (default: the checkout this script lies in). One process
times one checkout, since two versions of the package cannot be imported
side by side; for an A/B, unpack the other commit (``git archive``) into a
directory and run this script once per root in one shell command on one
card, in turns (A, B, B, A).

The operands are those of sweeps of the port's own samplers, captured at
the kernels' calls: the demo pulsar with 30 Fourier components at 1024
chains (``chol_fused``, ``tri_solve_T`` and ``hyper_mh`` at m = v = 60
and the back-solve also at 14: the warp-per-matrix forms) and with 80
components at 64 chains (m = v = 160, the block-per-matrix forms); the
stress config's ``tnt_batched`` (a demo pulsar of 100,000 TOAs padded to
102,400, 30 components, 64 chains: T is 102,400 x 74); ens32's
``tri_solve_T`` (32 demo pulsars x 256 chains: 8,192 systems at 60 and
14); and the serving pool's ``tnt_lanes`` (1024 lanes of 4 tenants, the
serving bench's models: 64 groups x 16 lanes, 130 TOAs, m = 74).
Times are CUDA-event milliseconds per launch over 50 launches queued
behind a sleep kernel, so the host's launch rate stays out of them. Prints
one JSON line; needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default=None)
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        sys.exit("torch_kernel_ab: needs a CUDA device")
    from gibbs_student_t_tpu_torch.backends import torch_backend as tb
    from gibbs_student_t_tpu_torch.config import GibbsConfig
    from gibbs_student_t_tpu_torch.data.demo import (
        make_contaminated_pulsar,
        make_demo_model_arrays,
        make_reference_pta,
    )
    from gibbs_student_t_tpu_torch.ops import chol, hyper_mh, linalg, tnt
    from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs
    from gibbs_student_t_tpu_torch.serve import ChainServer, TenantRequest
    from gibbs_student_t_tpu_torch.serve import pool as serve_pool

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta")
    kernels = {"chol_fused": (linalg, chol.chol_fused),
               "tri_solve_T": (linalg, chol.tri_solve_T),
               "hyper_mh": (tb, hyper_mh.hyper_mh),
               "tnt_batched": (tb, tnt.tnt_batched),
               "tnt_lanes": (serve_pool, tnt.tnt_lanes)}

    def capture(run, names):
        """The operands of the last call of each kernel in ``names``, by
        the shape of its first operand, in ``run()``."""
        got = {}
        for name in names:
            mod, fn = kernels[name]
            def rec(*args, name=name, fn=fn):
                got[(name, tuple(args[0].shape))] = tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)
                return fn(*args)
            setattr(mod, name, rec)
        try:
            run()
            torch.cuda.synchronize()
        finally:
            for name, (mod, fn) in kernels.items():
                setattr(mod, name, fn)
        if sorted({k[0] for k in got}) != sorted(names):
            sys.exit(f"torch_kernel_ab: the sweeps reached {sorted(got)}")
        return got

    def sweeps(smp, n=3):
        """``n`` sweeps of a sampler from its initial state."""
        def run():
            gen = torch.Generator(device=dev).manual_seed(5)
            st = smp.init_state(seed=5)
            for i in range(n):
                st = smp._sweep(st, smp._draw(gen, st), sweep=i)
        return run

    def solo(components, nchains, n):
        return tb.TorchGibbs(make_demo_model_arrays(n=n,
                                                    components=components),
                             cfg, nchains=nchains, device=dev)

    def ens32():
        mas = [make_demo_model_arrays(n=130 - (i % 3) * 10, components=30,
                                      seed=100 + i) for i in range(32)]
        return EnsembleGibbs(mas, cfg, nchains=256, device=dev,
                             record="light")

    def pool_step():
        """Two quanta of one sweep of a full 1024-lane pool: 4 tenants of
        256 chains on the serving bench's models (the template s = 42,
        tenants 100 + i)."""
        def model(seed):
            psr, _ = make_contaminated_pulsar(n=130, components=30,
                                              theta=0.02, sigma_out=1e-5,
                                              seed=seed)
            return make_reference_pta(psr, 30).frozen(0)
        srv = ChainServer(model(42), GibbsConfig(model="mixture"),
                          nlanes=1024, quantum=1, device=dev)
        for i in range(4):
            srv.submit(TenantRequest(ma=model(100 + i), niter=2,
                                     nchains=256, seed=200 + i))

        def run():
            srv.step()
            srv.step()
        return run

    cases = (
        ("solo 30 x 1024", lambda: sweeps(solo(30, 1024, 130)),
         ("chol_fused", "tri_solve_T", "hyper_mh")),
        ("solo 80 x 64", lambda: sweeps(solo(80, 64, 130)),
         ("chol_fused", "hyper_mh")),
        ("stress", lambda: sweeps(solo(30, 64, 100_000)), ("tnt_batched",)),
        ("ens32", lambda: sweeps(ens32(), 2), ("tri_solve_T",)),
        ("pool1024", pool_step, ("tnt_lanes",)))

    def timed(fn, args, reps=50):
        for _ in range(3):
            fn(*args)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        e0.record()
        for _ in range(reps):
            fn(*args)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    rows = []
    for case, make, names in cases:
        for (name, shape), args in sorted(capture(make(), names).items()):
            rows.append({"kernel": name, "case": case, "shape": list(shape),
                         "ms": timed(kernels[name][1], args)})
        torch.cuda.empty_cache()
    print(json.dumps({"label": opts.label or root, "card": card,
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()

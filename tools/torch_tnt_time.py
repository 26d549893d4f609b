#!/usr/bin/env python3
"""Time the Gram kernel (``tnt_batched``) of one checkout on synthetic
operands, with the device time of each launch inside the call.

    python3 tools/torch_tnt_time.py ROOT LABEL

``ROOT`` holds the ``gibbs_student_t_tpu_torch`` package to time (a copy
of the package with an edited ``csrc/tnt.cu`` is how variants of the
kernel are compared: run this once per root in one shell command on one
card). Operands from a numpy seed at 64 chains and 102,400 TOAs, m = 74
(the stress shape) and m = 174. Per shape it prints the error against a
float64 evaluation over M = |T|^T w |T|, whether TNT is exactly
symmetric, the ms per call (CUDA events over 20 calls queued behind a
sleep kernel), the workspace floats, the device ms of each kernel of the
call (torch.profiler, 5 calls), and the wrapper's constant timed in two
forms (``now``: the elementwise product and sum of the plain version;
``mv``: one matrix-vector product) with their relative error against
float64. Prints one JSON line with the ptxas register lines of the Gram
kernel; needs a CUDA device.
"""

import json
import os
import sys


def main() -> None:
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from gibbs_student_t_tpu_torch.ops import _cuda, tnt

    if not tnt.__file__.startswith(root):
        sys.exit(f"torch_tnt_time: imported {tnt.__file__}, not {root}")
    _cuda.build()
    rep = _cuda.ptxas_report.splitlines()
    regs = [rep[i + 2].strip() for i, line in enumerate(rep)
            if "Function properties for" in line and "tnt_pairs" in line
            and i + 2 < len(rep)]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def timed(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    from torch.profiler import ProfilerActivity, profile

    rows = []
    for C, n, m in [(64, 102400, 74), (64, 102400, 174)]:
        T = torch.from_numpy(rng.normal(size=(n, m)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(dev)
        nv = torch.from_numpy(np.exp(rng.normal(0, 1, (C, n)))
                              .astype(np.float32)).to(dev)
        out = tnt.tnt_batched(T, y, nv, 4096)
        T64, y64, nv64 = T.double(), y.double(), nv.double()
        r64 = tnt.tnt_products(T64, y64, nv64)
        M, Md, _ = tnt.tnt_products(T64.abs(), y64.abs(), nv64)
        err = max(float(((out[0].double() - r64[0]) / M).abs().max()),
                  float(((out[1].double() - r64[1]) / Md).abs().max()))
        ms = timed(lambda: tnt.tnt_batched(T, y, nv, 4096))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                tnt.tnt_batched(T, y, nv, 4096)
            torch.cuda.synchronize()
        by = {}
        for ev in prof.key_averages():
            dt = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if dt > 0:
                by[ev.key[:60]] = by.get(ev.key[:60], 0) + dt / 1e3 / 5
        c64 = -0.5 * (torch.log(nv64).sum(-1) + (y64 * y64 / nv64).sum(-1))
        glue = {
            "now": lambda: -0.5 * (torch.log(nv).sum(-1)
                                   + (y * y * (1.0 / nv)).sum(-1)),
            "mv": lambda: -0.5 * (torch.log(nv).sum(-1)
                                  + torch.mv(1.0 / nv, y * y)),
        }
        glue_ms = {k: timed(f) for k, f in glue.items()}
        glue_err = {k: float(((f().double() - c64) / c64).abs().max())
                    for k, f in glue.items()}
        rows.append(dict(
            glue_ms=glue_ms, glue_rel_err=glue_err, C=C, n=n, m=m,
            err_over_M=err,
            sym=bool(torch.equal(out[0], out[0].transpose(1, 2))), ms=ms,
            ws=_cuda.lib().gst_tnt_workspace(C, n, m), by_kernel=by))
        del T, y, nv, T64, y64, nv64, r64, M, Md
    print(json.dumps(dict(label=label, regs=regs, rows=rows)), flush=True)


if __name__ == "__main__":
    main()

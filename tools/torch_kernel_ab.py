#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's factor, hyper-block and Gram kernels of
one checkout, to compare two versions of the kernels on the same card.

    python3 tools/torch_kernel_ab.py [--root DIR] [--label NAME]

``--root`` is the directory holding the ``gibbs_student_t_tpu_torch``
package to time (default: the checkout this script lies in). One process
times one checkout, since two versions of the package cannot be imported
side by side; for an A/B, unpack the other commit (``git archive``) into a
directory and run this script once per root in one shell command on one
card, in turns (A, B, B, A).

The operands are those of a sweep of the port's own sampler on the demo
pulsar, captured at the calls of ``chol_fused`` and ``hyper_mh``: 30
Fourier components at 1024 chains (m = v = 60, the warp-per-matrix form)
and 80 components at 64 chains (m = v = 160, the block-per-matrix form);
and at the call of ``tnt_batched`` in a sweep of the stress config (a demo
pulsar of 100,000 TOAs padded to 102,400, 30 components, 64 chains: T is
102,400 x 74).
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
    from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
    from gibbs_student_t_tpu_torch.ops import chol, hyper_mh, linalg, tnt

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    cfg = GibbsConfig(model="mixture", vary_df=True, theta_prior="beta")
    kernels = {"chol_fused": (linalg, chol.chol_fused),
               "hyper_mh": (tb, hyper_mh.hyper_mh),
               "tnt_batched": (tb, tnt.tnt_batched)}

    def capture(components, nchains, names, n):
        """The operands of the last call of each kernel in ``names``, by
        the shape of its first operand, over three sweeps."""
        smp = tb.TorchGibbs(make_demo_model_arrays(n=n, components=components),
                            cfg, nchains=nchains, device=dev)
        got = {}
        for name in names:
            mod, fn = kernels[name]
            def rec(*args, name=name, fn=fn):
                got[(name, tuple(args[0].shape))] = tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args)
                return fn(*args)
            setattr(mod, name, rec)
        try:
            gen = torch.Generator(device=dev).manual_seed(5)
            st = smp.init_state(seed=5)
            for i in range(3):
                st = smp._sweep(st, smp._draw(gen, st), sweep=i)
            torch.cuda.synchronize()
        finally:
            for name, (mod, fn) in kernels.items():
                setattr(mod, name, fn)
        if sorted({k[0] for k in got}) != sorted(names):
            sys.exit(f"torch_kernel_ab: the sweeps reached {sorted(got)}")
        return got

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
    both = ("chol_fused", "hyper_mh")
    for components, nchains, names, n in ((30, 1024, both, 130),
                                          (80, 64, both, 130),
                                          (30, 64, ("tnt_batched",), 100_000)):
        for (name, shape), args in sorted(capture(components, nchains,
                                                  names, n).items()):
            rows.append({"kernel": name, "components": components,
                         "chains": nchains, "shape": list(shape),
                         "ms": timed(kernels[name][1], args)})
    print(json.dumps({"label": opts.label or root, "card": card,
                      "rows": rows}), flush=True)


if __name__ == "__main__":
    main()

"""Simulated-dataset driver: the port's ``simulate_data.py``.

    python -m gibbs_student_t_tpu_torch.drivers.simulate_data \\
        --theta 0.1 --idx 42 --seed 3 --outdir simdata

Writes ``{outdir}/outlier/{theta}/{idx}/`` (par, tim, ``outliers.txt``
ground truth) and the matching ``no_outlier`` twin with the outlier TOAs
flagged deleted (reference simulate_data.py:10-39), the same files, byte
for byte, as the JAX package's ``simulate_data.py`` writes for the same
arguments. Without ``--par/--tim`` a demo base dataset is generated
first. The simulation is host NumPy; ``--device`` (``cuda`` by default)
takes the place of that script's ``--backend`` and, like every entry
point of the port, refuses to start when CUDA is asked for and absent.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def ensure_base_dataset(par: str | None, tim: str | None, outdir: str,
                        n: int, seed: int):
    """``(parfile, timfile)``, generating the demo pulsar if needed."""
    if par and tim:
        return par, tim
    from gibbs_student_t_tpu_torch.data.demo import make_demo_fakepulsar

    fp = make_demo_fakepulsar(n=n, rng=np.random.default_rng(seed))
    os.makedirs(outdir, exist_ok=True)
    parfile = os.path.join(outdir, f"{fp.name}.par")
    timfile = os.path.join(outdir, f"{fp.name}.tim")
    fp.savepar(parfile)
    fp.savetim(timfile)
    return parfile, timfile


def check_device(ap: argparse.ArgumentParser, device: str) -> None:
    """Exit through ``ap.error`` when CUDA is asked for and absent: an
    entry point of the port never carries on on the CPU by itself."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: CUDA is not available here; pass "
                 "--device cpu to run on the CPU")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--par", default=None, help="base par file")
    ap.add_argument("--tim", default=None, help="base tim file (epochs)")
    ap.add_argument("--theta", type=float, default=0.05,
                    help="outlier probability")
    ap.add_argument("--idx", type=int, default=None,
                    help="dataset index (default: random 32-bit)")
    ap.add_argument("--sigma-out", type=float, default=1e-6,
                    help="outlier white-noise sigma in seconds")
    ap.add_argument("--outdir", default="simulated_data")
    ap.add_argument("--ntoa", type=int, default=130,
                    help="TOA count for the generated demo base dataset")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the device of the run (the simulation itself is "
                         "host NumPy on either)")
    args = ap.parse_args(argv)
    check_device(ap, args.device)

    from gibbs_student_t_tpu_torch.data.simulate import simulate_data

    rng = np.random.default_rng(args.seed)
    idx = (args.idx if args.idx is not None
           else int(rng.integers(0, 2 ** 32)))
    # the base dataset is seeded by --seed (not the dataset index), so
    # this driver and run_sims make the same base pulsar for one --seed
    base_seed = args.seed if args.seed is not None else 0
    par, tim = ensure_base_dataset(args.par, args.tim, args.outdir,
                                   args.ntoa, base_seed)
    out1, out2 = simulate_data(par, tim, theta=args.theta, idx=idx,
                               sigma_out=args.sigma_out,
                               outdir=args.outdir, rng=rng)
    print(out1)
    print(out2)
    return out1, out2


if __name__ == "__main__":
    main()

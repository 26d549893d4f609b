#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's factor, back-solve, hyper-block, Gram,
white-block and draw kernels of one checkout, to compare two versions of
the kernels on the same card.

    python3 tools/torch_kernel_ab.py [--root DIR] [--label NAME]
                                     [--only NAME,...]
                                     [--white-sweep [--sweep-n N,...]]
                                     [--draw-operands DIR]
                                     [--draw-elems A,G;...]
    python3 tools/torch_kernel_ab.py --compare FILE

``--root`` is the directory holding the ``gibbs_student_t_tpu_torch``
package to time (default: the checkout this script lies in). One process
times one checkout, since two versions of the package cannot be imported
side by side; for an A/B, unpack the other commit (``git archive``) into a
directory and run this script once per root in one shell command on one
card, in turns (A, B, B, A).

The operands are those of sweeps of the port's own samplers, captured at
the kernels' calls: the demo pulsar with 30 Fourier components at 1024
chains (``chol_fused``, ``tri_solve_T`` and ``hyper_mh`` at m = v = 60
and the back-solve also at 14: the warp-per-matrix forms), the same
sampler's chunk-end log-posterior and ``lnlikelihood`` after those sweeps
(``chol_fused`` at (1024, 74) and (1, 74)), with 32 components at 1024
chains (m = v = 64: three rows a lane, the right-hand side the third)
and with 80 components at 64 chains (m = v = 160, the block-per-matrix
forms); the
stress config's ``tnt_batched`` (a demo pulsar of 100,000 TOAs padded to
102,400, 30 components, 64 chains: T is 102,400 x 74); ens32's
``tri_solve_T`` (32 demo pulsars x 256 chains: 8,192 systems at 60 and
14); and the serving pool's ``tnt_lanes`` (1024 lanes of 4 tenants, the
serving bench's models: 64 groups x 16 lanes, 130 TOAs, m = 74). The
white kernels at every path's shape: ``white_mh`` at the flagship (1024 x
130) and stress (64 x 102,400) shapes and grouped at ens32 (32 x 256),
``white_mtm`` (K = 4) at 1024 chains and grouped at the ensemble's MTM arm
(8 demo pulsars x 128 chains), ``white_mh_lanes`` at the pool's; with
the checkout's launch form where it reports one, and with its issue
bound: the instructions the white likelihood needs a TOA and point (the
accurate ``logf`` and the IEEE quotient counted in the SASS of probe
kernels, plus the formula's own arithmetic) over the card's issue rate.
``--only`` times the named kernels alone.

``sweep_draws`` (D1, the per-chain draws) is timed on the operands of the
four paths' draw calls: the flagship (1024 chains with covariance
proposals, 646 values a chain), stress (64 x 307,426), ens32 (8,192 x
646) and pool1024 (1024 lanes x 616). ``--draw-operands DIR`` saves the
captured operands there (keys, sweep indices, shapes and the table's
fields) or, where a file of the path is there already, loads them, so
that every root of an A/B draws from the same inputs; each row carries
the sha256 of the kernel's output, and ``--compare FILE`` (the JSON lines
of several roots) checks that those digests agree path by path and prints
the times side by side. The rows of ``chol_fused`` and ``hyper_mh`` at
m, v <= 64 (the warp form's one and two rows a lane, and three at 64)
carry the same digest of their outputs, and of their operands beside it,
and ``--compare`` checks those too, shape by shape: two checkouts whose
digests agree there compute those factors and blocks bit for bit alike.
Rows of a root whose ``sweep_draws`` takes
``elems`` are timed also at each tile length of ``--draw-elems`` (values
a thread for the other fields and the gamma fields, e.g. ``8,4;1,1``),
and carry D1's instruction floor where the root's ``rng`` counts the
Marsaglia-Tsang attempts (:func:`draw_floor`).

``--white-sweep`` times instead ``white_mh`` and ``white_mtm`` (K = 4,
and K = 8 at 130 TOAs) on synthetic operands tiled from the demo pulsar
at n = 130, 256, 1,000, 4,096, 11,000, 20,000 and 102,400 TOAs and 64
and 1,024 chains (and 8,192 at 130; ``--sweep-n`` lists other n): the
sweep that places the crossover between the white kernels' warp and
cluster forms when run on checkouts that differ only in
``GST_WHITE_CROSSOVER``. A shape a checkout's kernel refuses is reported
with ``ms`` null.

Times are CUDA-event milliseconds per launch over 50 launches (20 for a
launch over 1e8 TOA-evaluations) queued behind a sleep kernel, so the
host's launch rate stays out of them. Prints one JSON line; needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


# Three kernels alike but for one operation: the white likelihood's
# logarithm and quotient are each the difference of their kernel's
# instructions from the first's.
_PROBE = r"""
extern "C" __global__ void probe_base(const float* a, const float* b,
                                      float* o) {
  const int i = threadIdx.x;
  o[i] = a[i] + b[i];
}
extern "C" __global__ void probe_log(const float* a, const float* b,
                                     float* o) {
  const int i = threadIdx.x;
  o[i] = logf(a[i]) + b[i];
}
extern "C" __global__ void probe_quot(const float* a, const float* b,
                                      float* o) {
  const int i = threadIdx.x;
  o[i] = b[i] / a[i] + a[i];
}
"""


def function_instructions(root):
    """Instructions issued for the accurate ``logf`` and the IEEE quotient
    ``/`` of one float32 on this card, as nvcc compiles them for sm_90a:
    ``{"logf": n, "quotient": n}``, each counted in the SASS
    (``cuobjdump -sass``) of a probe kernel with that one operation, less
    the same kernel without it, up to the kernel's ``EXIT`` and without
    the code a branch skips to reach the quotient's rare exact path (a
    call). ``None`` where ``nvcc`` or ``cuobjdump`` is missing."""
    sass = _sass(root, "probe", _PROBE)
    if sass is None:
        return None
    counts = {f: len(ins) for f, ins in _sass_fast_paths(sass).items()}
    base = counts["probe_base"]
    return {"logf": counts["probe_log"] - base,
            "quotient": counts["probe_quot"] - base}


# One value of each of D1's kinds, one Marsaglia-Tsang attempt, the boost
# of an accepted gamma and a shape's constants, each in a kernel of its
# own on operands read per thread (so nothing folds), from the kernel's
# own header csrc/gst_draws.cuh.
_DRAW_PROBE = r"""
#include "gst_draws.cuh"
#define I threadIdx.x
extern "C" __global__ void probe_base(const unsigned* w, const double* p,
                                      float* o) {
  o[I] = (float)p[I] + __uint_as_float(w[I]);
}
#define PLAIN(name, kind)                                                  \
  extern "C" __global__ void name(const unsigned* w, const double* p,      \
                                  float* o) {                              \
    o[I] = (float)gst_plain_value(kind, w[I], w[I + 32], w[I + 64],        \
                                  w[I + 96], w[I + 128]);                  \
  }
PLAIN(probe_uniform, GST_UNIFORM)
PLAIN(probe_normal, GST_NORMAL)
PLAIN(probe_log_uniform, GST_LOG_UNIFORM)
PLAIN(probe_gumbel, GST_GUMBEL)
extern "C" __global__ void probe_attempt(const unsigned* w, const double* p,
                                         float* o) {
  double g = 0.0;
  uint32_t w3;
  const bool acc = gst_mt_attempt(w[I], w[I + 32], w[I + 64], w[I + 96],
                                  w[I + 128], w[I + 160], p[I], p[I + 32],
                                  g, w3);
  o[I] = acc ? (float)g : __uint_as_float(w3);
}
extern "C" __global__ void probe_boost(const unsigned* w, const double* p,
                                       float* o) {
  o[I] = (float)gst_mt_boost(p[I], w[I], p[I + 32]);
}
extern "C" __global__ void probe_consts(const unsigned* w, const double* p,
                                        float* o) {
  double d, cc;
  gst_mt_consts(p[I], d, cc);
  o[I] = (float)d;
  o[I + 32] = (float)cc;
}
"""

#: the instruction classes D1's floor reads, with their rate in lanes a
#: cycle on one SM of compute capability 9.0 (CUDA C++ Programming Guide,
#: "Throughput of Native Arithmetic Instructions"): float64 add, multiply
#: and FMA 64; conversions from and to 64-bit types 16; the special
#: function unit (MUFU, the seeds of float64 rcp and rsqrt) 16; and
#: every instruction one of the 4 schedulers' 32 issue lanes
DRAW_RATES = {"fp64": 64, "conv64": 16, "mufu": 16, "issue": 128}


def _sass_fast_paths(sass):
    """``{function: [instruction text]}``: each function's instructions up
    to its first unpredicated ``EXIT``, without NOPs and without the code a
    forward branch skips to reach a call (a slow path)."""
    import re

    paths = {}
    for func in sass.split("Function : ")[1:]:
        ins = [(int(a, 16), t.strip()) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        end = next(a for a, t in ins if t.split()[-1] == "EXIT"
                   and not t.startswith("@"))
        skip = []
        for a, t in ins:
            m = re.search(r"\bBRA\s+(?:\S+,\s+)?`?\(?(?:0x)?([0-9a-f]+)",
                          t)
            tgt = int(m.group(1), 16) if m else a
            if a < tgt <= end and any(a < x < tgt and "CALL" in u
                                      for x, u in ins):
                skip.append((a, tgt))
        paths[func.split("\n", 1)[0].strip()] = [
            t for a, t in ins if a <= end and not t.startswith("NOP")
            and not any(lo < a < hi for lo, hi in skip)]
    return paths


def _sass(root, name, source, flags=()):
    """The SASS of ``source`` compiled for sm_90a (``None`` without
    ``nvcc`` or ``cuobjdump``)."""
    import shutil

    cuda = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda, "bin", "nvcc")
    tool = shutil.which("cuobjdump") or os.path.join(cuda, "bin",
                                                     "cuobjdump")
    if not (os.path.exists(nvcc) and os.path.exists(tool)):
        return None
    out = os.path.join(root, "gibbs_student_t_tpu_torch", "_build",
                       "probe")
    os.makedirs(out, exist_ok=True)
    src, cubin = (os.path.join(out, name + ".cu"),
                  os.path.join(out, name + ".cubin"))
    with open(src, "w") as fh:
        fh.write(source)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", *flags, "-cubin", src, "-o", cubin], check=True)
    return subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout


def _op_class(text):
    """The classes of :data:`DRAW_RATES` one SASS instruction counts in."""
    op = text.split()[1] if text.startswith("@") else text.split()[0]
    head = op.split(".")[0]
    cls = ["issue"]
    if head in ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "DSET"):
        cls.append("fp64")
    elif head in ("F2F", "I2F", "F2I") and "64" in op:
        cls.append("conv64")
    elif head == "MUFU":
        cls.append("mufu")
    return cls


def draw_instructions(root):
    """The instructions of one value of each of D1's kinds, of one
    Marsaglia-Tsang attempt, of the boost and of a shape's constants, as
    nvcc compiles ``csrc/gst_draws.cuh`` for sm_90a with D1's flags:
    ``{probe: {class: count}}`` over :data:`DRAW_RATES`' classes, counted
    on each probe's fast path (``issue``: less the same kernel's loads
    and store without the draw). ``None`` where ``nvcc`` or ``cuobjdump``
    is missing."""
    csrc = os.path.join(root, "gibbs_student_t_tpu_torch", "csrc")
    sass = _sass(root, "draw_probe", _DRAW_PROBE,
                 ("-fmad=false", "-I", csrc))
    if sass is None:
        return None
    counts = {}
    for func, ins in _sass_fast_paths(sass).items():
        c = dict.fromkeys(DRAW_RATES, 0)
        for t in ins:
            for k in _op_class(t):
                c[k] += 1
        counts[func] = c
    base = counts.pop("probe_base")
    out = {}
    for func, c in counts.items():
        c["issue"] -= base["issue"]
        out[func[len("probe_"):]] = c
    return out


def draw_work(rng, keys, sweep, shapes, table):
    """What D1 does on these operands: values of each non-gamma kind, the
    Marsaglia-Tsang attempts of the gammas (``rng.gamma_attempts``), the
    accepted boosted gammas and the (chain, shape column) pairs."""
    B = keys.numel() // 2
    sh = shapes.reshape(B, -1)
    kinds = {rng.UNIFORM: "uniform", rng.NORMAL: "normal",
             rng.LOG_UNIFORM: "log_uniform", rng.GUMBEL: "gumbel"}
    work = dict.fromkeys(kinds.values(), 0)
    work.update(attempts=rng.gamma_attempts(keys, sweep, shapes, table),
                boost=0, consts=0, gammas=0)
    for f in table.fields:
        if f.kind != rng.GAMMA:
            work[kinds[f.kind]] += B * f.count
            continue
        a = sh[:, f.col:f.col + f.count // f.per]
        work["boost"] += int(((a > 0) & (a < 1)).sum()) * f.per
        work["consts"] += a.numel()
        work["gammas"] += B * f.count
    return work


def draw_floor(ins, work, sms, mhz):
    """D1's least time on ``work`` (:func:`draw_work`) at ``ins``
    (:func:`draw_instructions`): for each class of :data:`DRAW_RATES` its
    instructions over its rate on ``sms`` SMs at ``mhz``; the floor is the
    largest (``by``)."""
    need = dict.fromkeys(DRAW_RATES, 0)
    for probe, count in (("uniform", work["uniform"]),
                         ("normal", work["normal"]),
                         ("log_uniform", work["log_uniform"]),
                         ("gumbel", work["gumbel"]),
                         ("attempt", work["attempts"]),
                         ("boost", work["boost"]),
                         ("consts", work["consts"])):
        for k in need:
            need[k] += count * ins[probe][k]
    ms = {k: need[k] / (sms * DRAW_RATES[k] * mhz * 1e6) * 1e3
          for k in need}
    by = max(ms, key=ms.get)
    return {"floor_ms": ms[by], "by": by, "ms_by_class": ms,
            "instructions": need}


def compare(path):
    """Check that the rows with digests of several roots (JSON lines of
    this script) agree bit for bit: D1 path by path (at every tile
    length), the factor and the hyper block shape by shape, operands and
    outputs; print every row's times side by side."""
    with open(path) as fh:
        runs = [json.loads(line) for line in fh if line.startswith("{")]
    digests, inputs, seen, times, ok = {}, {}, {}, {}, True
    for i, run in enumerate(runs):
        for r in run["rows"]:
            if "digest" in r:
                key = ((r["kernel"], r["case"])
                       if r["kernel"] == "sweep_draws"
                       else (r["kernel"], r["case"], tuple(r["shape"])))
                digests.setdefault(key, []).append(r["digest"])
                seen.setdefault(key, set()).add(i)
                if "digest_in" in r:
                    inputs.setdefault(key, []).append(r["digest_in"])
            times.setdefault((r["kernel"], r["case"], tuple(r["shape"]),
                              tuple(r.get("elems") or ())), []).append(
                (run["label"], r["ms"]))
    for key, ds in sorted(digests.items()):
        same = len(set(ds)) == 1 and len(seen[key]) == len(runs)
        same_in = len(set(inputs.get(key, [None]))) == 1
        ok &= same and same_in
        print(f"{' '.join(map(str, key))}: "
              f"{'bitwise equal' if same else 'DIFFERENT'} across "
              f"{len(seen[key])} of {len(runs)} runs"
              + ("" if same_in else " (operands DIFFERENT)"))
    for key, ts in sorted(times.items()):
        print(key, " ".join(f"{lab}={ms:.5f}" for lab, ms in ts))
    return ok


def digest(tensors):
    """The first 16 hex digits of the sha256 of the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        if hasattr(t, "detach"):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", default=None)
    ap.add_argument("--white-sweep", action="store_true")
    ap.add_argument("--sweep-n", default=None)
    ap.add_argument("--draw-operands", default=None)
    ap.add_argument("--draw-elems", default=None)
    ap.add_argument("--compare", default=None)
    opts = ap.parse_args()
    if opts.compare:
        sys.exit(0 if compare(opts.compare) else 1)
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
    from gibbs_student_t_tpu_torch.ops import rng, white_mh
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
               "tnt_lanes": (serve_pool, tnt.tnt_lanes),
               "white_mh": (tb, white_mh.white_mh),
               "white_mtm": (tb, white_mh.white_mtm),
               "white_mh_lanes": (serve_pool, white_mh.white_mh_lanes)}

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
        """``n`` sweeps of a sampler from its initial state (a checkout
        from before the per-chain draws draws from one generator)."""
        def run():
            st = smp.init_state(seed=5)
            if hasattr(smp, "_chain_keys"):
                keys = smp._chain_keys(5)
                idx = torch.arange(n, device=dev)

                def draw(st, i):
                    return smp._draw(keys, idx[i], st)
            else:
                gen = torch.Generator(device=dev).manual_seed(5)

                def draw(st, i):
                    return smp._draw(gen, st)
            for i in range(n):
                st = smp._sweep(st, draw(st, i), sweep=i)
            return st
        return run

    def logpost(smp):
        """The chunk-end log-posterior and one ``lnlikelihood`` of ``smp``
        after its sweeps (run here, outside the capture)."""
        st = sweeps(smp)()
        pt = [getattr(st, f)[0].cpu().numpy() for f in ("x", "z", "alpha")]

        def run():
            smp._logpost_chain(st)
            smp.lnlikelihood(*pt)
        return run

    def solo(components, nchains, n):
        return tb.TorchGibbs(make_demo_model_arrays(n=n,
                                                    components=components),
                             cfg, nchains=nchains, device=dev)

    def solo_mtm():
        return tb.TorchGibbs(make_demo_model_arrays(components=30),
                             cfg.with_mtm(4, blocks=("white",)),
                             nchains=1024, device=dev)

    def ens32(npsr=32, nchains=256, cfg=cfg):
        mas = [make_demo_model_arrays(n=130 - (i % 3) * 10, components=30,
                                      seed=100 + i) for i in range(npsr)]
        return EnsembleGibbs(mas, cfg, nchains=nchains, device=dev,
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
                          nlanes=1024, quantum=1, record="full", device=dev)
        for i in range(4):
            srv.submit(TenantRequest(ma=model(100 + i), niter=2,
                                     nchains=256, seed=200 + i))

        def run():
            srv.step()
            srv.step()
        return run

    cases = (
        ("solo 30 x 1024", lambda: sweeps(solo(30, 1024, 130)),
         ("chol_fused", "tri_solve_T", "hyper_mh", "white_mh")),
        ("logpost 30 x 1024", lambda: logpost(solo(30, 1024, 130)),
         ("chol_fused",)),
        ("solo 32 x 1024", lambda: sweeps(solo(32, 1024, 130)),
         ("chol_fused", "hyper_mh")),
        ("solo 80 x 64", lambda: sweeps(solo(80, 64, 130)),
         ("chol_fused", "hyper_mh")),
        ("mtm 30 x 1024", lambda: sweeps(solo_mtm()), ("white_mtm",)),
        ("stress", lambda: sweeps(solo(30, 64, 100_000)),
         ("tnt_batched", "white_mh")),
        ("ens32", lambda: sweeps(ens32(), 2), ("tri_solve_T", "white_mh")),
        ("ens mtm 8 x 128", lambda: sweeps(ens32(
            8, 128, cfg.with_mtm(4, blocks=("white",))), 2), ("white_mtm",)),
        ("pool1024", pool_step, ("tnt_lanes", "white_mh_lanes")))
    keep = set(opts.only.split(",")) if opts.only else None
    if keep:
        cases = tuple((c, mk, tuple(n for n in names if n in keep))
                      for c, mk, names in cases
                      if any(n in keep for n in names))
    cfg_cov = cfg.with_adapt(100, adapt_cov=True)
    # D1's paths: the samplers of chip_smoke.py's flagship, stress, ens32
    # and pool1024
    draw_cases = (
        ("flagship", lambda: sweeps(tb.TorchGibbs(
            make_demo_model_arrays(components=30), cfg_cov, nchains=1024,
            device=dev))),
        ("stress", lambda: sweeps(solo(30, 64, 100_000))),
        ("ens32", lambda: sweeps(ens32(cfg=cfg_cov), 2)),
        ("pool1024", pool_step))

    fn_ins = function_instructions(root)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])

    def per_point(R):
        """The least instructions a TOA and point of the white likelihood
        needs: ``logf`` and the quotient, one FMA a varying group (R - 2),
        ``az`` and ``rm`` applied (a multiply and an FMA), the two terms
        added and added into the sum. It leaves out the loads, the per-TOA
        ``1 - rm`` and the reduction, so it is a floor whatever the form."""
        if fn_ins is None:
            return None
        return fn_ins["logf"] + fn_ins["quotient"] + (R - 2) + 4

    def issue_bound(x, n, dx, mtm, R):
        """The least time the card's issue slots allow for a white block:
        its TOA-point evaluations (1 + S, or 1 + S (2K - 1) under MTM, a
        chain) times :func:`per_point` instructions, over 4 schedulers x 32
        lanes a cycle on every SM at the card's top SM clock."""
        if fn_ins is None:
            return None
        chains = x.numel() // x.shape[-1]
        S = dx.shape[-3] if mtm else dx.shape[-2]
        evals = 1 + S * (2 * dx.shape[-2] - 1 if mtm else 1)
        return (chains * n * evals * per_point(R)
                / (sms * 128 * max_mhz * 1e6) * 1e3)

    def form(n, p):
        """The white kernels' launch form at (n, p), where the checkout's
        package reports one."""
        probe = getattr(white_mh, "white_form", None)
        return list(probe(n, p)) if probe else None

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

    def white_sweep():
        """``white_mh`` and ``white_mtm`` on synthetic operands: the demo
        pulsar's white constants, az and yred^2 tiled to n TOAs."""
        import numpy as np

        ma = make_demo_model_arrays(components=30)
        wc = white_mh.build_white_consts(ma)
        rng = np.random.default_rng(7)
        rows_ = []
        ns = ([int(v) for v in opts.sweep_n.split(",")] if opts.sweep_n
              else [130, 256, 1000, 4096, 11000, 20000, 102400])
        shapes = [(n, C) for n in ns for C in (64, 1024)] + (
            [(130, 8192)] if 130 in ns else [])
        for n, C in shapes:
            reps = -(-n // ma.n)
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                          dtype=torch.float32, device=dev)
            rows = t(np.tile(wc.rows, (1, reps))[:, :n])
            az = t(rng.gamma(4.0, 0.25, (C, n)))
            y2 = t(np.tile(ma.y ** 2, (C, reps))[:, :n]
                   * rng.uniform(0.5, 1.5, (C, n)))
            x = t(np.array([-7.5, 4.0, -14.0])
                  + rng.normal(0, [0.4, 0.5, 0.3], (C, 3)))
            specs = t(wc.specs)
            S = 20
            for K in (None, 4, 8):
                if K == 8 and n != 130:
                    continue
                if K is None:
                    fn = white_mh.white_mh
                    args = (x, az, y2, t(rng.normal(0, 0.02, (C, S, 3))),
                            t(np.log(rng.random((C, S)))), rows, specs,
                            wc.var)
                    evals = 1 + S
                else:
                    fn = white_mh.white_mtm
                    args = (x, az, y2, t(rng.normal(0, 0.02, (C, S, K, 3))),
                            t(rng.normal(0, 0.02, (C, S, K - 1, 3))),
                            t(rng.gumbel(size=(C, S, K))),
                            t(np.log(rng.random((C, S)))), rows, specs,
                            wc.var)
                    evals = 1 + S * (2 * K - 1)
                try:
                    ms = timed(fn, args, 20 if C * n * evals > 1e8 else 50)
                except RuntimeError as exc:
                    ms = None
                    print(f"# {fn.__name__} ({C}, {n}, K={K}): {exc}",
                          file=sys.stderr)
                rows_.append({"kernel": fn.__name__, "chains": C, "n": n,
                              "K": K, "form": form(n, 3), "ms": ms,
                              "issue_bound_ms": issue_bound(
                                  x, n, args[3], K is not None,
                                  rows.shape[-2])})
                torch.cuda.synchronize()
            del az, y2
            torch.cuda.empty_cache()
        return rows_

    def draw_operands(case, make):
        """``(keys, sweep, shapes, table)`` of the last draw call of a
        path's sweeps, from ``--draw-operands`` where saved there."""
        path = (os.path.join(opts.draw_operands, case.replace(" ", "_")
                             + ".pt") if opts.draw_operands else None)
        if path and os.path.exists(path):
            d = torch.load(path)
            return (d["keys"].to(dev), d["sweep"].to(dev),
                    d["shapes"].to(dev),
                    rng.DrawTable([rng.DrawField(*f) for f in d["fields"]]))
        got = []
        real = tb.sweep_draws

        def rec(keys, sweep, shapes, table, out=None, **kw):
            got[:] = [(keys.clone(), sweep.clone(), shapes.clone(), table)]
            return real(keys, sweep, shapes, table, out=out, **kw)
        tb.sweep_draws = rec
        try:
            make()()
            torch.cuda.synchronize()
        finally:
            tb.sweep_draws = real
        (args,) = got
        if path:
            os.makedirs(opts.draw_operands, exist_ok=True)
            torch.save({"keys": args[0].cpu(), "sweep": args[1].cpu(),
                        "shapes": args[2].cpu(),
                        "fields": [tuple(f) for f in args[3].fields]}, path)
        return args

    def draw_rows():
        """D1 on each path's operands: time, output digest, and (where the
        checkout counts attempts) its work and instruction floor, at the
        default tiles and at each of ``--draw-elems``."""
        import inspect

        ins = draw_instructions(here)
        elems_ok = "elems" in inspect.signature(rng.sweep_draws).parameters
        variants = [None] + ([tuple(int(v) for v in e.split(","))
                              for e in opts.draw_elems.split(";")]
                             if opts.draw_elems and elems_ok else [])
        out = []
        for case, make in draw_cases:
            args = draw_operands(case, make)
            keys, sw, sh, tab = args
            B = keys.numel() // 2
            work = (draw_work(rng, *args)
                    if hasattr(rng, "gamma_attempts") else None)
            for elems in variants:
                fn = (rng.sweep_draws if elems is None else
                      lambda *a, e=elems: rng.sweep_draws(*a, elems=e))
                try:
                    res = fn(*args)
                    torch.cuda.synchronize()
                except (RuntimeError, ValueError) as exc:
                    # a tile length the checkout's kernel refuses
                    print(f"# sweep_draws {case} {elems}: {exc}",
                          file=sys.stderr, flush=True)
                    continue
                row = {"kernel": "sweep_draws", "case": case,
                       "shape": [B, tab.width], "elems": elems,
                       "ms": timed(fn, args), "digest": digest([res])}
                if elems is None:
                    row["work"] = work
                    row["floor"] = (draw_floor(ins, work, sms, max_mhz)
                                    if work and ins else None)
                out.append(row)
                print(f"# sweep_draws {case} {elems}: {row['ms']:.5f} ms",
                      file=sys.stderr, flush=True)
            del args, keys, sw, sh, res
            torch.cuda.empty_cache()
        return out, ins

    rows = []
    draw_ins = None
    if opts.white_sweep:
        rows = white_sweep()
    elif keep is None or "sweep_draws" in keep:
        rows, draw_ins = draw_rows()
    for case, make, names in () if opts.white_sweep else cases:
        for (name, shape), args in sorted(capture(make(), names).items()):
            row = {"kernel": name, "case": case, "shape": list(shape),
                   "ms": timed(kernels[name][1], args)}
            size = args[0 if name == "chol_fused" else 1].shape[-1]
            if name in ("chol_fused", "hyper_mh") and size <= 64:
                row["digest_in"] = digest(args)
                row["digest"] = digest(kernels[name][1](*args))
            if name.startswith("white"):
                row["form"] = form(args[1].shape[-1], args[0].shape[-1])
                row["issue_bound_ms"] = issue_bound(
                    args[0], args[1].shape[-1], args[3], name == "white_mtm",
                    args[-4].shape[-2] if name == "white_mh_lanes"
                    else args[-3].shape[-2])
            rows.append(row)
        torch.cuda.empty_cache()
    print(json.dumps({"label": opts.label or root, "card": card,
                      "function_instructions": fn_ins,
                      "per_point": per_point(3),
                      "draw_instructions": draw_ins, "sms": sms,
                      "max_sm_mhz": max_mhz, "rows": rows}), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Compare the float32 kernels of two versions of the port's CUDA sources
function by function, in PTX and in ptxas's report.

    python3 tools/torch_ptx_compare.py OLD_CSRC NEW_CSRC [--out FILE]

OLD_CSRC and NEW_CSRC are ``gibbs_student_t_tpu_torch/csrc`` directories
(unpack the other commit with ``git archive`` into a directory that
``.gitignore`` lists). Every ``.cu`` file in both is compiled with
``nvcc -ptx`` and with ``-Xptxas -v`` (the port's ``NVCC_FLAGS`` and
``SOURCE_FLAGS``), all files at once. An entry function is keyed by its
name and its integer and boolean template arguments; a float64 entry
(``double`` among its template arguments) is left out. Two entries are
the same when their PTX bodies are equal once names are normalised: the
anonymous namespace's hash, the dynamic shared arrays' names, a static
shared array's mangled owner, register numbers (renumbered in order of
first use) and branch labels. Equal PTX gives equal registers, spills and
results, which is what a change that templates a float32 kernel on the
scalar type must keep. Prints one JSON object and exits 1 when a float32
entry differs, is missing, or ptxas reports other registers or spills
for it. Needs ``nvcc`` (the card's machine), no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gibbs_student_t_tpu_torch.ops import _cuda  # noqa: E402

_ENTRY = re.compile(r"^(?:\.visible )?\.entry (\S+)\(", re.M)
_SHARED = re.compile(r"^\.extern \.shared \.align \d+ \.b8 (\S+)\[\];", re.M)
_REG = re.compile(r"%(rd|rs|r|fd|f|p)(\d+)\b")


def key_of(symbol: str):
    """``name<args>`` of a float32 entry, None for a float64 one."""
    name = _cuda._base_name(symbol).split("::")[-1]
    m = re.search(re.escape(name) + r"I((?:L[a-z]+-?\d+E)*)([a-z]?)E",
                  symbol)
    if not m:
        return name
    if m.group(2) == "d":
        return None
    # a kernel templated on the scalar type alone keys as its untemplated
    # float32 form
    return f"{name}<{m.group(1)}>" if m.group(1) else name


def normalise(body: str, symbol: str, shared) -> str:
    body = body.replace(symbol, "F")
    for name in shared:
        body = re.sub(r"\b" + re.escape(name) + r"\b", "SM", body)
    body = re.sub(r"_ZZ\S*?E\d+([A-Za-z_]\w*)\b", r"STATIC_\1", body)
    body = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "ANON_", body)
    body = re.sub(r"^\s*\.reg .*$", "", body, flags=re.M)
    seen, count = {}, {}

    def reg(m):
        if m.group(0) not in seen:
            count[m.group(1)] = count.get(m.group(1), 0) + 1
            seen[m.group(0)] = f"%{m.group(1)}{count[m.group(1)]}"
        return seen[m.group(0)]

    body = _REG.sub(reg, body)
    labels = {}
    return re.sub(r"\$L__BB\d+_\d+",
                  lambda m: labels.setdefault(m.group(0),
                                              f"$L{len(labels)}"), body)


def entries(ptx: str) -> dict:
    shared = _SHARED.findall(ptx)
    out = {}
    for m in _ENTRY.finditer(ptx):
        k = key_of(m.group(1))
        if k is not None:
            end = ptx.index("\n}\n", m.start())
            out[k] = normalise(ptx[m.start():end], m.group(1), shared)
    return out


def compile_one(nvcc, src, tmp, tag):
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    flags += list(_cuda.SOURCE_FLAGS.get(os.path.basename(src), ()))
    base = os.path.join(tmp, tag + "_" + os.path.basename(src))
    subprocess.run([nvcc, *flags, "-ptx", src, "-o", base + ".ptx"],
                   check=True, capture_output=True)
    rep = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-c", src, "-o",
                          base + ".o"], check=True, capture_output=True,
                         text=True)
    with open(base + ".ptx") as f:
        ptx = f.read()
    usage = {}
    for r in _cuda.parse_ptxas(rep.stderr + rep.stdout):
        k = key_of(r["symbol"])
        if k is not None:
            usage[k] = (r["registers"], r["spill_stores"], r["spill_loads"])
    return entries(ptx), usage


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--out")
    ap.add_argument("--dump", help="directory for the normalised PTX of "
                    "each entry that differs (old and new)")
    a = ap.parse_args()
    files = sorted(set(f for f in os.listdir(a.old) if f.endswith(".cu"))
                   & set(f for f in os.listdir(a.new) if f.endswith(".cu")))
    nvcc = _cuda._nvcc()
    report, bad = {}, 0
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(16) as ex:
        jobs = {(f, tag): ex.submit(compile_one, nvcc, os.path.join(d, f),
                                    tmp, tag)
                for f in files for tag, d in (("old", a.old),
                                               ("new", a.new))}
        for f in files:
            (po, uo), (pn, un) = (jobs[(f, "old")].result(),
                                  jobs[(f, "new")].result())
            diff = sorted(k for k in po if pn.get(k) != po[k])
            if a.dump:
                os.makedirs(a.dump, exist_ok=True)
                for k in diff:
                    for tag, body in (("old", po[k]), ("new", pn.get(k))):
                        name = re.sub(r"\W", "_", f"{f}_{k}_{tag}")
                        with open(os.path.join(a.dump, name + ".ptx"),
                                  "w") as fh:
                            fh.write(body or "")
            usage = sorted(k for k in uo if un.get(k) != uo[k])
            report[f] = {"float32_entries": len(po),
                         "same_ptx": len(po) - len(diff),
                         "ptx_differs": diff, "ptxas_differs": usage}
            bad += len(diff) + len(usage)
    report["ok"] = bad == 0
    line = json.dumps(report)
    print(line)
    if a.out:
        with open(a.out, "w") as fh:
            fh.write(line + "\n")
    return 0 if bad == 0 else 1


if __name__ == "__main__":
    sys.exit(main())

"""The port's drivers (``gibbs_student_t_tpu_torch.drivers``) on the CPU,
against the JAX package's ``simulate_data.py`` and ``run_sims.py``.

- ``drivers.simulate_data`` writes byte for byte the files of
  ``simulate_data.py`` for the same arguments;
- ``drivers.run_sims`` holds the five model configurations and builds the
  model arrays of ``run_sims.py``; run beside ``run_sims.py`` on the same
  arguments and ``--seed`` it simulates the same datasets, draws the same
  dataset indices and per-config seeds in the same order, hands each
  config the same model arrays and configuration, and writes the same
  ``{outdir}/{model}/{theta}/{idx}/*.npy`` files, each array of the same
  shape with the chain axis ``(rows, chains, ...)`` of ``--backend jax``;
- ``drivers.run_sims --device cpu`` writes arrays bitwise those of an
  in-process ``TorchGibbs(device="cpu")`` run with the driver's seed, one
  ``chunk`` event a chunk, one ledger record on the CPU platform;
  ``--ensemble 3`` saves TOA counts [30, 28, 26], prints its 1 x 1 mesh
  and writes bit for bit the trees of ``mesh=None``; ``--until-rhat`` stops
  on a check boundary; ``--trace-dir`` writes a Chrome trace per config;
- ``--introspect`` prints the run's introspection summary (each program's
  first chunk, the build, every kernel with ``impl=plain``) and the ledger
  record carries a schema-valid ``cuda`` block;
- bad flag combinations, the JAX driver's flags this one does not take,
  and ``--device cuda`` without CUDA exit non-zero.
"""

import dataclasses
import filecmp
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.data.pulsar import Pulsar
from gibbs_student_t_tpu_torch.drivers import run_sims, simulate_data
from gibbs_student_t_tpu_torch.obs.ledger import read_ledger
from gibbs_student_t_tpu_torch.obs.metrics import read_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = ("chain", "bchain", "zchain", "poutchain", "thetachain",
          "alphachain", "dfchain")


MODELS = ("vvh17", "uniform", "beta", "gaussian", "t")


def _jax_script(name):
    """The JAX package's driver script ``{name}.py``, loaded from the
    repository."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same(a, b):
    """Equal values: dataclasses field by field, sequences item by item,
    arrays bitwise with their dtype and shape."""
    if dataclasses.is_dataclass(a):
        names = [f.name for f in dataclasses.fields(a)]
        return (dataclasses.is_dataclass(b)
                and names == [f.name for f in dataclasses.fields(b)]
                and all(_same(getattr(a, n), getattr(b, n)) for n in names))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(map(_same, a, b)))
    return a == b


@pytest.mark.parametrize("model", MODELS)
def test_model_configs_are_the_jax_scripts(model):
    jax_configs = _jax_script("run_sims").model_configs
    for pspin in (0.00457, 0.01):
        ours = run_sims.model_configs(pspin)[model]
        theirs = jax_configs(pspin)[model]
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        for until, cov in ((5, True), (100, False)):
            assert dataclasses.asdict(ours.with_adapt(
                until, adapt_cov=cov)) == dataclasses.asdict(
                theirs.with_adapt(until, adapt_cov=cov))
        assert dataclasses.asdict(ours.with_mtm(
            4, blocks=("white",))) == dataclasses.asdict(
            theirs.with_mtm(4, blocks=("white",)))
    assert sorted(run_sims.model_configs()) == sorted(MODELS)


def test_build_pta_is_the_jax_scripts(tmp_path, capsys):
    from gibbs_student_t_tpu.data.pulsar import Pulsar as JaxPulsar

    simulate_data.main(["--theta", "0.1", "--idx", "4", "--seed", "2",
                        "--outdir", str(tmp_path), "--device", "cpu"])
    out1 = capsys.readouterr().out.split()[0]
    name = [f for f in os.listdir(out1) if f.endswith(".par")][0][:-4]
    files = (os.path.join(out1, name + ".par"),
             os.path.join(out1, name + ".tim"))
    ours = run_sims.build_pta(Pulsar(*files), 30).frozen()
    theirs = _jax_script("run_sims").build_pta(JaxPulsar(*files),
                                               30).frozen()
    assert ours.n == 130 and ours.nparam == 3
    assert _same(ours, theirs)


def test_run_sims_tree_is_the_jax_scripts(tmp_path, monkeypatch, capsys):
    """Both drivers on the same arguments and seed, two thetas: the same
    datasets, the same draws of idx and seed, the same model arrays and
    configurations handed to each run, and the same files and shapes
    (``run_sims.py --backend cpu`` runs one chain: its arrays lack the
    chain axis that ``--backend jax`` and the port put second)."""
    monkeypatch.syspath_prepend(REPO)       # run_sims.py imports its sibling
    jax_drv = _jax_script("run_sims")
    calls = {"jax": [], "port": []}

    def spy(mod, side):
        plain = mod.run_one

        def run_one(ma, cfg, where, niter, nchains, seed, **kw):
            calls[side].append((ma, cfg, seed))
            return plain(ma, cfg, where, niter, nchains, seed, **kw)

        monkeypatch.setattr(mod, "run_one", run_one)

    spy(jax_drv, "jax")
    spy(run_sims, "port")
    args = ["--niter", "12", "--burn", "4", "--thetas", "0.1", "0.2",
            "--ntoa", "30", "--components", "5", "--models", "vvh17", "t",
            "--seed", "3", "--ledger", ""]
    roots = {side: tmp_path / side for side in calls}
    jax_drv.main(args + ["--backend", "cpu", "--simdir",
                         str(roots["jax"] / "sim"), "--outdirs",
                         str(roots["jax"] / "o1"), str(roots["jax"] / "o2")])
    jax_out = capsys.readouterr().out.split()
    run_sims.main(args + ["--device", "cpu", "--nchains", "2", "--simdir",
                          str(roots["port"] / "sim"), "--outdirs",
                          str(roots["port"] / "o1"),
                          str(roots["port"] / "o2")])
    port_out = capsys.readouterr().out.split()

    # the datasets, byte for byte: the simulator's draws from the rng
    sims = {side: str(roots[side] / "sim") for side in calls}
    assert _tree(sims["port"]) == _tree(sims["jax"])
    for f in _tree(sims["port"]):
        assert filecmp.cmp(os.path.join(sims["port"], f),
                           os.path.join(sims["jax"], f), shallow=False), f
    # the trees in the order the drivers print them (2 thetas x 2 twins x
    # 2 models), and every file's shape
    assert len(port_out) == 8 and [
        os.path.relpath(p, roots["port"]) for p in port_out] == [
        os.path.relpath(p, roots["jax"]) for p in jax_out]
    for twin in ("o1", "o2"):
        ours, theirs = str(roots["port"] / twin), str(roots["jax"] / twin)
        assert _tree(ours) == _tree(theirs) and len(_tree(ours)) == 28
        for f in _tree(ours):
            shape = np.load(os.path.join(theirs, f)).shape
            assert np.load(os.path.join(ours, f)).shape == (
                shape[:1] + (2,) + shape[1:]), f
    # what each run was handed: the seeds in the same order, the same
    # model arrays, and the configuration of the JAX driver's chain
    # backend (its default adaptation: min(100, burn) sweeps with
    # population-covariance proposals)
    assert len(calls["port"]) == len(calls["jax"]) == 8
    assert [c[2] for c in calls["port"]] == [c[2] for c in calls["jax"]]
    for (ma, cfg, _), (jma, jcfg, _) in zip(calls["port"], calls["jax"]):
        assert _same(ma, jma)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jcfg.with_adapt(4, adapt_cov=True))


def test_simulate_data_files_are_the_jax_scripts(tmp_path, capsys):
    args = ["--theta", "0.2", "--idx", "3", "--ntoa", "30", "--seed", "1"]
    ours = str(tmp_path / "port")
    theirs = str(tmp_path / "jax")
    simulate_data.main(args + ["--outdir", ours, "--device", "cpu"])
    printed = capsys.readouterr().out.split()
    _jax_script("simulate_data").main(args + ["--outdir", theirs])
    files = _tree(ours)
    assert files == _tree(theirs)
    assert os.path.join("outlier", "0.2", "3", "outliers.txt") in files
    assert len(files) == 7        # base par/tim + 2 twins x (par, tim) + truth
    for f in files:
        assert filecmp.cmp(os.path.join(ours, f), os.path.join(theirs, f),
                           shallow=False), f
    assert printed == [os.path.join(ours, "outlier", "0.2", "3"),
                        os.path.join(ours, "no_outlier", "0.2", "3")]


def _run(tmp_path, *extra, models=("beta", "gaussian"), nchains=4,
         niter=20, burn=5, components=5):
    """``drivers.run_sims.main`` on the CPU, its files under
    ``tmp_path``."""
    argv = ["--device", "cpu", "--nchains", str(nchains), "--niter",
            str(niter), "--burn", str(burn), "--thetas", "0.1", "--ntoa",
            "30", "--components", str(components), "--models", *models,
            "--simdir", str(tmp_path / "sim"),
            "--outdirs", str(tmp_path / "o1"), str(tmp_path / "o2"),
            "--ledger", str(tmp_path / "ledger.jsonl"), *extra]
    run_sims.main(argv)


def test_run_sims_tree_and_arrays(tmp_path, capsys):
    tele = str(tmp_path / "tele")
    _run(tmp_path, "--telemetry-dir", tele)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 4            # 2 models x 2 datasets
    starts = [e for e in read_events(tele) if e["event"] == "config_start"]
    assert len(starts) == 4
    for line, ev in zip(lines, starts):
        outdir = ev["outdir"]
        rel = os.path.relpath(line, outdir).split(os.sep)
        assert rel[:2] == [ev["config"], "0.1"] and len(rel) == 3
        assert sorted(os.listdir(line)) == sorted(c + ".npy" for c in CHAINS)
        saved = {c: np.load(os.path.join(line, c + ".npy")) for c in CHAINS}
        # the shapes run_sims.py --backend jax saves for these arguments
        assert saved["chain"].shape == (15, 4, 3)
        twin = "outlier" if outdir.endswith("o1") else "no_outlier"
        sim = os.path.join(str(tmp_path / "sim"), twin, "0.1", rel[2])
        name = [f for f in os.listdir(sim) if f.endswith(".par")][0][:-4]
        psr = Pulsar(os.path.join(sim, name + ".par"),
                     os.path.join(sim, name + ".tim"))
        ma = run_sims.build_pta(psr, 5).frozen()
        assert saved["zchain"].shape == (15, 4, ma.n)
        cfg = run_sims.model_configs()[ev["config"]].with_adapt(
            5, adapt_cov=True)
        ref = TorchGibbs(ma, cfg, nchains=4, device="cpu").sample(
            niter=20, seed=ev["seed"]).burn(5)
        for c in CHAINS:
            assert np.array_equal(saved[c], getattr(ref, c)), c
    events = read_events(tele)
    assert sum(e["event"] == "chunk" for e in events) == 4   # 20 < 100
    assert [e["event"] for e in events].count("config_end") == 4
    with open(os.path.join(tele, "manifest.json")) as fh:
        manifest = json.load(fh)
    assert manifest["device"] == "cpu" and "torch_version" in manifest
    assert "health: chains 4/4" in err
    (rec,) = read_ledger(str(tmp_path / "ledger.jsonl"))
    assert rec["tool"] == "run_sims" and rec["platform"] == "cpu"
    assert rec["metrics"]["n_configs_done"] == 4


def test_run_sims_ensemble_keeps_each_pulsars_toas(tmp_path, capsys):
    _run(tmp_path, "--ensemble", "3", models=("beta",), nchains=2,
         niter=12, burn=2, components=4)
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 3
    ns = []
    for i, ln in enumerate(lines):
        assert os.path.relpath(ln, str(tmp_path / "o1")).split(os.sep)[
            :3] == ["ensemble", "beta", "0.1"]
        assert os.path.basename(ln).startswith(f"{i:02d}_")
        assert np.load(os.path.join(ln, "chain.npy")).shape == (10, 2, 3)
        ns.append(np.load(os.path.join(ln, "zchain.npy")).shape[-1])
    assert ns == [30, 28, 26]
    assert "# ensemble: 3 pulsars" in err


def test_run_sims_ensemble_mesh_is_the_one_device_run(tmp_path, capsys,
                                                      monkeypatch):
    """``--ensemble`` always samples over a mesh, 1 x 1 under ``--device
    cpu``, and prints it; its trees are bit for bit those of the same run
    with ``mesh=None`` on the device (the ensemble before the mesh)."""
    import gibbs_student_t_tpu_torch.parallel as par

    args = dict(models=("beta",), nchains=2, niter=12, burn=2, components=4)
    _run(tmp_path / "mesh", "--ensemble", "3", "--seed", "9", **args)
    out, err = capsys.readouterr()
    assert "mesh {'pulsar': 1, 'chain': 1}" in err
    meshed = [ln for ln in out.splitlines() if ln.strip()]

    class Unmeshed(par.EnsembleGibbs):
        def __init__(self, *a, mesh=None, **kw):
            assert mesh is not None and mesh.shape == {"pulsar": 1,
                                                       "chain": 1}
            super().__init__(*a, device="cpu", **kw)

    monkeypatch.setattr(par, "EnsembleGibbs", Unmeshed)
    _run(tmp_path / "flat", "--ensemble", "3", "--seed", "9", **args)
    flat = [ln for ln in capsys.readouterr()[0].splitlines() if ln.strip()]
    assert len(meshed) == len(flat) == 3
    for a, b in zip(meshed, flat):
        for c in CHAINS:
            assert _same(np.load(os.path.join(a, c + ".npy")),
                         np.load(os.path.join(b, c + ".npy"))), c


def test_run_sims_until_rhat_stops_on_a_check_boundary(tmp_path, capsys):
    _run(tmp_path, "--until-rhat", "1.5", "--check-every", "20",
         models=("gaussian",), nchains=6, niter=60)
    out, err = capsys.readouterr()
    line = [ln for ln in out.splitlines() if ln.strip()][0]
    rows = np.load(os.path.join(line, "chain.npy")).shape[0]
    assert rows % 20 == 15 and rows <= 55       # burn 5 off a 20-multiple
    assert "rhat_max=" in err and "converged=" in err


def test_run_sims_trace_dir_writes_a_trace_per_config(tmp_path, capsys):
    tr = str(tmp_path / "trace")
    _run(tmp_path, "--trace-dir", tr, models=("gaussian",), nchains=2,
         niter=2, burn=1, components=4)
    files = sorted(os.listdir(tr))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    with open(os.path.join(tr, files[0])) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "gibbs/hyper_mh" in names


@pytest.mark.parametrize("flags", [
    ["--adapt", "0", "--adapt-cov"],
    ["--min-ess", "10"],
    ["--mtm-blocks", "white"],
    ["--until-rhat", "1.1", "--check-every", "4"],
    ["--until-rhat", "1.1", "--check-every", "20", "--burn", "40"],
    ["--until-rhat", "1.1", "--niter", "15", "--record-thin", "2",
     "--check-every", "20"],
    ["--telemetry-dir", "t", "--no-telemetry"],
    ["--models", "nope"],
    ["--backend", "jax"],
    ["--unroll", "1"],
])
def test_run_sims_rejects_bad_flags(tmp_path, capsys, flags):
    with pytest.raises(SystemExit) as exc:
        run_sims.main(["--device", "cpu", "--simdir", str(tmp_path / "s"),
                       *flags])
    assert exc.value.code != 0
    assert not os.path.exists(tmp_path / "s")   # no dataset work first
    assert "error" in capsys.readouterr().err


@pytest.mark.parametrize("driver", [run_sims, simulate_data])
def test_drivers_refuse_cuda_without_it(tmp_path, capsys, driver):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    with pytest.raises(SystemExit) as exc:
        driver.main(["--simdir" if driver is run_sims else "--outdir",
                     str(tmp_path / "s")])
    assert exc.value.code != 0
    assert "CUDA" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "s")


def test_run_sims_introspect_prints_and_records(tmp_path, capsys):
    from gibbs_student_t_tpu_torch.obs import introspect
    from gibbs_student_t_tpu_torch.obs import schema as port_schema

    introspect.clear_introspection()
    _run(tmp_path, "--introspect", models=("gaussian",), nchains=2,
         niter=4, burn=1, components=4)
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("  # ")]
    assert any(ln.startswith("  # program[torchgibbs_chunk_c2] "
                             "platform=cpu") for ln in lines), lines
    assert any(ln.startswith("  # build libgst_cuda.so: ") for ln in lines)
    kernels = {ln.split()[2] for ln in lines
               if ln.startswith("  # kernel ")}
    assert {"chol_fused", "tri_solve_T", "white_mh", "hyper_mh",
            "sweep_draws"} <= kernels
    assert all("impl=plain" in ln for ln in lines
               if ln.startswith("  # kernel "))
    (rec,) = read_ledger(str(tmp_path / "ledger.jsonl"))
    schemas = port_schema.load_schemas()
    port_schema.assert_valid(rec, schemas["ledger_record"], "ledger record",
                             defs=schemas)
    cuda = rec["cuda"]
    # one sampler, so one program record, a twin
    assert cuda["n_programs"] == 2 and cuda["peak_bytes"] == "unavailable"
    assert cuda["programs"][0]["label"] == "torchgibbs_chunk_c2"
    assert {k["kernel"] for k in cuda["kernels"]} == kernels
    assert cuda["build"]["last_build"] is None
    # without the flag the record carries the block all the same
    _run(tmp_path, models=("gaussian",), nchains=2, niter=4, burn=1,
         components=4)
    assert not [ln for ln in capsys.readouterr().err.splitlines()
                if ln.startswith("  # kernel ")]
    assert read_ledger(str(tmp_path / "ledger.jsonl"))[-1]["cuda"][
        "kernels"]


def test_run_sims_help_says_which_flags_are_not_ported():
    r = subprocess.run(
        [sys.executable, "-m", "gibbs_student_t_tpu_torch.drivers.run_sims",
         "--help"], capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 0, r.stderr
    for flag in ("--backend", "--unroll", "--introspect", "--device"):
        assert flag in r.stdout
    assert "--backend {cpu,torch}" in r.stdout
    assert "numpy_backend" in r.stdout and "XLA" in r.stdout
    # --unroll is the one flag of the JAX script the driver does not take
    assert "does not take:\n\n  --unroll" in r.stdout

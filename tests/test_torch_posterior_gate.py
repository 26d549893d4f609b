"""The posterior gate (drivers/posterior_gate.py): the port's sampler
against the float64 NumPy oracle, in law.

- ``gate_rows`` gives the JAX tools' numbers on the same draws: the gap and
  the KS p of ``tools/tpu_gate.py``'s ``gate`` and of
  ``tools/j1713_gate.py``'s ``row`` (their own code, taken from the files),
  the subsample included;
- ``TorchGibbs(device="cpu")`` against the JAX package's ``NumpyGibbs`` on
  mixture/beta at 32 chains passes every quantity (the demo pulsar with 10
  red-noise components, so that the kernels' plain versions fit the
  tier-1 budget);
- the negative control: the same sampler with its b draw doubled (as
  ``BrokenGibbs``, tests/test_geweke.py) fails the gate, so the passing
  case is not a gate that cannot fail;
- the driver's command line end to end on the CPU (short), and, marked
  slow, the five models with the null control at the driver's CPU
  defaults (the oracle at ``tools/j1713_gate.py``'s lengths).

Seeds are fixed, so every verdict is the same in every run; the rows are
printed with their margins (``-s``).
"""

import ast
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from scipy import stats

from gibbs_student_t_tpu.backends.numpy_backend import NumpyGibbs as JaxNumpy
from gibbs_student_t_tpu_torch.backends.base import ChainResult
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.drivers import posterior_gate as pg
from gibbs_student_t_tpu_torch.drivers import run_sims
from test_torch_drivers import _jax_script
from test_torch_host import _fields

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tier-1 case: oracle and kernel lengths (sweeps, burn, thin)
ORACLE = (2000, 200, 10)
KERNEL = (800, 600, 20)
NCHAINS = 32


def _nested(path, outer, inner, **ns):
    """Function ``inner`` defined inside ``outer`` in the file ``path``,
    compiled on its own with the names it closes over taken from ``ns``."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == outer)
    node = next(n for n in ast.walk(fn)
                if isinstance(n, ast.FunctionDef) and n.name == inner)
    mod = ast.Module(body=[node], type_ignores=[])
    exec(compile(mod, path, "exec"), ns)
    return ns[inner]


def _synthetic(cfg, names, rows, chains, n, seed):
    """A result with ``rows`` draws of every field (``chains`` chains when
    given, else one chain with no chain axis), deterministic in ``seed``."""
    r = np.random.default_rng(seed)
    lead = (rows,) if chains is None else (rows, chains)
    p = len(names)
    return ChainResult(
        chain=r.normal(size=lead + (p,)) + np.arange(p),
        bchain=r.normal(size=lead + (4,)),
        zchain=(r.random(lead + (n,)) < 0.1).astype(float),
        thetachain=r.beta(2, 20, size=lead),
        alphachain=r.gamma(2.0, size=lead + (n,)) + 0.1,
        poutchain=r.random(lead + (n,)) * 0.2,
        dfchain=r.integers(1, 31, size=lead).astype(float), stats={})


def _tpu_gate_rows(oracle, kernel, cfg, names, sub):
    """``tools/tpu_gate.py``'s own ``gate`` over the quantities its
    ``gate_model`` builds, on kept draws."""
    rows, failures = {}, []
    gate = _nested("tools/tpu_gate.py", "main", "gate", np=np, stats=stats,
                   sub=sub, rows=rows, failures=failures)
    for pi, name in enumerate(names):
        gate(name, oracle.chain[:, pi], kernel.chain[:, :, pi])
    if cfg.is_outlier_model:
        gate("theta", oracle.thetachain, kernel.thetachain)
        gate("pout_mean", oracle.poutchain.mean(axis=1),
             kernel.poutchain.mean(axis=-1))
        gate("z_frac", oracle.zchain.mean(axis=1),
             kernel.zchain.mean(axis=-1))
    if cfg.vary_df:
        gate("df", oracle.dfchain.ravel(), kernel.dfchain)
    if cfg.vary_alpha and cfg.model in ("mixture", "t"):
        gate("alpha_log10_mean", np.log10(oracle.alphachain).mean(axis=1),
             np.log10(np.maximum(kernel.alphachain, 1e-300)).mean(axis=-1))
    return rows


@pytest.mark.parametrize("model", ["beta", "vvh17", "gaussian", "t"])
def test_gate_rows_are_the_jax_tools_numbers(model):
    cfg = run_sims.model_configs()[model]
    names = ("equad", "log10_A", "gamma")
    oracle = _synthetic(cfg, names, 450, None, 40, seed=1)
    null = _synthetic(cfg, names, 450, None, 40, seed=2)
    # 18 rows x 300 chains: more than 4000 draws, so both subsample
    kernel = _synthetic(cfg, names, 18, 300, 40, seed=3)
    ours = pg.gate_rows(oracle, kernel, cfg, names,
                        sub=np.random.default_rng(0))
    theirs = _tpu_gate_rows(oracle, kernel, cfg, names,
                            np.random.default_rng(0))
    assert [r["quantity"] for r in ours] == list(theirs)
    for r in ours:
        t = theirs[r["quantity"]]
        assert round(r["gap_sd"], 3) == t["gap_sd"]
        assert r["ks_p"] == t["ks_p"] and r["ok"] == t["ok"]
        assert round(r["oracle_mean"], 4) == t["oracle_mean"]
        assert round(r["kernel_mean"], 4) == t["kernel_mean"]
    # j1713_gate.py's row: the same numbers plus the oracle-vs-oracle null
    sub = np.random.default_rng(0)
    row = _nested("tools/j1713_gate.py", "main", "row", np=np, stats=stats,
                  sub=sub, rows=[])
    with_null = pg.gate_rows(oracle, kernel, cfg, names, null_res=null,
                             sub=np.random.default_rng(0))
    q_o = pg.gated_quantities(oracle, cfg, names)
    q_n = pg.gated_quantities(null, cfg, names)
    q_k = pg.gated_quantities(kernel, cfg, names)
    for r in with_null:
        q = r["quantity"]
        t = row(q, np.asarray(q_o[q], np.float64),
                np.asarray(q_n[q], np.float64), q_k[q])
        assert round(r["gap_sd"], 4) == t["mean_gap_sd"]
        assert round(r["ks_p"], 5) == t["ks_p"]
        assert round(r["ks_p_null"], 5) == t["ks_p_null_oracle_vs_oracle"]
    # the quantities each model gates
    want = {"beta": 8, "vvh17": 6, "gaussian": 4, "t": 5}[model]
    assert len(ours) == want


def test_keep_rows_reads_a_thinned_record_as_the_full_one():
    cfg = run_sims.model_configs()["beta"]
    full = _synthetic(cfg, ("a",), 500, 4, 6, seed=5)
    thin = ChainResult(**{f.name: getattr(full, f.name)[::10]
                          for f in dataclasses.fields(full)
                          if f.name != "stats"}, stats={"record_thin": 10})
    a, b = pg.keep_rows(full, 150, 20), pg.keep_rows(thin, 150, 20)
    for f in dataclasses.fields(a):
        if f.name != "stats":
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name))
    assert a.chain.shape == (18, 4, 1)
    with pytest.raises(ValueError, match="record_thin"):
        pg.keep_rows(thin, 155, 20)


class _DoubledB(TorchGibbs):
    """The b draw doubled (conditional mean 2x, covariance 4x)."""

    def _sweep(self, state, draws, sweep=None, block_gates=None):
        st = super()._sweep(state, draws, sweep, block_gates)
        return st._replace(b=2.0 * st.b)


@pytest.fixture(scope="module")
def beta_oracle():
    """The JAX oracle on mixture/beta (the demo pulsar, 10 components) and
    the port's model and config."""
    from gibbs_student_t_tpu.data.demo import make_demo_model_arrays

    jma = make_demo_model_arrays(n=130, components=10, seed=42)
    jcfg = _jax_script("run_sims").model_configs()["beta"]
    niter, burn, thin = ORACLE
    seed = 123
    res = JaxNumpy(jma, jcfg).sample(jma.x_init(np.random.default_rng(seed)),
                                     niter, seed=seed)
    ma = model_arrays_from_fields(_fields(jma))
    return ma, run_sims.model_configs()["beta"], pg.keep_rows(res, burn,
                                                              thin)


def _kernel_rows(cls, ma, cfg, oracle, niter, burn, thin):
    gb = cls(ma, cfg, nchains=NCHAINS, device="cpu", chunk_size=100,
             record="compact", record_thin=10)
    kept = pg.keep_rows(gb.sample(niter=niter, seed=124), burn, thin)
    rows = pg.gate_rows(oracle, kept, cfg, ma.param_names)
    for r in rows:
        print(pg.format_row(f"[{cls.__name__}]", r))
    return rows, kept


def test_torch_sampler_passes_the_gate_against_the_jax_oracle(beta_oracle):
    ma, cfg, oracle = beta_oracle
    rows, kept = _kernel_rows(TorchGibbs, ma, cfg, oracle, *KERNEL)
    assert [r["quantity"] for r in rows] == list(ma.param_names) + [
        "theta", "pout_mean", "z_frac", "df", "alpha_log10_mean"]
    assert kept.chain.shape[:2] == (10, NCHAINS)
    assert pg.diverged_chains(kept) == 0
    bad = [r for r in rows if not r["ok"]]
    assert not bad, bad


def test_a_doubled_b_draw_fails_the_gate(beta_oracle):
    ma, cfg, oracle = beta_oracle
    rows, _ = _kernel_rows(_DoubledB, ma, cfg, oracle, 100, 60, 20)
    bad = [r["quantity"] for r in rows if not r["ok"]]
    # the white block reads y - T b: the equad posterior is pushed far
    # out, well past the gap the gate allows
    assert "J0123+4567_log10_equad" in bad, rows


def test_driver_on_the_cpu(tmp_path, capsys):
    """The command line end to end, short: the oracles in the pool (one
    process each, two seeds), the rows printed and written, exit 1 on a
    failed quantity (these lengths are far too short to converge: the exit
    code follows the rows, whatever they say)."""
    out = tmp_path / "gate.json"
    rc = pg.main(["--device", "cpu", "--models", "gaussian", "--niter-np",
                  "200", "--burn-np", "50", "--thin-np", "10", "--nchains",
                  "4", "--niter-j", "40", "--burn-j", "20", "--thin-j", "10",
                  "--out", str(out)])
    text = capsys.readouterr().out
    rep = json.loads(out.read_text())
    blk = rep["models"]["gaussian"]
    assert rc == (0 if rep["ok"] else 1) and rep["ok"] == blk["ok"]
    assert [r["quantity"] for r in blk["rows"]] == [
        "J0123+4567_log10_equad", "J0123+4567_red_noise_gamma",
        "J0123+4567_red_noise_log10_A", "df"]
    assert all("ks_p_null" in r for r in blk["rows"])   # cpu: null control
    assert blk["diverged_chains"] == 0
    assert rep["device"] == {"type": "cpu", "name": "cpu",
                             "nvidia_smi": None}
    assert text.count("[gaussian] J0123+4567") == 3 and "[gate] ok=" in text


@pytest.mark.parametrize("flags", [
    ["--models", "nope"],
    ["--adapt-cov", "600"],
    ["--mtm-blocks", "white"],
    ["--niter-j", "100", "--burn-j", "100"],
])
def test_driver_rejects_bad_flags(flags, capsys):
    with pytest.raises(SystemExit) as exc:
        pg.parse_args(["--device", "cpu", *flags])
    assert exc.value.code != 0
    assert "error" in capsys.readouterr().err


@pytest.mark.slow
def test_five_models_at_the_j1713_gates_lengths(tmp_path):
    """The five models with the null control, the oracle at
    j1713_gate.py's lengths, on pulsar 100: on the default pulsar the
    uniform model's two modes are not weighed by any oracle run of this
    length (the driver's docstring)."""
    out = tmp_path / "gate.json"
    rc = pg.main(["--device", "cpu", "--pulsar-seed", "100", "--out",
                  str(out)])
    rep = json.loads(out.read_text())
    for key, blk in rep["models"].items():
        for r in blk["rows"]:
            print(pg.format_row(f"[{key}]", r))
    assert sorted(rep["models"]) == sorted(run_sims.model_configs())
    assert rc == 0 and rep["ok"]

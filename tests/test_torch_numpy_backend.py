"""The port's float64 NumPy oracle (backends/numpy_backend.py), its
``get_backend`` and ``drivers.run_sims --backend cpu``, against the JAX
package's:

- ``NumpyGibbs.sample`` bit for bit the JAX ``NumpyGibbs.sample`` on every
  chain array, for the five ``run_sims.model_configs()`` (vvh17 also from
  ``z_init="zeros"``, the posterior gate's start), 200 sweeps on the demo
  pulsar carried across by ``convert.model_arrays_from_fields``;
- each conditional block from the same state and ``Generator`` state: the
  same value and the same generator state after;
- ``get_backend``'s table and its ``ValueError``;
- ``drivers.run_sims --backend cpu`` writes the JAX script's files for the
  same arguments, byte for byte, and refuses the flags that need the chain
  axis before any dataset work.
"""

import dataclasses
import filecmp
import os

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.backends.numpy_backend import NumpyGibbs as JaxNumpy
from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu_torch.backends import (
    NumpyGibbs,
    TorchGibbs,
    get_backend,
)
from gibbs_student_t_tpu_torch.convert import model_arrays_from_fields
from gibbs_student_t_tpu_torch.drivers import run_sims
from test_torch_drivers import _jax_script, _tree
from test_torch_host import _fields

torch.set_num_threads(1)

CHAINS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
CASES = [("vvh17", "model"), ("vvh17", "zeros"), ("uniform", "model"),
         ("beta", "model"), ("gaussian", "model"), ("t", "model")]


def _pair(model, z_init="model", components=30):
    """The JAX model and config, and the port's copies of both."""
    jma = jax_demo_model_arrays(components=components)
    cfg = dataclasses.replace(run_sims.model_configs()[model], z_init=z_init)
    jcfg = dataclasses.replace(
        _jax_script("run_sims").model_configs()[model], z_init=z_init)
    return jma, jcfg, model_arrays_from_fields(_fields(jma)), cfg


@pytest.mark.parametrize("model,z_init", CASES)
def test_sample_is_the_jax_oracles_bit_for_bit(model, z_init):
    jma, jcfg, ma, cfg = _pair(model, z_init)
    seed = 11
    theirs = JaxNumpy(jma, jcfg).sample(
        jma.x_init(np.random.default_rng(seed)), 200, seed=seed)
    ours = NumpyGibbs(ma, cfg).sample(
        ma.x_init(np.random.default_rng(seed)), 200, seed=seed)
    for name in CHAINS:
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    for blk in ("acc_white", "acc_hyper"):
        assert np.array_equal(ours.stats[blk], theirs.stats[blk]), blk
    # the chain moved: a bit-for-bit pin of a frozen chain proves little
    assert np.unique(ours.chain[:, 0]).size > 20


BLOCKS = ("update_white_params", "update_hyper_params", "update_b",
          "update_theta", "update_z", "update_alpha", "update_df")


@pytest.mark.parametrize("block", BLOCKS)
def test_each_block_is_the_jax_oracles(block):
    """Both samplers brought to one state by 30 sweeps, then ``block``
    from generators in one state: equal values, equal generator states
    after (the same number of draws, in the same order)."""
    jma, jcfg, ma, cfg = _pair("beta", components=5)
    x0 = jma.x_init(np.random.default_rng(3))
    jgb, gb = JaxNumpy(jma, jcfg), NumpyGibbs(ma, cfg)
    xj = jgb.sample(x0, 30, seed=4).chain[-1]
    x = gb.sample(x0, 30, seed=4).chain[-1]
    assert np.array_equal(x, xj)
    for s in (gb, jgb):
        s._TNT = s._d = None
    rj, r = np.random.default_rng(9), np.random.default_rng(9)
    takes_x = block not in ("update_theta", "update_df")
    got = getattr(gb, block)(*((x,) if takes_x else ()), r)
    want = getattr(jgb, block)(*((xj,) if takes_x else ()), rj)
    if isinstance(want, tuple):            # (x, acceptance rate)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want))
    assert r.bit_generator.state == rj.bit_generator.state
    if block == "update_z":
        assert np.array_equal(gb._pout, jgb._pout)


def test_get_backend_table():
    assert get_backend("cpu") is NumpyGibbs
    assert get_backend("numpy") is NumpyGibbs
    assert get_backend("torch") is TorchGibbs
    assert not NumpyGibbs.supports_chains and TorchGibbs.supports_chains
    with pytest.raises(ValueError, match="options: .*'cpu'.*'torch'"):
        get_backend("jax")


def test_oracle_refuses_padded_models():
    _, _, ma, cfg = _pair("beta", components=5)
    mask = np.ones(ma.n, bool)
    mask[-3:] = False
    with pytest.raises(ValueError, match="padded"):
        NumpyGibbs(dataclasses.replace(ma, row_mask=mask), cfg)


def test_run_sims_backend_cpu_writes_the_jax_scripts_files(
        tmp_path, monkeypatch, capsys):
    monkeypatch.syspath_prepend(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))         # run_sims.py imports its sibling
    args = ["--backend", "cpu", "--niter", "40", "--burn", "10",
            "--thetas", "0.1", "0.2", "--ntoa", "30", "--components", "5",
            "--models", "vvh17", "beta", "t", "--seed", "3", "--ledger", ""]
    roots = {side: tmp_path / side for side in ("jax", "port")}

    def where(side):
        return ["--simdir", str(roots[side] / "sim"), "--outdirs",
                str(roots[side] / "o1"), str(roots[side] / "o2")]

    _jax_script("run_sims").main(args + where("jax"))
    jax_out = capsys.readouterr().out.split()
    # no --device: the oracle runs on the host, CUDA or not
    run_sims.main(args + where("port"))
    port_out = capsys.readouterr().out.split()
    assert len(port_out) == 12 and [
        os.path.relpath(p, roots["port"]) for p in port_out] == [
        os.path.relpath(p, roots["jax"]) for p in jax_out]
    ours, theirs = _tree(roots["port"]), _tree(roots["jax"])
    assert ours == theirs and len(ours) == 12 * 7 + 2 + 2 * 5
    for f in ours:
        assert filecmp.cmp(roots["port"] / f, roots["jax"] / f,
                           shallow=False), f
    chain = np.load(roots["port"] / "o1" / "beta" / "0.1"
                    / os.listdir(roots["port"] / "o1" / "beta" / "0.1")[0]
                    / "chain.npy")
    assert chain.shape == (30, 3) and chain.dtype == np.float64


@pytest.mark.parametrize("flags", [
    ["--mtm", "4"],
    ["--adapt", "50"],
    ["--adapt", "50", "--adapt-cov"],
    ["--until-rhat", "1.1"],
    ["--ensemble", "3"],
    ["--telemetry-dir", "t"],
])
def test_run_sims_backend_cpu_refuses_chain_axis_flags(tmp_path, capsys,
                                                       flags):
    with pytest.raises(SystemExit) as exc:
        run_sims.main(["--backend", "cpu", "--simdir", str(tmp_path / "s"),
                       *flags])
    assert exc.value.code != 0
    assert not os.path.exists(tmp_path / "s")
    assert "error" in capsys.readouterr().err

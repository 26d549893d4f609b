"""The PyTorch port's host layer and package rules.

- ``make_demo_model_arrays`` of the port equals the JAX package's field by
  field, bitwise, phi blocks included;
- ``convert.model_arrays_from_fields`` carries a JAX ``ModelArrays`` into
  the port with equal arrays, and a JAX chain state into a port state;
- ``TorchGibbs`` with no ``device`` raises on a host without CUDA;
- neither the port's package nor ``chip_smoke.py`` imports ``jax`` or the
  JAX package (an AST scan of every file).
"""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.data.demo import (
    make_demo_model_arrays as jax_demo_model_arrays,
)
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.convert import (
    chain_state_from_arrays,
    model_arrays_from_fields,
)
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays

# The suite runs in parallel workers and these tensors are small: one
# PyTorch CPU thread per worker costs nothing here and leaves the other
# cores to the other workers.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fields(ma):
    out = {f.name: getattr(ma, f.name) for f in dataclasses.fields(ma)}
    out["phi_blocks"] = [dataclasses.asdict(b) for b in ma.phi_blocks]
    return out


def _assert_same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


def _assert_model_equal(ma_port, ma_jax):
    fp, fj = _fields(ma_port), _fields(ma_jax)
    assert fp.keys() == fj.keys()
    for k in fp:
        if k == "phi_blocks":
            assert len(fp[k]) == len(fj[k])
            for i, (bp, bj) in enumerate(zip(fp[k], fj[k])):
                assert bp.keys() == bj.keys()
                for kk in bp:
                    _assert_same(bp[kk], bj[kk], f"phi_blocks[{i}].{kk}")
        else:
            _assert_same(fp[k], fj[k], k)
    assert ([type(b).__name__ for b in ma_port.phi_blocks]
            == [type(b).__name__ for b in ma_jax.phi_blocks])


@pytest.mark.parametrize("components", [5, 30])
def test_demo_model_arrays_bitwise(components):
    _assert_model_equal(make_demo_model_arrays(components=components),
                        jax_demo_model_arrays(components=components))


def test_flagship_shapes():
    ma = make_demo_model_arrays()
    assert (ma.n, ma.m, ma.nparam) == (130, 74, 3)
    assert [b.stop - b.start for b in ma.phi_blocks] == [60, 14]


def test_convert_roundtrip(demo_ma):
    ma_t = model_arrays_from_fields(_fields(demo_ma))
    _assert_model_equal(ma_t, demo_ma)
    # the crossing copies: mutating the port's arrays leaves the source
    ma_t.y[0] += 1.0
    assert ma_t.y[0] != demo_ma.y[0]


def test_convert_chain_state():
    import jax.numpy as jnp

    from gibbs_student_t_tpu.backends.jax_backend import ChainState

    rng = np.random.default_rng(3)
    C, p, m, n = 4, 3, 7, 5
    arrs = dict(x=rng.normal(size=(C, p)), b=rng.normal(size=(C, m)),
                z=rng.integers(0, 2, (C, n)), alpha=rng.random((C, n)),
                theta=rng.random(C), df=rng.integers(1, 30, C),
                pout=rng.random((C, n)), acc_white=rng.random(C),
                acc_hyper=rng.random(C))
    js = ChainState(**{k: jnp.asarray(v, jnp.float32)
                       for k, v in arrs.items()})
    st = chain_state_from_arrays({k: np.asarray(v)
                                  for k, v in js._asdict().items()},
                                 device="cpu")
    for k, v in arrs.items():
        np.testing.assert_array_equal(getattr(st, k).numpy(),
                                      np.asarray(v, np.float32))
    assert st.mh_log_scale.shape == (C, 2)
    assert st.mh_cov_chol.shape == (C, 0)


def test_default_device_raises_without_cuda(demo_ma):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    ma = model_arrays_from_fields(_fields(demo_ma))
    cfg = GibbsConfig(model="mixture")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchGibbs(ma, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchGibbs(ma, cfg, device="cuda")
    TorchGibbs(ma, cfg, nchains=2, device="cpu")
    arrs = {"x": np.zeros((2, 3)), "b": np.zeros((2, 4)),
            "z": np.zeros((2, 5)), "alpha": np.ones((2, 5)),
            "theta": np.zeros(2), "df": np.ones(2), "pout": np.zeros((2, 5)),
            "acc_white": np.zeros(2), "acc_hyper": np.zeros(2)}
    with pytest.raises(RuntimeError, match="CUDA"):
        chain_state_from_arrays(arrs)
    assert chain_state_from_arrays(arrs, device="cpu").x.device.type == "cpu"


def _port_files():
    pkg = os.path.join(REPO, "gibbs_student_t_tpu_torch")
    # chip_smoke.py and the measurement code it imports
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "torch_kernel_ab.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, nm) for nm in names
                  if nm.endswith(".py")]
    return sorted(files)


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "gibbs_student_t_tpu")


def test_port_imports_no_jax():
    files = _port_files()
    assert len(files) > 15
    scanned = {os.path.relpath(f, REPO) for f in files}
    assert {"gibbs_student_t_tpu_torch/ops/tnt.py",
            "gibbs_student_t_tpu_torch/ops/white_mh.py",
            "gibbs_student_t_tpu_torch/testing.py",
            "gibbs_student_t_tpu_torch/parallel/diagnostics.py",
            "gibbs_student_t_tpu_torch/obs/telemetry.py",
            "gibbs_student_t_tpu_torch/obs/health.py",
            "gibbs_student_t_tpu_torch/analysis.py",
            "gibbs_student_t_tpu_torch/utils/spool.py",
            "gibbs_student_t_tpu_torch/utils/spoolfile.py",
            "gibbs_student_t_tpu_torch/obs/metrics.py",
            "gibbs_student_t_tpu_torch/drivers/run_sims.py",
            "gibbs_student_t_tpu_torch/serve/faults.py",
            "gibbs_student_t_tpu_torch/serve/manifest.py",
            "gibbs_student_t_tpu_torch/serve/monitor.py",
            "gibbs_student_t_tpu_torch/obs/schema.py",
            "gibbs_student_t_tpu_torch/obs/spans.py",
            "gibbs_student_t_tpu_torch/obs/export.py",
            "gibbs_student_t_tpu_torch/obs/flight.py",
            "gibbs_student_t_tpu_torch/obs/watchdog.py",
            "gibbs_student_t_tpu_torch/obs/aggregate.py",
            "gibbs_student_t_tpu_torch/serve/router.py",
            "gibbs_student_t_tpu_torch/parallel/mesh.py",
            "gibbs_student_t_tpu_torch/parallel/multihost.py",
            "gibbs_student_t_tpu_torch/backends/numpy_backend.py",
            "gibbs_student_t_tpu_torch/drivers/posterior_gate.py"} <= scanned
    bad = []
    for path in files:
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(path, a.name) for a in node.names
                        if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.module:
                if node.level == 0 and _forbidden(node.module):
                    bad.append((path, node.module))
    assert not bad, bad

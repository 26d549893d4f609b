"""The port's ensemble across processes (``parallel/multihost.py``,
``EnsembleGibbs(mesh=)`` on a hybrid mesh, ``rhat_collective``) on the
CPU, in the form of tests/test_multihost.py: two child processes join one
``torch.distributed`` group over ``gloo`` on a localhost port.

- under ``dcn {"pulsar": 2}`` (each process two pulsars, its chains over
  two blocks of its own) and ``dcn {"chain": 2}`` (each process half of
  every pulsar's chains, so the proposal covariance gathers across the
  processes): each rank's rows, named by its result's
  ``pulsar_start``/``chain_start`` stats, equal its slice of the
  unsharded run in this process under test_torch_mesh.py's gate, and
  ``spool_dir`` and ``sample_until`` raise ``NotImplementedError``;
- ``rhat_collective`` over the two ranks (4 chains each) equals the JAX
  package's ``rhat_collective`` under ``shard_map`` on ``{"chain": 8}``
  for the same data to 1e-5 relative, and over the mesh's chain group,
  on the children's rows of one parameter, ``gelman_rubin`` of those
  rows gathered here.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from gibbs_student_t_tpu.parallel import make_mesh as jax_make_mesh
from gibbs_student_t_tpu.parallel.compat import shard_map
from gibbs_student_t_tpu.parallel.diagnostics import (
    rhat_collective as jax_rhat_collective,
)
from gibbs_student_t_tpu_torch.parallel import gelman_rubin
from test_torch_mesh import FIELDS, SWEEPS, _close, _ens

_CHILD = r"""
import json, sys
rank, port, dcn, out = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                        sys.argv[4])
import numpy as np
import torch
torch.set_num_threads(1)
from gibbs_student_t_tpu_torch.parallel import (
    EnsembleGibbs, initialize_distributed, make_hybrid_mesh,
    rhat_collective)
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays

assert initialize_distributed(coordinator_address=f"127.0.0.1:{port}",
                              num_processes=2, process_id=rank,
                              backend="gloo")
other = "chain" if dcn == "pulsar" else "pulsar"
mesh = make_hybrid_mesh({other: 2}, {dcn: 2},
                        devices=[torch.device("cpu")] * 2)
assert mesh.axis_names == (dcn, other) and mesh.devices.shape == (2, 2)
assert mesh.ranks.tolist() == [[0, 0], [1, 1]]
mas = [make_demo_model_arrays(n=30 - 2 * i, components=5, seed=100 + i)
       for i in range(4)]
cfg = GibbsConfig(model="mixture", vary_df=True,
                  theta_prior="beta").with_adapt(5, adapt_cov=True)
ens = EnsembleGibbs(mas, cfg, nchains=8, chunk_size=5, record="full",
                    mesh=mesh)
assert ens.spans_processes and len(ens._blocks) == 2
res = ens.sample(10, seed=1)
refused = []
for call in (lambda: ens.sample(10, seed=1, spool_dir=out + ".spool"),
             lambda: ens.sample_until(max_sweeps=32, check_every=16)):
    try:
        call()
    except NotImplementedError:
        refused.append(True)
arrays = {f: getattr(res, f) for f in (
    "chain", "bchain", "zchain", "thetachain", "alphachain", "poutchain",
    "dfchain")}
arrays.update({k: res.stats[k] for k in (
    "pulsar_start", "pulsar_stop", "chain_start", "chain_stop", "n_toa",
    "acc_white", "acc_hyper")})
np.savez(out, **arrays)
data = np.random.default_rng(7).normal(size=(8, 50)) + np.arange(8)[:, None]
rhat = rhat_collective(data[4 * rank:4 * rank + 4])
group = mesh.group("chain", (rank, 0) if dcn == "pulsar" else (0, 0))
rhat_line = (rhat_collective(res.chain[:, 0, :, 0].T, group=group)
             if group is not None else None)
print("CHILD_OK", json.dumps({"rank": rank, "rhat": rhat,
                              "rhat_line": rhat_line,
                              "refused": len(refused)}), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_children(tmp_path, dcn):
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MASTER_ADDR", "MASTER_PORT",
                        "WORLD_SIZE", "RANK")}
    env["PYTHONPATH"] = repo
    outs = [str(tmp_path / f"{dcn}{r}.npz") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(r), str(port), dcn, outs[r]],
        cwd=repo, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    lines = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"child failed:\n{err[-3000:]}"
            line = [ln for ln in out.splitlines()
                    if ln.startswith("CHILD_OK")][0]
            lines.append(json.loads(line.split(" ", 1)[1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return lines, [dict(np.load(o)) for o in outs]


@pytest.fixture(scope="module")
def unsharded():
    return _ens().sample(SWEEPS, seed=1)


def _jax_rhat(data):
    mesh = jax_make_mesh({"chain": 8})
    f = shard_map(lambda x: jax_rhat_collective(x, "chain"), mesh=mesh,
                  in_specs=P("chain"), out_specs=P(), check_vma=False)
    return float(jax.jit(f)(jnp.asarray(data, jnp.float32)))


@pytest.mark.parametrize("dcn", ["pulsar", "chain"])
def test_two_processes_hold_their_slices(dcn, tmp_path, unsharded):
    lines, rows = _run_children(tmp_path, dcn)
    ref = unsharded
    seen = np.zeros((4, 8), int)
    for line, got in zip(lines, rows):
        assert line["refused"] == 2
        ps = slice(int(got["pulsar_start"]), int(got["pulsar_stop"]))
        cs = slice(int(got["chain_start"]), int(got["chain_stop"]))
        seen[ps, cs] += 1
        np.testing.assert_array_equal(got["n_toa"], ref.stats["n_toa"][ps])
        for f in FIELDS:
            _close(got[f], getattr(ref, f)[:, ps, cs], f)
        for k in ("acc_white", "acc_hyper"):
            _close(got[k], ref.stats[k][:, ps, cs], k)
    # the two ranks' rows tile the population once
    assert (seen == 1).all()
    data = (np.random.default_rng(7).normal(size=(8, 50))
            + np.arange(8)[:, None])
    want = gelman_rubin(data.T)
    for line in lines:
        np.testing.assert_allclose(line["rhat"], want, rtol=1e-12)
        np.testing.assert_allclose(line["rhat"], _jax_rhat(data), rtol=1e-5)
    if dcn == "chain":
        both = np.concatenate([r["chain"][:, 0, :, 0] for r in rows], 1)
        for line in lines:
            np.testing.assert_allclose(line["rhat_line"], gelman_rubin(both),
                                       rtol=1e-12)
    else:
        assert all(line["rhat_line"] is None for line in lines)

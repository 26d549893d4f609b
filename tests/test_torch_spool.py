"""Checkpoints and the chain spool of the port, against the JAX package
(CPU).

- the spool file (``utils/spoolfile.py``) against the JAX package's native
  writer and reader (``gibbs_student_t_tpu.native``), float32 and
  float64, scalar and 3-d rows: the port's file is byte for byte the
  native one, each side reads the other's file equal, and the readable
  prefix after an interruption, the resume that keeps history and the
  truncation of orphan and partial rows behave the same on both sides
  (mirrors tests/test_native.py's spool tests);
- checkpoints (``utils/checkpoint.py``): the port's ``.npz`` loads
  through the JAX package's ``load_checkpoint`` with equal arrays and the
  other way round, and one without the adaptation fields loads (mirrors
  tests/test_utils_drivers.py's checkpoint tests);
- ``TorchGibbs.sample(spool_dir=)``: a spooled run equals the in-memory
  run bitwise (compact8, full, thinned), a killed run with orphan rows
  appended by hand resumes to the unbroken run (also at record_thin=2,
  its orphans a chunk of thinned rows), re-inits count on across
  a resume, ``sample_until`` duplicates no row, mismatched resumes raise;
  the spool's ``meta.json`` and files equal those the JAX package's
  ``ChainSpool`` writes for the same rows, and both packages' readers
  agree on the directory (mirrors tests/test_native.py's sampler tests);
- ``EnsembleGibbs.sample(spool_dir=)``: a resumed spool equals the
  unbroken run, and ``select_pulsar`` keeps each pulsar's TOA count
  (mirrors tests/test_parallel.py's ensemble spool test).
"""

import json
import os

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu import native
from gibbs_student_t_tpu.backends.jax_backend import ChainState as JaxState
from gibbs_student_t_tpu.utils import checkpoint as jax_ckpt
from gibbs_student_t_tpu.utils import spool as jax_spool
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.parallel import EnsembleGibbs
from gibbs_student_t_tpu_torch.utils import spoolfile
from gibbs_student_t_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from gibbs_student_t_tpu_torch.utils.spool import (
    load_spool,
    load_spool_prefix,
    load_spool_state,
)

CHAINS = ("chain", "bchain", "zchain", "alphachain", "poutchain",
          "thetachain", "dfchain")
ROW_SHAPES = [(), (3, 2, 4)]
DTYPES = [np.float32, np.float64]


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not native.available():
        pytest.skip("the JAX package's native spool library is not built")


@pytest.fixture(scope="module")
def ma():
    return make_demo_model_arrays(n=30, components=4)


@pytest.fixture(scope="module")
def cfg():
    return GibbsConfig(model="mixture", vary_df=True,
                       theta_prior="beta").with_adapt(8, adapt_cov=True)


def _rows(n, shape, dtype, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n,) + shape).astype(dtype)


def _write(side, path, chunks, shape, dtype, **kw):
    cls = spoolfile.SpoolWriter if side == "port" else native.SpoolWriter
    with cls(path, trailing_shape=shape, dtype=dtype, **kw) as w:
        for c in chunks:
            w.append(c)


def _read(side, path):
    return (spoolfile.read_spool(path) if side == "port"
            else native.read_spool(path))


# ---------------------------------------------------------------------------
# the spool file against the native writer and reader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ROW_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_spool_file_is_the_native_file(tmp_path, dtype, shape):
    a, b = _rows(3, shape, dtype, 1), _rows(2, shape, dtype, 2)
    paths = {s: str(tmp_path / f"{s}.spool") for s in ("port", "native")}
    for side, path in paths.items():
        _write(side, path, [a, b], shape, dtype)
    with open(paths["port"], "rb") as f1, open(paths["native"], "rb") as f2:
        assert f1.read() == f2.read()
    want = np.concatenate([a, b])
    for writer, path in paths.items():
        for reader in ("port", "native"):
            got = _read(reader, path)
            assert got.dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("side", ["port", "native"])
def test_spool_interrupted_prefix_readable(tmp_path, side):
    """A writer that never closed, and a torn partial row after it, leave
    the same readable prefix for both readers."""
    path = str(tmp_path / "p.spool")
    cls = spoolfile.SpoolWriter if side == "port" else native.SpoolWriter
    w = cls(path, trailing_shape=(4,))
    data = _rows(10, (4,), np.float32)
    w.append(data)
    w.flush()
    for reader in ("port", "native"):
        np.testing.assert_array_equal(_read(reader, path), data)
    with open(path, "ab") as fh:
        fh.write(b"\x01\x02\x03\x04\x05\x06")     # 1.5 floats of a row
    for reader in ("port", "native"):
        np.testing.assert_array_equal(_read(reader, path), data)
    w.close()


@pytest.mark.parametrize("first,then", [("port", "native"),
                                        ("native", "port")])
def test_spool_resume_keeps_history_across_writers(tmp_path, first, then):
    path = str(tmp_path / "r.spool")
    a = _rows(3, (2,), np.float64, 3)
    b = _rows(2, (2,), np.float64, 4)
    _write(first, path, [a], (2,), np.float64)
    _write(then, path, [b], (2,), np.float64, append=True)
    for reader in ("port", "native"):
        np.testing.assert_array_equal(_read(reader, path),
                                      np.concatenate([a, b]))
    cls = spoolfile.SpoolWriter if then == "port" else native.SpoolWriter
    with pytest.raises(OSError, match="mismatch"):
        cls(path, trailing_shape=(3,), dtype=np.float64, append=True)
    with pytest.raises(OSError, match="mismatch"):
        cls(path, trailing_shape=(2,), dtype=np.float32, append=True)


def test_spool_truncation_matches_native(tmp_path):
    """keep_rows drops orphan rows and a torn partial row on both sides,
    leaving the same bytes; a checkpoint past the file's rows is
    refused by both."""
    a = _rows(5, (2,), np.float32, 5)
    tail = np.full((1, 2), 9.0, np.float32)
    paths = {}
    for side in ("port", "native"):
        path = paths[side] = str(tmp_path / f"{side}.spool")
        _write("native", path, [a], (2,), np.float32)
        with open(path, "ab") as fh:
            fh.write(b"\x00\x00\x00\x00")           # half a row
        _write(side, path, [tail], (2,), np.float32, append=True,
               keep_rows=3)
    with open(paths["port"], "rb") as f1, open(paths["native"], "rb") as f2:
        assert f1.read() == f2.read()
    for reader in ("port", "native"):
        np.testing.assert_array_equal(_read(reader, paths["port"]),
                                      np.concatenate([a[:3], tail]))
    with pytest.raises(OSError, match="fewer rows"):
        spoolfile.SpoolWriter(paths["port"], trailing_shape=(2,),
                              append=True, keep_rows=99)
    with pytest.raises(OSError, match="fewer rows"):
        native.SpoolWriter(paths["port"], trailing_shape=(2,), append=True,
                           keep_rows=99)


def test_spool_writer_refuses_what_a_reader_cannot_read(tmp_path):
    with pytest.raises(ValueError, match="float32 or float64"):
        spoolfile.SpoolWriter(str(tmp_path / "i.spool"), (2,), np.int32)
    with pytest.raises(ValueError, match="at least one value"):
        spoolfile.SpoolWriter(str(tmp_path / "z.spool"), (0,))
    w = spoolfile.SpoolWriter(str(tmp_path / "s.spool"), (2,))
    with pytest.raises(ValueError, match="row shape"):
        w.append(np.zeros((1, 3), np.float32))
    w.close()
    bad = tmp_path / "bad.spool"
    bad.write_bytes(b"NOTSPOOL" + bytes(12))
    with pytest.raises(OSError, match="bad spool header"):
        spoolfile.read_spool(str(bad))


# ---------------------------------------------------------------------------
# checkpoints across the packages
# ---------------------------------------------------------------------------


def _state(ma, cfg, chains=3):
    smp = TorchGibbs(ma, cfg, nchains=chains, device="cpu", chunk_size=4)
    smp.sample(niter=4, seed=2)
    return smp.last_state


def test_checkpoint_port_to_jax(tmp_path, ma, cfg):
    state = _state(ma, cfg)
    assert state.mh_cov_chol.shape == (3, 2, 3, 3)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, state, sweep=4, seed=2)
    js, sweep, seed = jax_ckpt.load_checkpoint(path)
    assert (sweep, seed) == (4, 2)
    assert JaxState._fields == type(state)._fields
    for f in JaxState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                      getattr(state, f).numpy())


def test_checkpoint_jax_to_port(tmp_path, ma, cfg):
    state = _state(ma, cfg)
    js = JaxState(**{f: getattr(state, f).numpy() for f in state._fields})
    path = str(tmp_path / "j.npz")
    jax_ckpt.save_checkpoint(path, js, sweep=8, seed=5)
    st, sweep, seed = load_checkpoint(path, device="cpu")
    assert (sweep, seed) == (8, 5)
    for a, b in zip(st, state):
        assert torch.equal(a, b)


def test_checkpoint_without_adaptation_fields_loads(tmp_path, ma, cfg):
    path = str(tmp_path / "old.npz")
    save_checkpoint(path, _state(ma, cfg), sweep=4, seed=2)
    with np.load(path) as data:
        trimmed = {k: data[k] for k in data.files
                   if k not in ("mh_log_scale", "mh_cov_chol")}
    np.savez(path, **trimmed)
    st, _, _ = load_checkpoint(path, device="cpu")
    assert st.mh_log_scale.shape == (3, 2) and not st.mh_log_scale.any()
    assert st.mh_cov_chol.shape == (3, 0)
    js, _, _ = jax_ckpt.load_checkpoint(path)
    assert np.asarray(js.mh_cov_chol).shape == (3, 0)
    del trimmed["x"]
    np.savez(path, **trimmed)
    with pytest.raises(KeyError, match="'x'"):
        load_checkpoint(path, device="cpu")


def test_checkpoint_loads_on_cuda_by_default(tmp_path, ma, cfg):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without it")
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, _state(ma, cfg), sweep=4, seed=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(path)


# ---------------------------------------------------------------------------
# the solo sampler's spool
# ---------------------------------------------------------------------------


def _same(a, b):
    """Bitwise equal arrays (a NaN of a dead chain equal to itself)."""
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _equal(a, b, stats=True):
    for f in CHAINS:
        assert _same(getattr(a, f), getattr(b, f)), f
    if stats:
        assert sorted(a.stats) == sorted(b.stats)
        for k in a.stats:
            assert _same(a.stats[k], b.stats[k]), k


@pytest.mark.parametrize("record,thin", [("compact8", 1), ("full", 1),
                                         ("full", 2)])
def test_spooled_run_matches_inmemory(tmp_path, ma, cfg, record, thin):
    def smp():
        return TorchGibbs(ma, cfg, nchains=3, device="cpu", chunk_size=4,
                          record=record, record_thin=thin)

    mem = smp()
    r_mem = mem.sample(niter=12, seed=11)
    sp = smp()
    d = str(tmp_path / "spool")
    r_sp = sp.sample(niter=12, seed=11, spool_dir=d)
    _equal(r_sp, r_mem)
    for a, b in zip(sp.last_state, mem.last_state):
        assert torch.equal(a, b)
    state, sweep, seed = load_spool_state(d, device="cpu")
    assert (sweep, seed) == (12, 11)
    for a, b in zip(state, mem.last_state):
        assert torch.equal(a, b)


def _append_orphans(d, rows=3):
    """A kill after the records of a chunk were flushed and before its
    checkpoint: whole orphan rows plus a torn partial row on every
    spool file."""
    for name in os.listdir(d):
        if name.endswith(".spool"):
            path = os.path.join(d, name)
            dtype, shape, _, _ = spoolfile.spool_info(path)
            with open(path, "ab") as fh:
                fh.write(np.full((rows,) + shape, 7.0, dtype).tobytes())
                fh.write(b"\x00\x01\x02")


@pytest.mark.parametrize("thin", [1, 2])
def test_killed_run_resumes_to_the_unbroken_run(tmp_path, ma, cfg, thin):
    """Killed after a chunk's rows and before its checkpoint: an orphan
    chunk of rows (of thinned rows at record_thin=2) and a torn row; the
    resume keeps (resume_at - base) // record_thin rows."""
    def smp():
        return TorchGibbs(ma, cfg, nchains=3, device="cpu", chunk_size=4,
                          record_thin=thin)

    ref = smp().sample(niter=16, seed=5, spool_dir=str(tmp_path / "ref"))
    d = str(tmp_path / "killed")
    smp().sample(niter=8, seed=5, spool_dir=d)
    _append_orphans(d, rows=4 // thin)
    assert load_spool(d).chain.shape[0] == 12 // thin
    state, sweep, seed = load_spool_state(d, device="cpu")
    assert sweep == 8
    res = smp().sample(niter=8, seed=seed, state=state, start_sweep=sweep,
                       spool_dir=d)
    assert res.chain.shape[0] == 16 // thin
    _equal(res, ref, stats=False)
    for k in ("acc_white", "acc_hyper", "record_mode"):
        assert np.array_equal(res.stats[k], ref.stats[k])
    assert res.stats.get("record_thin", 1) == ref.stats.get(
        "record_thin", 1) == thin


def test_reinit_counts_on_across_a_resume(tmp_path, ma, cfg):
    """Under reinit_diverged the checkpoint is the re-drawn state and the
    re-init count is carried by run_stats.json."""
    def smp():
        return TorchGibbs(ma, cfg, nchains=3, device="cpu", chunk_size=4,
                          record="full")

    s0 = smp().init_state(seed=5)
    x = s0.x.clone()
    x[1] = float("nan")
    dead = s0._replace(x=x)
    mem = smp()
    r_mem = mem.sample(niter=8, seed=5, state=dead, reinit_diverged=True)
    assert int(r_mem.stats["n_reinits"]) == 1
    d = str(tmp_path / "spool")
    sp = smp()
    r_sp = sp.sample(niter=8, seed=5, state=dead, spool_dir=d,
                     reinit_diverged=True)
    _equal(r_sp, r_mem)
    st, _, _ = load_spool_state(d, device="cpu")
    for a, b in zip(st, mem.last_state):
        assert torch.equal(a, b)
    d2 = str(tmp_path / "killed")
    smp().sample(niter=4, seed=5, state=dead, spool_dir=d2,
                 reinit_diverged=True)
    with open(os.path.join(d2, "run_stats.json")) as fh:
        assert json.load(fh) == {"n_reinits": 1}
    st, sweep, seed = load_spool_state(d2, device="cpu")
    r_res = smp().sample(niter=4, seed=seed, state=st, start_sweep=sweep,
                         spool_dir=d2, reinit_diverged=True)
    assert int(r_res.stats["n_reinits"]) == 1
    _equal(r_res, r_mem, stats=False)


def test_sample_until_spool_duplicates_nothing(tmp_path, ma):
    cfg = GibbsConfig(model="gaussian", vary_df=False)
    d = str(tmp_path / "spool")
    smp = TorchGibbs(ma, cfg, nchains=4, device="cpu", chunk_size=8)
    res = smp.sample_until(rhat_target=1.5, max_sweeps=48, check_every=16,
                           seed=7, spool_dir=d)
    total = res.chain.shape[0]
    assert total in (32, 48)            # the first possible stop: 2 checks
    assert load_spool(d).chain.shape[0] == total
    assert spoolfile.spool_info(os.path.join(d, "x.spool"))[3] == total
    plain = TorchGibbs(ma, cfg, nchains=4, device="cpu",
                       chunk_size=8).sample(niter=total, seed=7)
    _equal(res, plain, stats=False)
    assert int(res.stats["tele_sweeps"]) == total
    assert res.stats["rhat_history"].shape == (total // 16, ma.nparam)


@pytest.mark.parametrize("change,match", [
    ({"record": "full"}, "record mode"),
    ({"record": "light"}, "record fields"),
    ({"record_thin": 2}, "record_thin"),
])
def test_mismatched_resume_raises(tmp_path, ma, cfg, change, match):
    d = str(tmp_path / "spool")
    TorchGibbs(ma, cfg, nchains=2, device="cpu", chunk_size=4).sample(
        niter=4, seed=1, spool_dir=d)
    state, sweep, seed = load_spool_state(d, device="cpu")
    smp = TorchGibbs(ma, cfg, nchains=2, device="cpu", chunk_size=4,
                     **change)
    with pytest.raises(ValueError, match=match):
        smp.sample(niter=4, seed=seed, state=state, start_sweep=sweep,
                   spool_dir=d)


def test_spool_directory_is_the_jax_packages(tmp_path, ma, cfg):
    """The JAX package's ``ChainSpool``, given the port's rows and state,
    writes the same ``meta.json`` and spool files; both packages' readers
    agree on the port's directory."""
    d = str(tmp_path / "port")
    smp = TorchGibbs(ma, cfg, nchains=3, device="cpu", chunk_size=4,
                     record_thin=2)
    res = smp.sample(niter=8, seed=4, spool_dir=d)
    rows = {f: spoolfile.read_spool(os.path.join(d, f + ".spool"))
            for f in ("x", "b", "z", "theta", "alpha", "df", "pout",
                      "acc_white", "acc_hyper")}
    dj = str(tmp_path / "jax")
    js = jax_spool.ChainSpool(dj, 4, record_mode="compact8", record_thin=2)
    js.append(rows, smp.last_state, 8)
    js.close()
    with open(os.path.join(d, "meta.json")) as f1, \
            open(os.path.join(dj, "meta.json")) as f2:
        assert json.load(f1) == json.load(f2)
    for f in rows:
        with open(os.path.join(d, f + ".spool"), "rb") as f1, \
                open(os.path.join(dj, f + ".spool"), "rb") as f2:
            assert f1.read() == f2.read(), f
    jres = jax_spool.load_spool(d)
    _equal(jres, res, stats=False)
    for upto in (0, 4, 6, 8, 12):
        mine = load_spool_prefix(d, "x", upto)
        theirs = jax_spool.load_spool_prefix(d, "x", upto)
        assert (mine is None) == (theirs is None)
        if mine is not None:
            np.testing.assert_array_equal(mine[0], theirs[0])
            assert mine[1] == theirs[1]
    assert load_spool_prefix(d, "nope", 8) is None
    js_state, sweep, seed = jax_spool.load_spool_state(d)
    assert (sweep, seed) == (8, 4)
    np.testing.assert_array_equal(np.asarray(js_state.x),
                                  smp.last_state.x.numpy())


# ---------------------------------------------------------------------------
# the ensemble's spool
# ---------------------------------------------------------------------------


def test_ensemble_spool_resume_matches_unbroken(tmp_path, cfg):
    mas = [make_demo_model_arrays(n=n, components=4, seed=90 + i)
           for i, n in enumerate((30, 26))]

    def ens():
        return EnsembleGibbs(mas, cfg, nchains=2, device="cpu",
                             chunk_size=3)

    ref = ens().sample(niter=12, seed=5)
    d = str(tmp_path / "spool")
    ens().sample(niter=6, seed=5, spool_dir=d)
    _append_orphans(d, rows=2)
    state, sweep, seed = load_spool_state(d, device="cpu")
    assert sweep == 6 and state.x.shape == (2, 2, 3)
    out = ens().sample(niter=6, seed=seed, state=state, start_sweep=sweep,
                       spool_dir=d)
    assert out.chain.shape == (12, 2, 2, 3)
    _equal(out, ref, stats=False)
    assert tuple(out.stats["n_toa"]) == (30, 26)
    assert str(out.stats["record_mode"]) == "compact8"
    with open(os.path.join(d, "meta.json")) as fh:
        assert json.load(fh)["extra"] == {"n_toa": [30, 26]}
    reloaded = load_spool(d)
    for i, n in enumerate((30, 26)):
        sel = reloaded.select_pulsar(i)
        assert sel.zchain.shape == (12, 2, n)
        np.testing.assert_array_equal(sel.zchain,
                                      ref.select_pulsar(i).zchain)


def test_light_ensemble_spool_selects_pulsars(tmp_path, cfg):
    """A light ensemble run records no per-TOA chain; a pulsar's slice of
    it (in memory or reloaded from its spool) keeps its TOA count and its
    empty chains."""
    mas = [make_demo_model_arrays(n=n, components=4, seed=80 + i)
           for i, n in enumerate((30, 28, 26))]
    ens = EnsembleGibbs(mas, cfg, nchains=2, device="cpu", chunk_size=4,
                        record="light")
    mem = ens.sample(niter=4, seed=3)
    d = str(tmp_path / "spool")
    sp = ens.sample(niter=4, seed=3, spool_dir=d)
    _equal(sp, mem, stats=False)
    for res in (mem, sp, load_spool(d)):
        for i, n in enumerate((30, 28, 26)):
            sel = res.select_pulsar(i)
            assert int(sel.stats["n_toa"]) == n
            assert sel.chain.shape == (4, 2, 3) and sel.zchain.size == 0

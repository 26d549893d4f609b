"""The port's RPC wire held against the JAX package's (CPU, no pool).

- the frame codec: for bodies of JSON values and numpy arrays (several
  dtypes and shapes, nested, empty, 0-d, numpy scalars) the port's
  ``encode_frame`` writes the JAX ``encode_frame``'s bytes, and each
  package decodes the other's frames; malformed, oversized and truncated
  frames raise the same errors in both; ``GST_RPC_MAX_FRAME`` is
  validated strictly by both;
- request bodies: ``_request_body`` of a port request is the JAX body of
  the same request, byte for byte once encoded, for the scalars, ``x0``,
  the monitor and the warm start (spec, fit, journaled dict); the port's
  own additions (a flow spec's ``kind``, ``adapt_scan``) round-trip;
  tenant errors and overload sheds round-trip as their structured types;
- the RPC edge over TCP on stub chain servers (no pool), for three
  pairings of client and server: the port's with the port's, the port's
  client against the JAX ``RpcServer`` on the JAX test's stub, and the
  JAX client against the port's ``RpcServer`` on this file's copy of that
  stub. Every op, streaming, malformed input and a disconnect mid-frame,
  the ``rpc_sever`` fault (armed in the server's package) closing a stream
  whose result stays fetchable, a severed stream that must not wedge its
  producer, a stream reader that honours its client's ``max_frame``, and
  digest-only resubmission with the ``need_model`` fallback.

Every socket here has a timeout of its own.
"""

import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from gibbs_student_t_tpu.serve import faults as jax_faults
from gibbs_student_t_tpu.serve import rpc as jax_rpc
from gibbs_student_t_tpu.serve.scheduler import (
    TenantRequest as JaxRequest,
)
from gibbs_student_t_tpu_torch.serve import faults as port_faults
from gibbs_student_t_tpu_torch.serve import rpc as port_rpc
from gibbs_student_t_tpu_torch.serve.scheduler import TenantRequest
from test_rpc import _StubServer as _JaxStubServer

SOCK_S = 10.0

PKG = {"port": (port_rpc, port_faults, TenantRequest),
       "jax": (jax_rpc, jax_faults, JaxRequest)}


# --- the frame codec ---------------------------------------------------------

def _bodies():
    rng = np.random.default_rng(7)
    return {
        "json_only": {"op": "status", "n": 3, "f": 1.5, "none": None,
                      "flag": True, "s": "café", "nested":
                      {"l": [1, [2, {"x": None}]], "e": {}}},
        "scalars": {"op": "x", "f64": np.float64(2.25),
                    "i32": np.int32(-4), "u8": np.uint8(7),
                    "b": np.bool_(True)},
        "dtypes": {"op": "x", **{
            f"a_{dt}": (rng.standard_normal(12) * 100).astype(dt).reshape(
                3, 4)
            for dt in ("float32", "float64", "float16", "int64", "int32",
                       "int8", "uint8", "uint16", "complex64")},
            "bool": rng.random((2, 5)) > 0.5},
        "shapes": {"op": "x", "zero_d": np.array(3.5, np.float32),
                   "empty": np.zeros((0, 3), np.float64),
                   "empty_1d": np.zeros(0, np.int64),
                   "three_d": np.arange(24, dtype=np.float32).reshape(
                       2, 3, 4),
                   "fortran": np.asfortranarray(
                       np.arange(6, dtype=np.float64).reshape(2, 3)),
                   "strided": np.arange(20, dtype=np.int32)[::3]},
        "nested": {"op": "chunk", "sweep_end": 25, "records": {
            "x": rng.standard_normal((5, 16, 3)).astype(np.float32),
            "z": (rng.random((5, 16, 130)) > 0.9).astype(np.uint8),
            "deep": [{"y": np.ones((2, 2), np.float64)},
                     np.arange(3, dtype=np.uint8), np.float64(1.0)]}},
        "big_endian": {"op": "x", "be": np.arange(5, dtype=">f8")},
    }


BODIES = _bodies()


def _split(data: bytes):
    magic, ver, kind, length = port_rpc._HEADER.unpack(
        data[:port_rpc._HEADER.size])
    assert magic == port_rpc.MAGIC and length == len(data) - 8
    return kind, data[port_rpc._HEADER.size:]


def _same(a, b, path="$"):
    """Decoded bodies equal: arrays in dtype, shape and bytes."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
        return
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
        return
    assert a == b and type(a) is type(b), path


@pytest.mark.parametrize("name", list(BODIES))
def test_frames_byte_identical_to_jax(name):
    body = BODIES[name]
    ours, theirs = port_rpc.encode_frame(body), jax_rpc.encode_frame(body)
    assert ours == theirs
    kind, payload = _split(ours)
    assert kind == (b"j" if name in ("json_only", "scalars") else b"m")
    # each package decodes the other's frame, to the same body
    mine = port_rpc.decode_payload(kind, payload)
    _same(mine, jax_rpc.decode_payload(kind, payload))
    for k, v in body.items():
        if isinstance(v, np.ndarray):
            # a 0-d array travels as shape (1,) (np.ascontiguousarray)
            assert mine[k].dtype == v.dtype
            assert mine[k].shape == (v.shape or (1,))
            assert np.array_equal(mine[k].reshape(v.shape), v)


def test_frame_roundtrip_json_arrays_pickles():
    body = {
        "op": "x", "n": 3, "f": 1.5, "none": None, "flag": True,
        "arr_f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "arr_i64": np.array([[1, -2], [3, 4]], np.int64),
        "blob": port_rpc.Pickled({"k": np.ones(5), "s": "v"}),
        "nested": [{"deep": np.arange(3, dtype=np.uint8)},
                   np.float64(2.25)],
    }
    for dec in (port_rpc, jax_rpc):
        back = dec.decode_payload(*_split(port_rpc.encode_frame(body)))
        assert back["op"] == "x" and back["n"] == 3 and back["none"] is None
        assert back["arr_f32"].dtype == np.float32
        assert np.array_equal(back["arr_f32"], body["arr_f32"])
        assert np.array_equal(back["arr_i64"], body["arr_i64"])
        assert np.array_equal(back["blob"]["k"], np.ones(5))
        assert back["blob"]["s"] == "v"
        assert np.array_equal(back["nested"][0]["deep"],
                              np.arange(3, dtype=np.uint8))
        assert back["nested"][1] == 2.25


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the observation
        return type(e).__name__, str(e)
    return None


def _malformed(mod):
    bad = {"__buffers__": [["<f4", [64], 256]], "a": {"$nd": 0}}
    jb = json.dumps(bad).encode()
    pkl = {"__buffers__": [[None, None, 2]], "a": {"$nd": 0}}
    jp = json.dumps(pkl).encode()
    cases = [
        (b"m", b"\x00\x00\x00\xffxx"),
        (b"m", b"\x00\x00"),
        (b"q", b"{}"),
        (b"j", b"[1,2]"),
        (b"m", struct.pack(">I", 2) + b"[]"),
        (b"m", struct.pack(">I", 26) + b'{"a":{"$nd":7},"op":"x"}  '),
        (b"m", struct.pack(">I", len(jb)) + jb + b"xx"),
        (b"m", struct.pack(">I", len(jp)) + jp + b"xx"),
    ]
    return [_raised(lambda k=k, p=p: mod.decode_payload(k, p))
            for k, p in cases]


def test_malformed_frames_raise_as_in_jax():
    got = _malformed(port_rpc)
    assert got == _malformed(jax_rpc)
    assert all(g is not None and g[0] == "FrameError" for g in got)
    assert "JSON length" in got[0][1] and "kind" in got[2][1]
    assert "not a JSON object" in got[3][1] and "dangling" in got[5][1]
    assert "overruns" in got[6][1] and "dangling" in got[7][1]


def _env_view(mod, monkeypatch):
    seen = []
    for v in ("bogus", "-3", "0", "1.5", "", "4096"):
        monkeypatch.setenv("GST_RPC_MAX_FRAME", v)
        seen.append(_raised(mod.rpc_max_frame_env) or
                    mod.rpc_max_frame_env())
    monkeypatch.delenv("GST_RPC_MAX_FRAME")
    seen.append(mod.rpc_max_frame_env())
    return seen


def test_max_frame_env_validation(monkeypatch):
    got = _env_view(port_rpc, monkeypatch)
    assert got == _env_view(jax_rpc, monkeypatch)
    assert all(g[0] == "ValueError" and "GST_RPC_MAX_FRAME" in g[1]
               for g in got[:5])
    assert got[5:] == [4096, 256 * 1024 * 1024]


@pytest.mark.parametrize("sender,receiver", [("port", "port"),
                                             ("port", "jax"),
                                             ("jax", "port")])
def test_oversized_and_truncated_frames_rejected(sender, receiver):
    snd, rcv = PKG[sender][0], PKG[receiver][0]
    a, b = socket.socketpair()
    a.settimeout(SOCK_S)
    b.settimeout(SOCK_S)
    try:
        big = {"op": "x", "arr": np.zeros(100000, np.float64)}
        with pytest.raises(snd.FrameError, match="exceeds"):
            snd.send_frame(a, big, max_frame=1024)
        # a header declaring more than the ceiling is rejected before any
        # payload is read
        a.sendall(port_rpc._HEADER.pack(port_rpc.MAGIC, b"\x01", b"j",
                                        1 << 30))
        with pytest.raises(rcv.FrameError, match="ceiling"):
            rcv.recv_frame(b, max_frame=1024)
        # a frame under the ceiling crosses; a bad version does not
        snd.send_frame(a, {"op": "ok", "v": np.arange(3)}, max_frame=1024)
        assert np.array_equal(rcv.recv_frame(b, max_frame=1024)["v"],
                              np.arange(3))
        a.sendall(port_rpc._HEADER.pack(port_rpc.MAGIC, b"\x02", b"j", 0))
        with pytest.raises(rcv.FrameError, match="version"):
            rcv.recv_frame(b)
        # truncated: the peer hangs up mid-frame
        data = snd.encode_frame({"op": "x", "a": np.ones(64)})
        a.sendall(data[:len(data) // 2])
        a.close()
        with pytest.raises(rcv.FrameError, match="mid-frame"):
            rcv.recv_frame(b)
        with pytest.raises(ConnectionError):
            rcv.recv_frame(b)
    finally:
        a.close()
        b.close()


# --- request bodies ----------------------------------------------------------

def _warm(pkg, which):
    if pkg == "port":
        from gibbs_student_t_tpu_torch.serve.warm import (
            WarmStartFit,
            WarmStartSpec,
        )
    else:
        from gibbs_student_t_tpu.serve.warm import (
            WarmStartFit,
            WarmStartSpec,
        )
    if which == "spec":
        return WarmStartSpec(pilot_sweeps=12, pilot_chains=3,
                             burn_frac=0.25)
    if which == "fit":
        return WarmStartFit(means=np.zeros((2, 3)), stds=np.ones((2, 3)),
                            weights=np.array([0.25, 0.75]),
                            pilot_sweeps=12, pilot_chains=3)
    return {"kind": "gmm", "means": [[0.0, 1.0]], "stds": [[1.0, 2.0]],
            "weights": [1.0]}


def _monitor(pkg, **kw):
    if pkg == "port":
        from gibbs_student_t_tpu_torch.serve.monitor import MonitorSpec
    else:
        from gibbs_student_t_tpu.serve.monitor import MonitorSpec
    return MonitorSpec(**kw)


REQUESTS = {
    "defaults": lambda pkg: {},
    "scalars": lambda pkg: dict(
        niter=50, nchains=40, seed=123, start_sweep=25, spool_dir="/x/s",
        name="té", on_divergence="quarantine", on_converged="evict",
        resume_spool=True, trace_id="tr-1", priority=0,
        deadline_sweeps=75),
    "x0": lambda pkg: dict(x0=np.linspace(-1, 1, 12).reshape(4, 3)),
    "monitor": lambda pkg: dict(monitor=_monitor(
        pkg, params=[0, 2], ess_target=50.0, rhat_target=1.1, every=2,
        min_rows=16)),
    "monitor_defaults": lambda pkg: dict(monitor=_monitor(pkg)),
    "warm_spec": lambda pkg: dict(warm_start=_warm(pkg, "spec")),
    "warm_fit": lambda pkg: dict(warm_start=_warm(pkg, "fit")),
    "warm_dict": lambda pkg: dict(warm_start=_warm(pkg, "dict")),
    "streamed": lambda pkg: dict(on_chunk=lambda h, s, r: None),
}


@pytest.mark.parametrize("name", list(REQUESTS))
def test_request_body_matches_jax(name):
    """The submit body of the same request from each package: equal field
    by field, and byte for byte once encoded (model left out, digest
    given); each package's server rebuilds the other's request."""
    kw_p, kw_j = REQUESTS[name]("port"), REQUESTS[name]("jax")
    base = dict(ma={"m": 1}, niter=10, nchains=4)
    rp = TenantRequest(**{**base, **kw_p})
    rj = JaxRequest(**{**base, **kw_j})
    bp = port_rpc._request_body(rp, include_model=False, digest="d0")
    bj = jax_rpc._request_body(rj, include_model=False, digest="d0")
    assert list(bp) == list(bj)
    for k in bp:
        _same(json.loads(json.dumps(bp[k], default=str)) if not isinstance(
            bp[k], np.ndarray) else bp[k],
            json.loads(json.dumps(bj[k], default=str)) if not isinstance(
                bj[k], np.ndarray) else bj[k], k)
    assert port_rpc.encode_frame(bp) == jax_rpc.encode_frame(bj)
    # with the model: the same frame but for the pickled model's bytes
    fp = port_rpc.encode_frame(port_rpc._request_body(rp))
    fj = jax_rpc.encode_frame(jax_rpc._request_body(rj))
    jp = json.loads(_split(fp)[1][4:4 + struct.unpack(">I",
                                                       _split(fp)[1][:4])[0]])
    jj = json.loads(_split(fj)[1][4:4 + struct.unpack(">I",
                                                       _split(fj)[1][:4])[0]])
    assert jp["__buffers__"][1:] == jj["__buffers__"][1:]
    jp["__buffers__"][0][2] = jj["__buffers__"][0][2] = 0
    assert jp == jj
    # each side's server rebuilds the other's body
    for mod, body, want in ((port_rpc, bj, rj), (jax_rpc, bp, rp)):
        back = mod._request_from_body(dict(body, ma={"m": 1}))
        for f in ("niter", "nchains", "seed", "start_sweep", "spool_dir",
                  "name", "on_divergence", "on_converged", "resume_spool",
                  "trace_id", "priority", "deadline_sweeps"):
            assert getattr(back, f) == getattr(want, f), f
        assert (back.x0 is None) == (want.x0 is None)
        if want.x0 is not None:
            assert np.array_equal(back.x0, np.asarray(want.x0))
        assert (back.monitor is None) == (want.monitor is None)
        if want.monitor is not None:
            for f in ("params", "ess_target", "rhat_target", "every",
                      "min_rows"):
                assert getattr(back.monitor, f) == getattr(want.monitor, f)


def test_request_body_port_additions_and_refusals():
    """A flow spec's ``kind`` and ``adapt_scan`` ride the port's body (the
    JAX body drops both); a request's ``state`` never rides a frame."""
    from gibbs_student_t_tpu_torch.serve.adapt import AdaptScanSpec
    from gibbs_student_t_tpu_torch.serve.warm import WarmStartSpec

    req = TenantRequest(ma={"m": 1}, niter=10, nchains=4, monitor=_monitor(
        "port", ess_target=10.0), warm_start=WarmStartSpec(kind="flow"),
        adapt_scan=AdaptScanSpec(ess_target=20.0, floor=0.25))
    body = port_rpc._request_body(req, include_model=False)
    assert body["warm_start"]["spec"]["kind"] == "flow"
    assert body["adapt_scan"] == {"ess_target": 20.0, "floor": 0.25}
    back = port_rpc._request_from_body(
        port_rpc.decode_payload(*_split(port_rpc.encode_frame(
            dict(body, ma=port_rpc.Pickled({"m": 1}))))))
    assert back.warm_start == WarmStartSpec(kind="flow")
    assert back.adapt_scan == AdaptScanSpec(ess_target=20.0, floor=0.25)
    # the JAX server reads the port's body, less the additions
    jback = jax_rpc._request_from_body(dict(body, ma={"m": 1}))
    assert jback.warm_start.pilot_sweeps == 64
    with pytest.raises(ValueError, match="cannot ride"):
        port_rpc._request_body(TenantRequest(ma={"m": 1}, niter=10,
                                             state=object()))
    with pytest.raises(ValueError, match="cannot ride the wire"):
        port_rpc._request_body(TenantRequest(ma={"m": 1}, niter=10,
                                             warm_start=object()))


def test_warm_start_rides_the_wire():
    from gibbs_student_t_tpu_torch.serve.warm import (
        WarmStartFit,
        WarmStartSpec,
    )

    spec = WarmStartSpec(pilot_sweeps=12, pilot_chains=3, burn_frac=0.25)
    req = TenantRequest(ma={"m": 1}, niter=5, nchains=4, name="w",
                        warm_start=spec)
    body = port_rpc._request_body(req)
    req2 = port_rpc._request_from_body(dict(body, ma={"m": 1}))
    assert isinstance(req2.warm_start, WarmStartSpec)
    assert req2.warm_start.pilot_sweeps == 12
    assert req2.warm_start.burn_frac == 0.25
    # a journaled fit passes through as its JSON dict (staging rebuilds it:
    # the recovery replay path)
    fit = WarmStartFit(means=np.zeros((1, 2)), stds=np.ones((1, 2)),
                       weights=np.ones(1))
    req3 = TenantRequest(ma={"m": 1}, niter=5, nchains=4, name="f",
                         warm_start=fit)
    req4 = port_rpc._request_from_body(dict(port_rpc._request_body(req3),
                                            ma={"m": 1}))
    assert isinstance(req4.warm_start, dict)
    assert req4.warm_start["kind"] == "gmm"


def _error_bodies(pkg):
    mod = PKG[pkg][0]
    if pkg == "port":
        from gibbs_student_t_tpu_torch.serve.scheduler import (
            DeadlineExceeded,
            RetryAfter,
            TenantError,
        )
    else:
        from gibbs_student_t_tpu.serve.scheduler import (
            DeadlineExceeded,
            RetryAfter,
            TenantError,
        )
    te = TenantError(3, reason="boom", where="spool",
                     cause=OSError("disk full"), partial=None)
    de = DeadlineExceeded(4, 100, 50, partial=None)
    ra = RetryAfter("admission queue full", retry_after_s=1.5,
                    queue_depth=7, tier=2)
    return ([mod._tenant_error_body(e) for e in (te, de)]
            + [mod._retry_after_body(ra)]), mod


def _error_view(err):
    return (type(err).__name__, str(err),
            {k: getattr(err, k, None) for k in (
                "tenant_id", "reason", "where", "deadline_sweep",
                "served_sweeps", "retry_after_s", "queue_depth", "tier")})


def test_error_bodies_match_jax_and_cross_decode():
    """Tenant errors, deadlines and sheds: the same frame bytes from both
    packages, rebuilt as the same structured type by either."""
    bp, mp = _error_bodies("port")
    bj, mj = _error_bodies("jax")
    for a, b in zip(bp, bj):
        if "partial" in a:
            a, b = dict(a, partial=None), dict(b, partial=None)
        assert port_rpc.encode_frame(a) == jax_rpc.encode_frame(b)
    for enc, dec in ((mp, mj), (mj, mp), (mp, mp)):
        bodies, _ = _error_bodies("port" if enc is mp else "jax")
        errs_here = [dec._tenant_error_from_body(dict(b, partial=None))
                     for b in bodies[:2]]
        errs_here.append(dec._rejected_error(bodies[2]))
        assert [_error_view(e) for e in errs_here] == [
            _error_view(e) for e in
            [mj._tenant_error_from_body(dict(b, partial=None))
             for b in bj[:2]] + [mj._rejected_error(bj[2])]]
    assert isinstance(mp._rejected_error({"op": "rejected",
                                          "error": "x"}), RuntimeError)


# --- the RPC edge on stub servers --------------------------------------------

class _StubHandle:
    def __init__(self, tenant_id, request):
        self.tenant_id = tenant_id
        self.request = request
        self._done = threading.Event()
        self._result = None

    def progress(self):
        return {"tenant_id": self.tenant_id, "status":
                ("done" if self._done.is_set() else "running"),
                "name": self.request.name}

    def cost(self):
        return {"device_ms": 1.25, "lane_quanta": 4,
                "ess_per_core_s": None}

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        if not self._done.wait(timeout if timeout is not None else 30):
            raise TimeoutError("stub tenant not done")
        return self._result

    def _finish(self, res):
        self._result = res
        self._done.set()


class _StubServer:
    """The port's copy of the JAX test's stub: a duck-typed ChainServer
    (``submit``/``cancel``/``status``/``healthz``/``_handles``, and
    ``_trace_doc``). ``chunks`` > 0 makes submit serve that many
    ``on_chunk`` callbacks from a thread of its own, then finish."""

    def __init__(self, chunks=0):
        self._handles = {}
        self._next = 0
        self.chunks = chunks
        self.cancelled = []

    def submit(self, request, timeout=None):
        h = _StubHandle(self._next, request)
        self._handles[h.tenant_id] = h
        self._next += 1

        def run():
            for i in range(self.chunks):
                if request.on_chunk is not None:
                    request.on_chunk(
                        h, (i + 1) * 5,
                        {"x": np.full((5, 2), i, np.float32)})
            h._finish({"rows": self.chunks * 5,
                       "seed": request.seed})

        threading.Thread(target=run, daemon=True).start()
        return h

    def cancel(self, h):
        self.cancelled.append(h.tenant_id)
        return True

    def status(self):
        return {"schema": 1, "queue_depth": 0, "tenants": []}

    def healthz(self):
        return {"ok": True}

    def reset_counters(self):
        self.reset = True

    def _trace_doc(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}


class _JaxStub(_JaxStubServer):
    """The JAX test's stub with the trace document the ``trace`` op
    reads."""

    def _trace_doc(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}


STUBS = {"port": _StubServer, "jax": _JaxStub}
PAIRS = [("port", "port"), ("port", "jax"), ("jax", "port")]
PAIR_IDS = [f"{c}-client-{s}-server" for c, s in PAIRS]


class Wire:
    """One pairing: the client's package, the server's package and stub."""

    def __init__(self, client, server, chunks=2, **rpc_kw):
        self.cmod, _, self.Request = PKG[client]
        self.smod, self.sfaults, _ = PKG[server]
        self.stub = STUBS[server](chunks=chunks)
        self.rpc = self.smod.RpcServer(self.stub, **rpc_kw)
        self.cli = self.client()

    def client(self, **kw):
        kw.setdefault("timeout", SOCK_S)
        return self.cmod.RemoteChainServer(self.rpc.address, **kw)

    def close(self):
        self.cli.close()
        self.rpc.close()


@pytest.fixture(params=PAIRS, ids=PAIR_IDS)
def wire(request):
    w = Wire(*request.param)
    yield w
    w.close()


def test_rpc_ops_over_stub(wire):
    stub, cli = wire.stub, wire.cli
    req = wire.Request(ma={"m": 1}, niter=10, nchains=4, seed=7, name="tA")
    h = cli.submit(req)
    assert h.result(timeout=SOCK_S) == {"rows": 10, "seed": 7}
    assert h.done() and h.status == "done"
    assert h.progress()["status"] == "done"
    assert h.cost()["lane_quanta"] == 4
    assert cli.status()["schema"] == 1
    assert cli.healthz()["ok"] is True
    t0, ts, t1 = cli.server_time()
    assert t0 - 1.0 <= ts <= t1 + 1.0
    assert cli.trace()["displayTimeUnit"] == "ms"
    assert h.cancel() is True and stub.cancelled == [h.tenant_id]
    cli.reset_counters()
    assert getattr(stub, "reset", False) is True
    # a name looks a tenant up too (the latest submission wins)
    assert cli._call({"op": "progress", "tenant": "tA"})["progress"][
        "tenant_id"] == h.tenant_id
    # unknown tenant and unknown op answer error frames, not hangs
    with pytest.raises(wire.cmod.RpcError, match="unknown tenant"):
        cli._call({"op": "progress", "tenant": 999})
    with pytest.raises(wire.cmod.RpcError, match="unknown op"):
        cli._call({"op": "frobnicate"})
    # shutdown without a callback is an error, never an exit
    with pytest.raises(wire.cmod.RpcError, match="shutdown not armed"):
        cli.shutdown()


def test_rpc_shutdown_callback(wire):
    """The ``shutdown`` op answers, calls the server's callback and closes
    the connection."""
    fired = threading.Event()
    rpc = wire.smod.RpcServer(wire.stub, on_shutdown=fired.set)
    try:
        wire.cmod.RemoteChainServer(rpc.address, timeout=SOCK_S).shutdown()
        assert fired.wait(SOCK_S)
    finally:
        rpc.close()


def test_rpc_streaming_chunks_over_stub(wire):
    got = []

    def on_chunk(h, sweep_end, records):
        got.append((sweep_end, records["x"].copy()))

    h = wire.cli.submit(wire.Request(ma={"m": 1}, niter=10, nchains=4,
                                     seed=3, name="tS", on_chunk=on_chunk))
    res = h.result(timeout=SOCK_S)
    assert res["seed"] == 3
    assert [s for s, _ in got] == [5, 10]
    assert got[0][1].dtype == np.float32
    assert np.array_equal(got[1][1], np.full((5, 2), 1, np.float32))


def test_malformed_and_disconnect_contained(wire):
    port = wire.rpc.port
    # garbage magic: one error frame, then the server closes
    s = socket.create_connection(("127.0.0.1", port), timeout=SOCK_S)
    s.settimeout(SOCK_S)
    s.sendall(b"XX" + b"\x00" * 30)
    reply = wire.cmod.recv_frame(s)
    assert reply["op"] == "error" and "bad frame" in reply["error"]
    try:
        assert s.recv(1) == b""
    except ConnectionResetError:
        pass  # RST instead of FIN: unread garbage was still buffered
    s.close()
    # disconnect mid-frame (the header promises more than is sent)
    s2 = socket.create_connection(("127.0.0.1", port), timeout=SOCK_S)
    s2.sendall(port_rpc._HEADER.pack(port_rpc.MAGIC, b"\x01", b"j", 100)
               + b"{}")
    s2.close()
    time.sleep(0.05)
    # the server survives and answers the next connection
    assert wire.cli.healthz()["ok"] is True


def test_rpc_sever_closes_stream_and_result_survives(wire):
    """A severed stream resolves the client's handle to a ConnectionError,
    and since the server kept serving, the result is fetchable over a new
    connection by tenant id. The point's traversals: the submit request,
    then each chunk, so ``after=2`` severs at the second chunk."""
    got = []
    f = wire.sfaults
    with f.inject(f.FaultSpec("rpc_sever", tenant="tV", after=2)):
        h = wire.cli.submit(wire.Request(
            ma={"m": 1}, niter=10, nchains=4, seed=5, name="tV",
            on_chunk=lambda hh, s, r: got.append(s)))
        with pytest.raises(ConnectionError, match="severed"):
            h.result(timeout=SOCK_S)
    assert f.fired_counts()[("rpc_sever", "tV")] == 1
    assert got == [5]
    h2 = wire.cmod.RemoteTenantHandle(wire.cli, h.tenant_id, h.request)
    assert h2.result(timeout=SOCK_S)["seed"] == 5


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_severed_stream_detaches_server_callback(pair):
    """A connection that dies mid-stream detaches the server's
    ``on_chunk``: with more chunks than queue slots the producer (a real
    pool's drain thread) finishes, and the result stays fetchable."""
    w = Wire(*pair, chunks=30, chunk_queue=4)
    f = w.sfaults
    try:
        with f.inject(f.FaultSpec("rpc_sever", tenant="tW", after=1)):
            h = w.cli.submit(w.Request(
                ma={"m": 1}, niter=10, nchains=4, seed=11, name="tW",
                on_chunk=lambda hh, s, r: None))
            with pytest.raises(ConnectionError, match="severed"):
                h.result(timeout=SOCK_S)
        h2 = w.cmod.RemoteTenantHandle(w.cli, h.tenant_id, h.request)
        assert h2.result(timeout=SOCK_S)["seed"] == 11
    finally:
        w.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_stream_reader_honors_client_max_frame(pair, monkeypatch):
    """A client made with an explicit frame ceiling applies it to streamed
    chunk and result frames too, not the environment's default."""
    monkeypatch.setenv("GST_RPC_MAX_FRAME", "2048")
    big = 8 * 1024 * 1024
    w = Wire(*pair, chunks=2, max_frame=big)
    stub_submit = w.stub.submit

    def submit_big(request, timeout=None):
        orig = request.on_chunk

        def wrap(h, s, r):
            orig(h, s, {"x": np.zeros((5, 2048), np.float32)})

        request.on_chunk = wrap if orig is not None else None
        return stub_submit(request, timeout)

    w.stub.submit = submit_big
    cli = w.client(max_frame=big)
    got = []
    try:
        h = cli.submit(w.Request(
            ma={"m": 1}, niter=10, nchains=4, seed=13, name="tF",
            on_chunk=lambda hh, s, r: got.append(r["x"].shape)))
        assert h.result(timeout=SOCK_S)["seed"] == 13
        assert got == [(5, 2048), (5, 2048)]
        # the environment's ceiling severs the same stream
        small = w.client()
        h3 = small.submit(w.Request(
            ma={"m": 1}, niter=10, nchains=4, seed=14, name="tG",
            on_chunk=lambda hh, s, r: None))
        with pytest.raises(ConnectionError, match="severed"):
            h3.result(timeout=SOCK_S)
    finally:
        cli.close()
        w.close()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_model_digest_negotiation_over_stub(pair):
    """The same model submitted twice: the second submit sends only its
    digest (fewer bytes on the wire). A client that wrongly believes the
    server holds a digest recovers through ``need_model``."""
    w = Wire(*pair, chunks=0)
    seen = []
    orig = w.stub.submit

    def spy(request, timeout=None):
        seen.append(request.ma)
        return orig(request, timeout)

    w.stub.submit = spy
    sent = []
    plain_send = w.cmod.send_frame

    def counting_send(sock, body, max_frame=None):
        if body.get("op") == "submit":
            sent.append(len(w.cmod.encode_frame(body)))
        return plain_send(sock, body, max_frame)

    try:
        ma = {"data": np.arange(400).tolist()}
        req = w.Request(ma=ma, niter=5, nchains=4, name="m1")
        w.cmod.send_frame = counting_send
        w.cli.submit(req)
        w.cli.submit(req)          # digest hit: the model is not re-sent
        assert len(seen) == 2 and seen[0] == ma and seen[1] == ma
        assert len(w.cli._server_has) == 1
        assert sent[1] < sent[0] - 1000
        cl2 = w.client()
        d = cl2._digest_of(ma)
        with w.rpc._model_lock:
            w.rpc._model_cache.clear()    # force the miss
        cl2._server_has.add(d)
        cl2.submit(req)
        assert len(seen) == 3 and seen[2] == ma
        # a streamed submit falls back on its own connection
        with w.rpc._model_lock:
            w.rpc._model_cache.clear()
        hs = cl2.submit(w.Request(ma=ma, niter=5, nchains=4, name="m2",
                                  on_chunk=lambda hh, s, r: None))
        assert hs.result(timeout=SOCK_S)["rows"] == 0
        assert len(seen) == 4 and seen[3] == ma
    finally:
        w.cmod.send_frame = plain_send
        w.close()


def test_model_cache_is_lru_capped():
    stub = _StubServer()
    rpc = port_rpc.RpcServer(stub, model_cache=2)
    cli = port_rpc.RemoteChainServer(rpc.address, timeout=SOCK_S)
    try:
        mas = [{"k": i} for i in range(3)]
        for ma in mas:
            cli.submit(TenantRequest(ma=ma, niter=5, nchains=4))
        with rpc._model_lock:
            held = list(rpc._model_cache)
        assert held == [cli._digest_of(m) for m in mas[1:]]
    finally:
        rpc.close()

"""The wire for one pool, on real port servers on the CPU (the 5-component
demo model, 32 lanes, quantum 5, plain versions).

- the kernels' build across processes: two processes that find no
  matching stamp build at once through a stand-in ``nvcc`` (a small
  Python script that writes its output and logs each call): the sources
  compile once, both processes end with the same library and a stamp that
  matches, and no per-process object or temporary file is left;
- the RPC edge on a live server, on each executor: a remote tenant,
  streamed and not, is bitwise the same request submitted in process, its
  chunk frames arrive one per quantum and concatenate to its chain;
  progress, cost, status and healthz answer over the wire, a queued
  tenant cancelled over the wire resolves as cancelled, and a
  structurally bad model is rejected while the pool serves on;
- the HTTP endpoints: ``ObsHttpServer`` as a unit (routes, 503, 404 for a
  missing callback, 500 and one warning for a raising one, idempotent
  close), and on live servers: ``/status`` read during the same tenant
  script from the port's server and the JAX server has the same key tree
  (less the listed keys of test_torch_serve_obs.py), ``/metrics`` parses
  as Prometheus text, ``/tenants/<name>/progress`` is the handle's
  ``progress()``, ``/trace`` and ``/postmortem`` are the in-memory forms
  of what ``export_trace`` and ``dump_postmortem`` write;
- ``trace_id``: it tags every span of its tenant and only those, rides
  ``progress()`` and the manifest, and ``recover`` restores it; chains are
  bitwise with and without it;
- ``pool_main`` as a subprocess: ``ready.json``'s keys are the JAX
  worker's less the compile registry's entries, a tenant submitted to the
  worker is bitwise the in-process one, ``shutdown`` over the wire exits
  0, a worker spawned without CUDA exits non-zero without a
  ``ready.json``, and a worker killed by ``pool_kill`` mid-run, followed
  by a ``--recover`` worker, returns both spooled tenants bitwise their
  uninterrupted runs.

Every socket, subprocess and run has a timeout of its own.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.obs import schema as port_schema
from gibbs_student_t_tpu_torch.obs.http import ObsHttpServer
from gibbs_student_t_tpu_torch.ops import _cuda
from gibbs_student_t_tpu_torch.serve import (
    ChainServer,
    RemoteChainServer,
    RpcServer,
    TenantRequest,
)
from gibbs_student_t_tpu_torch.serve.manifest import read_manifest
from gibbs_student_t_tpu_torch.serve.pool_main import write_spec
from gibbs_student_t_tpu_torch.serve.rpc import RemoteTenantHandle

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("chain", "bchain", "zchain", "thetachain", "alphachain",
          "poutchain", "dfchain")
EXECUTORS = [False, True]
IDS = ["serial", "pipelined"]
RUN_TIMEOUT_S = 180.0
SOCK_S = 30.0
PROC_S = 120.0
Q = 5
POOL_KW = dict(nlanes=32, quantum=Q, record="full")


# --- helpers -----------------------------------------------------------------

def _drive(srv, on_quantum=None):
    """``srv.run()`` on a thread of its own; fails when it does not end in
    time, and re-raises what it raised."""
    box = []

    def target():
        try:
            srv.run(on_quantum=on_quantum)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box.append(e)

    th = threading.Thread(target=target, daemon=True)
    th.start()
    th.join(RUN_TIMEOUT_S)
    if th.is_alive():
        srv._stop.set()
        th.join(10.0)
        pytest.fail(f"the server's run did not end in {RUN_TIMEOUT_S} s")
    if box:
        raise box[0]


def _bitwise(got, want):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    for k in ("acc_white", "acc_hyper"):
        np.testing.assert_array_equal(got.stats[k], want.stats[k],
                                      err_msg=k)


def _get(url, timeout=SOCK_S):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def demo():
    return make_demo_model_arrays(components=5), GibbsConfig(model="mixture")


def _server(demo, pipeline=False, **kw):
    ma, cfg = demo
    return ChainServer(ma, cfg, device="cpu", pipeline=pipeline,
                       **POOL_KW, **kw)


def _req(demo, name, seed, niter=10, **kw):
    return TenantRequest(ma=demo[0], niter=niter, nchains=16, seed=seed,
                         name=name, **kw)


@pytest.fixture(scope="module")
def refs(demo):
    """In-process results, serial: tenants of seeds 4 (10 sweeps) and 7, 8
    (20 sweeps)."""
    srv = _server(demo)
    hs = {4: srv.submit(_req(demo, "r4", 4)),
          7: srv.submit(_req(demo, "r7", 7, niter=20)),
          8: srv.submit(_req(demo, "r8", 8, niter=20))}
    try:
        _drive(srv)
    finally:
        srv.close()
    return {k: h.result(timeout=0) for k, h in hs.items()}


# --- the kernels' build across processes -------------------------------------

_STANDIN = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open(os.environ["GST_TEST_NVCC_LOG"], "a") as fh:
    fh.write(("link " if "-shared" in args else "compile ")
             + os.path.basename(out) + " " + str(os.getppid()) + "\\n")
time.sleep(0.5)
if "-shared" in args:
    data = b"".join(open(a, "rb").read() for a in args if a.endswith(".o"))
else:
    data = open(args[args.index("-c") + 1], "rb").read()[:256]
with open(out, "wb") as fh:
    fh.write(data)
"""

_BUILD_PROC = """
import json, os, sys, time
sys.path.insert(0, {repo!r})
from gibbs_student_t_tpu_torch.ops import _cuda
_cuda.BUILD = {build!r}
_cuda._nvcc = lambda: {nvcc!r}
open({ready!r}, "w").close()
t_end = time.monotonic() + 60
while not os.path.exists({go!r}) and time.monotonic() < t_end:
    time.sleep(0.005)
path = _cuda.build()
print(json.dumps({{"path": path, "how": _cuda.last_build,
                   "hash": _cuda._hash(), "pid": os.getpid()}}))
"""


def test_build_is_safe_across_processes(tmp_path):
    """Two processes build at once: one compiles (each source once, then
    one link), the other waits on the lock and loads what it built."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_STANDIN.format(python=sys.executable))
    nvcc.chmod(0o755)
    build, log = tmp_path / "build", tmp_path / "nvcc.log"
    go = tmp_path / "go"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["GST_TEST_NVCC_LOG"] = str(log)
    procs, ready = [], []
    for i in range(2):
        ready.append(tmp_path / f"ready{i}")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _BUILD_PROC.format(
                repo=REPO, build=str(build), nvcc=str(nvcc),
                ready=str(ready[i]), go=str(go))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env))
    try:
        t_end = time.monotonic() + PROC_S
        while not all(r.exists() for r in ready):
            assert time.monotonic() < t_end, "the build processes did not start"
            assert all(p.poll() is None for p in procs), \
                [p.communicate() for p in procs]
            time.sleep(0.01)
        go.write_text("")
        outs = [p.communicate(timeout=PROC_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    got = [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]
    assert sorted(g["how"] for g in got) == ["built", "loaded"]
    assert got[0]["path"] == got[1]["path"] == str(build / _cuda.LIB_NAME)
    lines = log.read_text().splitlines()
    sources = _cuda._sources()
    built_by = next(g["pid"] for g in got if g["how"] == "built")
    assert len(lines) == len(sources) + 1
    assert sum(ln.startswith("compile ") for ln in lines) == len(sources)
    assert lines[-1].startswith(f"link {_cuda.LIB_NAME}.{built_by}.tmp")
    assert all(ln.endswith(f" {built_by}") for ln in lines)
    with open(build / (_cuda.LIB_NAME + ".hash")) as fh:
        assert fh.read() == got[0]["hash"] == got[1]["hash"]
    lib = (build / _cuda.LIB_NAME).read_bytes()
    assert lib == b"".join(open(s, "rb").read()[:256] for s in sources)
    assert sorted(os.listdir(build)) == sorted([
        _cuda.LIB_NAME, _cuda.LIB_NAME + ".hash", _cuda.LOCK_NAME,
        "ptxas.txt"])


# --- the RPC edge on a live server -------------------------------------------

@pytest.mark.parametrize("pipeline", EXECUTORS, ids=IDS)
def test_remote_submit_matches_local_bitwise(demo, refs, pipeline):
    """submit/progress/cost/cancel/result over the wire against a real
    pool: a remote tenant, streamed and not, is bitwise the same request
    submitted in process; the wire adds transport, not semantics."""
    srv = _server(demo, pipeline)
    rpc = RpcServer(srv)
    cli = RemoteChainServer(rpc.address, timeout=SOCK_S)
    try:
        chunks = []
        h_local = srv.submit(_req(demo, "L", 4))
        h_stream = cli.submit(_req(demo, "S", 4, on_chunk=lambda h, s, r:
                                   chunks.append((s, dict(r)))))
        h_plain = cli.submit(_req(demo, "P", 4))
        _drive(srv)
        for h in (h_local, h_stream, h_plain):
            _bitwise(h.result(timeout=SOCK_S), refs[4])
        # streamed chunks arrived one per quantum, and they concatenate to
        # the result's chain
        assert [s for s, _ in chunks] == [5, 10]
        assert chunks[0][1]["x"].shape == (5, 16, 3)
        assert np.array_equal(np.concatenate([c["x"] for _, c in chunks]),
                              refs[4].chain)
        # the control surface over the wire
        p = h_plain.progress()
        assert p["status"] == "done" and p["sweeps_done"] == 10
        assert p == srv._handles[h_plain.tenant_id].progress()
        assert h_plain.cost()["lane_quanta"] == 16 * 2
        assert cli.healthz()["ok"] is True
        assert cli.status()["nlanes"] == 32
        # a queued tenant cancelled over the wire rejects its handle
        h_c = cli.submit(_req(demo, "C", 5))
        assert h_c.cancel() is True
        with pytest.raises(RuntimeError, match="cancelled"):
            h_c.result(timeout=SOCK_S)
        # a structurally bad model is rejected; the pool serves on
        bad = make_demo_model_arrays(components=10)
        h_bad = cli.submit(TenantRequest(ma=bad, niter=10, nchains=16,
                                         name="bad"))
        h_ok = cli.submit(_req(demo, "after", 4))
        _drive(srv)
        with pytest.raises(RuntimeError, match="basis size"):
            h_bad.result(timeout=SOCK_S)
        _bitwise(h_ok.result(timeout=SOCK_S), refs[4])
        assert h_bad.status == "rejected"
    finally:
        srv.close()
        rpc.close()
        cli.close()


# --- the HTTP endpoints ------------------------------------------------------

def test_http_server_routes_and_failure_modes():
    """Routing, ephemeral-port bind, 503 healthz, 404 for missing callbacks
    and unknown routes, 500 and one warning for a raising callback,
    idempotent close."""
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        raise RuntimeError("injected handler failure")

    srv = ObsHttpServer(
        port=0,
        status_fn=lambda: {"schema": 1, "fake": True},
        healthz_fn=lambda: {"ok": False, "reason": "draining"},
        postmortem_fn=lambda: {"schema": 1, "reason": "stub"},
        progress_fn=lambda key: ({"tenant_id": 0, "name": key}
                                 if key == "a b" else None),
        metrics_fn=lambda: None,
        trace_fn=boom)
    try:
        assert srv.port > 0
        code, body = _get(srv.url + "/")
        assert code == 200 and "/healthz" in body and "/postmortem" in body
        code, body = _get(srv.url + "/postmortem")
        assert code == 200 and json.loads(body)["reason"] == "stub"
        code, body = _get(srv.url + "/status")
        assert code == 200 and json.loads(body)["fake"] is True
        assert _get(srv.url + "/healthz")[0] == 503
        assert _get(srv.url + "/metrics")[0] == 404     # returned None
        code, body = _get(srv.url + "/tenants/a%20b/progress")
        assert code == 200 and json.loads(body)["name"] == "a b"
        assert _get(srv.url + "/tenants/zz/progress")[0] == 404
        assert _get(srv.url + "/bogus/route")[0] == 404
        with pytest.warns(RuntimeWarning, match="endpoint"):
            code, body = _get(srv.url + "/trace")
        assert code == 500 and "injected" in body
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            code, body = _get(srv.url + "/trace")   # warned once only
        assert code == 500 and calls["n"] == 2
        assert _get(srv.url + "/status")[0] == 200  # still serving
    finally:
        srv.close()
    srv.close()   # idempotent
    with pytest.raises((urllib.error.URLError, OSError)):
        urllib.request.urlopen(srv.url + "/status", timeout=1.0)
    bare = ObsHttpServer(port=0)
    try:
        for route in ("/healthz", "/status", "/trace", "/postmortem",
                      "/tenants/0/progress"):
            assert _get(bare.url + route)[0] == 404, route
    finally:
        bare.close()


def _script(server, req_cls, ma):
    """The tenant script of the live HTTP comparison: two monitored
    tenants; ``/status`` read at the second boundary."""
    from gibbs_student_t_tpu_torch.serve import MonitorSpec

    mon_cls = MonitorSpec
    if not req_cls.__module__.startswith("gibbs_student_t_tpu_torch"):
        from gibbs_student_t_tpu.serve import MonitorSpec as mon_cls
    hs = [server.submit(req_cls(ma=ma, niter=15, nchains=16, seed=i,
                                name=f"t{i}", trace_id=f"tr{i}",
                                monitor=mon_cls(params=[0, 1])))
          for i in range(2)]
    url = f"http://127.0.0.1:{server.http.port}"
    live = {}

    def on_quantum(s):
        if s.quanta == 2 and "status" not in live:
            code, body = _get(url + "/status")
            live["status"] = (code, json.loads(body))
            live["progress"] = _get(url + "/tenants/t0/progress")

    return hs, url, live, on_quantum


@pytest.fixture(scope="module")
def http_runs(demo, tmp_path_factory):
    """The script through the port's server (obs_dir, manifest, spans,
    flight) and the JAX server, each with ``http_port=0`` and its stage
    timers off."""
    from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
    from gibbs_student_t_tpu.data.demo import (
        make_demo_model_arrays as jax_demo_model_arrays,
    )
    from gibbs_student_t_tpu.serve import ChainServer as JaxServer
    from gibbs_student_t_tpu.serve import TenantRequest as JaxRequest

    root = tmp_path_factory.mktemp("http")
    out = {}
    srv = _server(demo, False, http_port=0, obs_dir=str(root / "obs"),
                  manifest_dir=str(root / "man"), kernel_timers=False)
    hs, url, live, oq = _script(srv, TenantRequest, demo[0])
    try:
        _drive(srv, oq)
        reads = {r: _get(url + r) for r in (
            "/healthz", "/metrics", "/trace", "/postmortem",
            "/tenants/t1/progress", "/tenants/1/progress",
            "/tenants/nobody/progress")}
        out["port"] = dict(server=srv, handles=hs, live=live, reads=reads,
                           trace=srv._trace_doc(),
                           results=[h.result(timeout=0) for h in hs],
                           root=root)
        srv._fault_counts["pool_failures"] += 1
        out["port"]["failed_healthz"] = _get(url + "/healthz")
        srv._fault_counts["pool_failures"] -= 1
    finally:
        srv.close()
    out["port"]["closed"] = srv.http is None
    jma = jax_demo_model_arrays(components=5)
    jsrv = JaxServer(jma, JaxConfig(model="mixture"), nlanes=32, quantum=Q,
                     record="full", http_port=0, pipeline=False,
                     obs_dir=str(root / "jobs"), kernel_timers=False)
    hs, url, live, oq = _script(jsrv, JaxRequest, jma)
    try:
        box = []
        th = threading.Thread(target=lambda: box.append(
            jsrv.run(on_quantum=oq)), daemon=True)
        th.start()
        th.join(RUN_TIMEOUT_S)
        assert not th.is_alive(), "the JAX server's run did not end"
        out["jax"] = dict(live=live)
    finally:
        jsrv.close()
    return out


def test_http_status_key_tree_matches_jax(http_runs):
    from test_torch_serve_obs import (
        JAX_ONLY,
        JAX_ONLY_PATHS,
        PORT_ONLY,
        _tree,
    )

    port, jax = http_runs["port"]["live"], http_runs["jax"]["live"]
    assert port["status"][0] == jax["status"][0] == 200
    st = port["status"][1]
    assert st["tenants"] and "trace_id" in st["tenants"][0]
    assert _tree(st, drop_paths=PORT_ONLY) == _tree(
        jax["status"][1], drop=JAX_ONLY, drop_paths=JAX_ONLY_PATHS)
    schemas = port_schema.load_schemas()
    port_schema.assert_valid(st, schemas["serve_status"], "/status",
                             defs=schemas)
    # a tenant's progress read live: the same key tree as the JAX one's
    pp, jp = json.loads(port["progress"][1]), json.loads(jax["progress"][1])
    assert port["progress"][0] == jax["progress"][0] == 200
    assert pp["trace_id"] == jp["trace_id"] == "tr0"
    assert _tree(pp) == _tree(jp)


_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r',?)*\})? (NaN|[+-]Inf|-?[0-9.eE+-]+)( -?[0-9]+)?$')


def test_http_endpoints_on_a_live_server(http_runs):
    run = http_runs["port"]
    reads, srv = run["reads"], run["server"]
    schemas = port_schema.load_schemas()
    code, body = reads["/healthz"]
    assert code == 200 and json.loads(body)["ok"] is True
    port_schema.assert_valid(json.loads(body), schemas["healthz"],
                             "/healthz", defs=schemas)
    assert run["failed_healthz"][0] == 503
    code, text = reads["/metrics"]
    assert code == 200
    lines = [ln for ln in text.splitlines() if ln]
    assert all(ln.startswith(("# HELP ", "# TYPE ")) or _PROM_LINE.match(ln)
               for ln in lines), [ln for ln in lines if not (
                   ln.startswith("#") or _PROM_LINE.match(ln))]
    assert "# TYPE gst_serve_admissions counter" in text
    assert re.search(r"^gst_serve_admissions 2\.0 \d+$", text, re.M)
    # the trace: what export_trace writes, with each tenant's trace id
    code, body = reads["/trace"]
    doc = json.loads(body)
    assert code == 200 and doc == json.loads(json.dumps(run["trace"]))
    port_schema.assert_valid(doc, schemas["chrome_trace"], "/trace",
                             defs=schemas)
    exported = srv.export_trace(str(run["root"] / "trace.json"))
    with open(exported) as fh:
        on_disk = json.load(fh)
    assert on_disk["traceEvents"] == doc["traceEvents"]
    # the progress of a tenant, by name and by id: its handle's
    h1 = run["handles"][1]
    for route in ("/tenants/t1/progress", "/tenants/1/progress"):
        code, body = reads[route]
        assert code == 200 and json.loads(body) == json.loads(
            json.dumps(h1.progress()))
    assert reads["/tenants/nobody/progress"][0] == 404
    # the postmortem: the flight bundle, schema-valid
    code, body = reads["/postmortem"]
    pm = json.loads(body)
    port_schema.assert_valid(pm, schemas["postmortem"], "/postmortem",
                             defs=schemas)
    assert code == 200 and pm["reason"] == "endpoint" and pm["spans"]
    assert run["closed"]


def test_trace_id_on_spans_and_progress_bitwise(demo, http_runs, refs):
    """A tenant's trace id tags every span of its tenant and no other,
    rides its progress and the trace document; chains are bitwise with and
    without it."""
    run = http_runs["port"]
    srv = run["server"]
    spans = srv.spans.spans()
    tids = {h.tenant_id: h.request.trace_id for h in run["handles"]}
    tagged = [s for s in spans if s["tenant"] in tids]
    assert {s["name"] for s in tagged} >= {"stage", "admit", "finalize"}
    assert all(s.get("trace_id") == tids[s["tenant"]] for s in tagged)
    assert all("trace_id" not in s for s in spans
               if s["tenant"] not in tids)
    ev = [e for e in run["trace"]["traceEvents"] if e["ph"] == "X"
          and e["pid"] - 1 in tids]
    assert ev and all(e["args"]["trace_id"] == tids[e["pid"] - 1]
                      for e in ev)
    for h in run["handles"]:
        assert h.progress()["trace_id"] == h.request.trace_id
    # bitwise without it: the same two tenants, no trace id
    s2 = _server(demo, False)
    from gibbs_student_t_tpu_torch.serve import MonitorSpec

    hs = [s2.submit(TenantRequest(ma=demo[0], niter=15, nchains=16, seed=i,
                                  name=f"t{i}",
                                  monitor=MonitorSpec(params=[0, 1])))
          for i in range(2)]
    try:
        _drive(s2)
    finally:
        s2.close()
    for h, res in zip(hs, run["results"]):
        assert "trace_id" not in h.progress()
        _bitwise(res, h.result(timeout=0))


def test_recover_restores_trace_id(demo, tmp_path):
    """The manifest journals a spooled tenant's trace id; a server
    recovered from it tags the resumed tenant's spans and progress."""
    man = str(tmp_path / "man")
    srv = _server(demo, False, manifest_dir=man)
    srv.submit(_req(demo, "S", 7, niter=20, trace_id="trace-S",
                    spool_dir=str(tmp_path / "S")))
    for _ in range(2):
        srv.step()
    admits = [r for r in read_manifest(man) if r["kind"] == "admit"]
    assert [r["trace_id"] for r in admits] == ["trace-S"]
    del srv     # abandoned: no close, as after a kill
    srv2, handles = ChainServer.recover(man, device="cpu")
    h = handles["S"]
    try:
        assert h.request.trace_id == "trace-S"
        assert h.request.start_sweep == 10
        _drive(srv2)
        assert h.progress()["trace_id"] == "trace-S"
        mine = [s for s in srv2.spans.spans() if s["tenant"] == h.tenant_id]
        assert mine and all(s["trace_id"] == "trace-S" for s in mine)
    finally:
        srv2.close()


# --- pool_main as a subprocess -----------------------------------------------

def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **extra)
    return env


def _spawn(pool_dir, *args, module="gibbs_student_t_tpu_torch", env=None):
    return subprocess.Popen(
        [sys.executable, "-m", f"{module}.serve.pool_main", "--dir",
         str(pool_dir), *args], cwd=REPO, env=env or _env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _wait_ready(pool_dir, proc, key=None):
    """``ready.json`` once it is there (and holds ``key``, when given)."""
    path = os.path.join(str(pool_dir), "ready.json")
    t_end = time.monotonic() + PROC_S
    while True:
        if os.path.exists(path):
            with open(path) as fh:
                doc = json.load(fh)
            if key is None or key in doc.get("coldstart", {}):
                return doc
        if proc.poll() is not None:
            pytest.fail(f"the worker exited {proc.returncode} before it was "
                        f"ready: {proc.communicate()[1][-3000:]}")
        assert time.monotonic() < t_end, "the worker was not ready in time"
        time.sleep(0.02)


def _end(proc):
    """The worker's exit code (killed, and failed, if it hangs)."""
    try:
        return proc.wait(timeout=PROC_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        pytest.fail("the worker did not exit in time")
    finally:
        for f in (proc.stdout, proc.stderr):
            f.close()


def test_pool_main_ready_keys_rpc_and_shutdown(demo, refs, tmp_path):
    """A port worker and a JAX worker on the same spec: the same
    ``ready.json`` keys but for the JAX compile registry's (``cache``,
    ``registry``) and the port's library report; a tenant served by the
    port's worker is bitwise the in-process one; ``shutdown`` over the
    wire ends both with exit 0."""
    from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
    from gibbs_student_t_tpu.data.demo import (
        make_demo_model_arrays as jax_demo_model_arrays,
    )
    from gibbs_student_t_tpu.serve.pool_main import (
        write_spec as jax_write_spec,
    )

    pd, jd = tmp_path / "port", tmp_path / "jax"
    write_spec(str(pd), demo[0], demo[1],
               dict(POOL_KW, device="cpu", pipeline=False))
    jax_write_spec(str(jd), jax_demo_model_arrays(components=5),
                   JaxConfig(model="mixture"), dict(nlanes=32, quantum=Q))
    procs = [_spawn(pd), _spawn(jd, module="gibbs_student_t_tpu",
                                env=_env(GST_CACHE_DIR=str(tmp_path / "c")))]
    try:
        ready = _wait_ready(pd, procs[0])
        jready = _wait_ready(jd, procs[1])
        assert set(ready) == set(jready) == {
            "pid", "rpc_port", "http_port", "obs_dir", "manifest_dir",
            "recovered", "lost", "coldstart"}
        cs, jcs = set(ready["coldstart"]), set(jready["coldstart"])
        assert jcs - cs == {"cache", "registry"}
        assert cs - jcs == {"library", "library_s"}
        assert ready["pid"] == procs[0].pid and ready["http_port"]
        assert ready["coldstart"]["library"] is None   # the CPU
        assert ready["obs_dir"] == str(pd / "obs")
        assert ready["manifest_dir"] == str(pd / "manifest")
        cli = RemoteChainServer(("127.0.0.1", ready["rpc_port"]),
                                timeout=SOCK_S)
        chunks = []
        h = cli.submit(_req(demo, "W", 4, on_chunk=lambda hh, s, r:
                            chunks.append(s)))
        _bitwise(h.result(timeout=RUN_TIMEOUT_S), refs[4])
        assert chunks == [5, 10]
        code, body = _get(f"http://127.0.0.1:{ready['http_port']}"
                          "/tenants/W/progress")
        assert code == 200 and json.loads(body)["status"] == "done"
        first = _wait_ready(pd, procs[0], key="first_dispatch_t")
        assert first["coldstart"]["first_dispatch_s"] > 0
        assert cli.status()["quanta"] == 2
        cli.reset_counters()
        assert cli.status()["quanta"] == 0
        cli.shutdown()
        from gibbs_student_t_tpu.serve.rpc import (
            RemoteChainServer as JaxClient,
        )

        JaxClient(("127.0.0.1", jready["rpc_port"]),
                  timeout=SOCK_S).shutdown()
        assert [_end(p) for p in procs] == [0, 0]
        with open(pd / "summary.json") as fh:
            summ = json.load(fh)
        assert summ["quanta"] == 0 and summ["nlanes"] == 32
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_pool_main_without_cuda_exits_nonzero(demo, tmp_path):
    """A spec that asks for the card, on a host without CUDA: the worker
    raises and exits non-zero, with no ready.json."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    write_spec(str(tmp_path), demo[0], demo[1], dict(POOL_KW))
    proc = _spawn(tmp_path)
    rc = _end(proc)
    assert rc != 0
    assert not os.path.exists(tmp_path / "ready.json")


@pytest.mark.chaos
def test_pool_main_kill_then_recover_bitwise(demo, refs, tmp_path):
    """A worker armed with ``pool_kill`` dies (``os._exit(9)``) at its
    third completed quantum, mid-run of two spooled tenants submitted
    over the wire; a ``--recover`` worker maps both names in
    ``ready.json["recovered"]`` and serves them to the end, each bitwise
    its uninterrupted run; ``shutdown`` ends it with exit 0."""
    pd = tmp_path / "pool"
    write_spec(str(pd), demo[0], demo[1],
               dict(POOL_KW, device="cpu", pipeline=False))
    kill = json.dumps([{"point": "pool_kill", "after": 2,
                        "action": "kill"}])
    proc = _spawn(pd, "--faults", kill)
    try:
        ready = _wait_ready(pd, proc)
        cli = RemoteChainServer(("127.0.0.1", ready["rpc_port"]),
                                timeout=SOCK_S)
        for seed in (7, 8):
            cli.submit(_req(demo, f"v{seed}", seed, niter=20,
                            spool_dir=str(tmp_path / f"v{seed}")))
        assert _end(proc) == 9
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    os.remove(pd / "ready.json")
    proc = _spawn(pd, "--recover")
    try:
        ready = _wait_ready(pd, proc)
        assert ready["coldstart"]["recover"] is True
        assert set(ready["recovered"]) == {"v7", "v8"} and not ready["lost"]
        cli = RemoteChainServer(("127.0.0.1", ready["rpc_port"]),
                                timeout=SOCK_S)
        for seed in (7, 8):
            tid = ready["recovered"][f"v{seed}"]
            res = RemoteTenantHandle(cli, tid, None).result(
                timeout=RUN_TIMEOUT_S)
            _bitwise(res, refs[seed])
        cli.shutdown()
        assert _end(proc) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(pd, ignore_errors=True)

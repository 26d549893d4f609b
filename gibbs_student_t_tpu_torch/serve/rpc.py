"""The RPC edge: submit, progress, cancel and result over TCP.

Counterpart of ``gibbs_student_t_tpu/serve/rpc.py`` (standard library and
numpy only), frame for frame: a length-prefixed binary framing over
``socketserver`` carrying JSON control objects with out-of-band numpy
buffers, an :class:`RpcServer` mounted beside a live
:class:`~gibbs_student_t_tpu_torch.serve.server.ChainServer`, and a
client-side :class:`RemoteChainServer` whose ``submit`` returns a
:class:`RemoteTenantHandle` with the in-process handle's surface
(``progress()`` / ``cost()`` / ``result()`` / ``done()``), including
streaming: a submit with ``on_chunk`` keeps its connection open and the
server pushes one frame per drained quantum.

Framing
-------

::

    FRAME := MAGIC(2)=b"GW" | VER(1)=1 | KIND(1) | LEN(u32 BE) | PAYLOAD

``KIND`` is ``b"j"`` (PAYLOAD = one JSON object) or ``b"m"``
(composite: ``u32 BE json_len | json | buffers...``). A composite's JSON
body references its buffers by position: ``{"$nd": i}`` marks a numpy
array (dtype and shape in the ``__buffers__`` table), ``{"$pkl": i}`` a
pickled Python object (the tenant model, the final ChainResult). A body
without a pickled value encodes byte for byte as the JAX package's
``encode_frame`` does, and each package decodes the other's frames (a
0-d array travels as shape ``(1,)`` in both, as ``np.ascontiguousarray``
makes it).
Frames above ``GST_RPC_MAX_FRAME`` bytes (default 256 MiB, a strict
positive integer) are rejected by both ends before any allocation; a bad
magic, version or kind, or a short read, raises :class:`FrameError`. The
server answers malformed input with one error frame and closes that
connection; a peer that hangs up mid-frame costs only its connection.

Trust model: like the crash manifest (serve/manifest.py), the wire
carries pickled models and results. It is a protocol for one trust
domain: bind it to loopback or a private network.

Determinism: a tenant's chains depend only on its request (seed, model,
budget, start sweep), never on the lanes or the process that served it,
so a request served through a :class:`RemoteChainServer` is bitwise the
same request served in process. A request's ``state`` never rides a
frame: resume goes through ``spool_dir`` with ``resume_spool=True``.
Beyond the JAX wire, the port's request bodies carry a warm-start spec's
``kind`` when it is not the default ``"gmm"`` and the request's
``adapt_scan`` when set (the JAX bodies drop both, so a flow warm start
or an adaptive scan would reach a JAX server as neither); a body without
them is the JAX body.

Fault injection: the ``rpc_sever`` point (serve/faults.py) fires per
request in the connection loop and per chunk in the streaming push; a
firing closes the TCP connection abruptly, with no error frame.
"""

from __future__ import annotations

import json
import pickle
import queue as _queue
import socket
import socketserver
import struct
import threading
import time
import warnings
from typing import Callable, Dict, Optional

import numpy as np

from gibbs_student_t_tpu_torch.serve import faults as _faults
from gibbs_student_t_tpu_torch.utils.env import env_posint

MAGIC = b"GW"
VERSION = 1
KIND_JSON = b"j"
KIND_COMPOSITE = b"m"
_HEADER = struct.Struct(">2sccI")

#: default frame-size ceiling (bytes) when ``GST_RPC_MAX_FRAME`` unset
DEFAULT_MAX_FRAME = 256 * 1024 * 1024


class FrameError(ValueError):
    """A malformed, oversized, or truncated wire frame."""


class RpcError(RuntimeError):
    """A request that reached the server and was answered with an
    error frame (the remote failure, re-raised client-side)."""


def rpc_max_frame_env() -> int:
    """The validated ``GST_RPC_MAX_FRAME`` (bytes): unset is 256 MiB, else
    a strict positive integer. Both ends enforce it before they read a
    payload."""
    return env_posint("GST_RPC_MAX_FRAME", DEFAULT_MAX_FRAME)


class Pickled:
    """Marks one value in an outgoing frame body for pickle transport
    (model pytrees, ChainResult — numpy trees JSON can't carry)."""

    def __init__(self, obj):
        self.obj = obj


# ---------------------------------------------------------------------------
# encode / decode (socket-free, unit-testable)
# ---------------------------------------------------------------------------

def encode_frame(body: dict) -> bytes:
    """One wire frame from a JSON-able body that may contain numpy
    arrays and :class:`Pickled` wrappers at any depth. Bodies with
    neither encode as a plain JSON frame."""
    buffers = []
    descrs = []

    def walk(v):
        if isinstance(v, Pickled):
            i = len(buffers)
            buffers.append(pickle.dumps(v.obj, protocol=4))
            descrs.append([None, None, len(buffers[-1])])
            return {"$pkl": i}
        if isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            i = len(buffers)
            buffers.append(a.tobytes())
            descrs.append([a.dtype.str, list(a.shape), len(buffers[-1])])
            return {"$nd": i}
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, dict):
            return {str(k): walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        return v

    body = walk(body)
    if buffers:
        body["__buffers__"] = descrs
        jb = json.dumps(body, separators=(",", ":")).encode()
        payload = struct.pack(">I", len(jb)) + jb + b"".join(buffers)
        kind = KIND_COMPOSITE
    else:
        payload = json.dumps(body, separators=(",", ":")).encode()
        kind = KIND_JSON
    return _HEADER.pack(MAGIC, bytes([VERSION]), kind,
                        len(payload)) + payload


def decode_payload(kind: bytes, payload: bytes) -> dict:
    """The inverse of :func:`encode_frame` for one received payload."""
    if kind == KIND_JSON:
        body = json.loads(payload.decode())
        if not isinstance(body, dict):
            raise FrameError("frame body is not a JSON object")
        return body
    if kind != KIND_COMPOSITE:
        raise FrameError(f"unknown frame kind {kind!r}")
    if len(payload) < 4:
        raise FrameError("composite frame too short for its JSON length")
    (jlen,) = struct.unpack(">I", payload[:4])
    if 4 + jlen > len(payload):
        raise FrameError("composite JSON length exceeds the payload")
    body = json.loads(payload[4:4 + jlen].decode())
    if not isinstance(body, dict):
        raise FrameError("frame body is not a JSON object")
    descrs = body.pop("__buffers__", [])
    bufs = []
    off = 4 + jlen
    for d in descrs:
        dtype, shape, nbytes = d
        if off + nbytes > len(payload):
            raise FrameError("buffer table overruns the payload")
        raw = payload[off:off + nbytes]
        off += nbytes
        if dtype is None:
            bufs.append(("pkl", raw))
        else:
            bufs.append(("nd", np.frombuffer(
                raw, np.dtype(dtype)).reshape(shape).copy()))

    def walk(v):
        if isinstance(v, dict):
            if set(v) == {"$nd"} or set(v) == {"$pkl"}:
                key = "nd" if "$nd" in v else "pkl"
                i = v.get("$nd", v.get("$pkl"))
                if not isinstance(i, int) or not 0 <= i < len(bufs) \
                        or bufs[i][0] != key:
                    raise FrameError(f"dangling buffer reference {v}")
                kind_i, val = bufs[i]
                return (val if kind_i == "nd"
                        else pickle.loads(val))
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v

    return walk(body)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise FrameError("connection closed mid-frame")
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def send_frame(sock: socket.socket, body: dict,
               max_frame: Optional[int] = None) -> None:
    data = encode_frame(body)
    limit = max_frame if max_frame is not None else rpc_max_frame_env()
    if len(data) - _HEADER.size > limit:
        raise FrameError(
            f"outgoing frame of {len(data) - _HEADER.size} bytes "
            f"exceeds the {limit}-byte ceiling (GST_RPC_MAX_FRAME)")
    sock.sendall(data)


def recv_frame(sock: socket.socket,
               max_frame: Optional[int] = None) -> dict:
    """Read one frame; raises :class:`FrameError` on malformed input,
    an oversized declared length (rejected BEFORE allocating), or a
    peer that hung up mid-frame. A clean EOF before any header byte
    raises ``ConnectionError`` (the peer is simply done)."""
    first = sock.recv(1)
    if not first:
        raise ConnectionError("peer closed the connection")
    head = first + _recv_exact(sock, _HEADER.size - 1)
    magic, ver, kind, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r} (not a gst-rpc peer?)")
    if ver != bytes([VERSION]):
        raise FrameError(f"unsupported protocol version {ver!r}")
    if kind not in (KIND_JSON, KIND_COMPOSITE):
        raise FrameError(f"unknown frame kind {kind!r}")
    limit = max_frame if max_frame is not None else rpc_max_frame_env()
    if length > limit:
        raise FrameError(
            f"incoming frame declares {length} bytes, above the "
            f"{limit}-byte ceiling (GST_RPC_MAX_FRAME)")
    return decode_payload(kind, _recv_exact(sock, length))


# ---------------------------------------------------------------------------
# request (de)serialization
# ---------------------------------------------------------------------------

#: TenantRequest fields that ride the wire as plain JSON values
_REQ_SCALARS = ("niter", "nchains", "seed", "start_sweep", "spool_dir",
                "name", "on_divergence", "on_converged",
                "resume_spool", "trace_id", "priority",
                "deadline_sweeps")

#: MonitorSpec fields (all JSON-able)
_MON_FIELDS = ("params", "ess_target", "rhat_target", "every",
               "min_rows")


#: WarmStartSpec fields (all JSON-able; serve/warm.py)
_WARM_SPEC_FIELDS = ("pilot_sweeps", "pilot_chains", "burn_frac",
                     "jitter_frac")

#: AdaptScanSpec fields (all JSON-able; serve/adapt.py)
_ADAPT_FIELDS = ("ess_target", "floor")


def _request_body(request, include_model: bool = True,
                  digest: Optional[str] = None) -> dict:
    """A TenantRequest as a submit frame body (the callable ``on_chunk``
    stays client-side: its presence becomes ``stream``).
    ``include_model=False`` sends only ``ma_digest`` (the
    content-addressed model cache): the server resolves the model from
    its digest store, or answers ``need_model`` and the client falls
    back to a full submit."""
    if request.state is not None:
        raise ValueError(
            "TenantRequest.state cannot ride the submit wire; resume "
            "via spool_dir + resume_spool, or the server-side recover()")
    body = {"op": "submit",
            "stream": request.on_chunk is not None}
    if include_model:
        body["ma"] = Pickled(request.ma)
    if digest is not None:
        body["ma_digest"] = digest
    for f in _REQ_SCALARS:
        body[f] = getattr(request, f)
    if request.x0 is not None:
        body["x0"] = np.asarray(request.x0)
    if request.monitor is not None:
        body["monitor"] = {f: getattr(request.monitor, f)
                           for f in _MON_FIELDS}
    ws = request.warm_start
    if ws is not None:
        from gibbs_student_t_tpu_torch.serve.warm import (
            WarmStartFit,
            WarmStartSpec,
        )

        if isinstance(ws, WarmStartSpec):
            spec = {f: getattr(ws, f) for f in _WARM_SPEC_FIELDS}
            if ws.kind != "gmm":
                spec["kind"] = ws.kind
            body["warm_start"] = {"spec": spec}
        elif isinstance(ws, WarmStartFit):
            body["warm_start"] = ws.to_json()   # journaled fit: replay
        elif isinstance(ws, dict):
            body["warm_start"] = ws
        else:
            raise ValueError(
                f"warm_start cannot ride the wire: "
                f"{type(ws).__name__}")
    if request.adapt_scan is not None:
        body["adapt_scan"] = {f: getattr(request.adapt_scan, f)
                              for f in _ADAPT_FIELDS}
    return body


def _request_from_body(body: dict):
    from gibbs_student_t_tpu_torch.serve.monitor import MonitorSpec
    from gibbs_student_t_tpu_torch.serve.scheduler import TenantRequest

    kw = {f: body.get(f) for f in _REQ_SCALARS if body.get(f) is not None}
    mon = body.get("monitor")
    if mon is not None:
        mon = MonitorSpec(**{f: mon.get(f) for f in _MON_FIELDS
                             if mon.get(f) is not None})
    ws = body.get("warm_start")
    if isinstance(ws, dict) and "spec" in ws:
        from gibbs_student_t_tpu_torch.serve.warm import WarmStartSpec

        ws = WarmStartSpec(**{f: ws["spec"][f]
                              for f in _WARM_SPEC_FIELDS + ("kind",)
                              if f in ws["spec"]})
    # a fit dict passes through verbatim: serve/warm.py
    # resolve_warm_start reconstructs it at staging
    ad = body.get("adapt_scan")
    if ad is not None:
        from gibbs_student_t_tpu_torch.serve.adapt import AdaptScanSpec

        ad = AdaptScanSpec(**{f: ad[f] for f in _ADAPT_FIELDS if f in ad})
    return TenantRequest(ma=body["ma"], x0=body.get("x0"),
                         monitor=mon, warm_start=ws, adapt_scan=ad, **kw)


def _tenant_error_body(err) -> dict:
    """A TenantError flattened for the wire (exceptions with custom
    ``__init__`` signatures don't round-trip pickle; the partial
    ChainResult does). A :class:`DeadlineExceeded` carries its
    subclass fields under ``kind`` so the client re-raises the same
    structured type."""
    from gibbs_student_t_tpu_torch.serve.scheduler import DeadlineExceeded

    body = {"op": "tenant_error", "tenant_id": err.tenant_id,
            "reason": err.reason, "where": err.where,
            "cause": (f"{type(err.cause).__name__}: {err.cause}"
                      if err.cause is not None else None),
            "partial": Pickled(err.partial)}
    if isinstance(err, DeadlineExceeded):
        body["kind"] = "deadline_exceeded"
        body["deadline_sweep"] = err.deadline_sweep
        body["served_sweeps"] = err.served_sweeps
    return body


def _tenant_error_from_body(body: dict):
    from gibbs_student_t_tpu_torch.serve.scheduler import (
        DeadlineExceeded,
        TenantError,
    )

    if body.get("kind") == "deadline_exceeded":
        return DeadlineExceeded(body["tenant_id"],
                                body["deadline_sweep"],
                                body["served_sweeps"],
                                partial=body.get("partial"))
    return TenantError(body["tenant_id"], reason=body["reason"],
                       where=body.get("where") or "drain",
                       cause=(RuntimeError(body["cause"])
                              if body.get("cause") else None),
                       partial=body.get("partial"))


def _retry_after_body(err) -> dict:
    """A structured overload shed as a rejected frame body: the client
    re-raises :class:`RetryAfter` with the same backoff/depth/tier
    signal the local submit call gets."""
    return {"op": "rejected",
            "error": f"{type(err).__name__}: {err}",
            "error_kind": "retry_after",
            "retry_after_s": err.retry_after_s,
            "queue_depth": err.queue_depth,
            "tier": err.tier, "shed_where": err.where}


def _rejected_error(reply: dict):
    """The exception a rejected frame resolves to: a structured
    :class:`RetryAfter` when the frame carries the overload signal,
    the historical bare RuntimeError otherwise."""
    if reply.get("error_kind") == "retry_after":
        from gibbs_student_t_tpu_torch.serve.scheduler import RetryAfter

        return RetryAfter(reply.get("error") or "rejected",
                          retry_after_s=reply.get("retry_after_s"),
                          queue_depth=reply.get("queue_depth"),
                          tier=reply.get("tier"),
                          where=reply.get("shed_where") or "server")
    return RuntimeError(reply.get("error") or "rejected")


# ---------------------------------------------------------------------------
# server side
# ---------------------------------------------------------------------------

class RpcServer:
    """The mutating wire mounted beside one ChainServer (duck-typed:
    anything with ``submit`` / ``cancel`` / ``status`` / ``healthz``
    and a ``_handles`` table serves — the test stubs ride the same
    class). Each connection gets its own daemon thread
    (``ThreadingTCPServer``); requests on one connection are handled
    sequentially, so a client may pipeline calls over one socket.

    ``on_shutdown`` (optional): the ``shutdown`` op's callback — the
    subprocess pool worker (serve/pool_main.py) passes one so a client
    can retire the worker over the wire; without it the op answers an
    error frame."""

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 max_frame: Optional[int] = None,
                 on_shutdown: Optional[Callable] = None,
                 chunk_queue: int = 8, model_cache: int = 64):
        self.server = server
        self.max_frame = (max_frame if max_frame is not None
                          else rpc_max_frame_env())
        self._on_shutdown = on_shutdown
        self._chunk_queue = int(chunk_queue)
        self._warned = False
        # content-addressed model cache: digest → model
        # pytree, LRU-capped. A submit carrying both model and digest
        # registers; a digest-only submit resolves here or answers
        # ``need_model`` (the client then falls back to a full
        # submit) — resubmission and failover stop re-shipping (and
        # re-pickling) identical models over the wire.
        from collections import OrderedDict

        self._model_cache: "OrderedDict[str, object]" = OrderedDict()
        self._model_cache_cap = int(model_cache)
        self._model_lock = threading.Lock()
        outer = self

        class _Handler(socketserver.BaseRequestHandler):
            def handle(self):
                outer._serve_connection(self.request)

        class _Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._tcp = _Server((host, port), _Handler)
        self.host, self.port = self._tcp.server_address[:2]
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="gst-rpc",
            daemon=True)
        self._thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def close(self) -> None:
        """Stop accepting connections and join the acceptor.
        Idempotent; in-flight per-connection threads are daemons."""
        tcp, self._tcp = self._tcp, None
        if tcp is None:
            return
        tcp.shutdown()
        tcp.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    # -- connection loop -----------------------------------------------

    def _serve_connection(self, sock: socket.socket) -> None:
        """One connection's request loop: a malformed frame answers
        one error frame then closes; a handler exception answers an
        error frame and the connection continues; an injected
        ``rpc_sever`` closes abruptly (no error frame) — the
        severed-wire chaos arm. Nothing here can fail the pool."""
        try:
            while True:
                try:
                    req = recv_frame(sock, self.max_frame)
                except ConnectionError:
                    return
                except FrameError as e:
                    self._try_send(sock, {"op": "error",
                                          "error": f"bad frame: {e}"})
                    return
                try:
                    _faults.fire("rpc_sever",
                                 tenant=req.get("name") or req.get("tenant"))
                except Exception:  # noqa: BLE001 - the fire IS the sever
                    return  # abrupt close, deliberately no error frame
                try:
                    if not self._dispatch(sock, req):
                        return
                except (BrokenPipeError, ConnectionError, OSError):
                    return
                except Exception as e:  # noqa: BLE001 - per-request
                    if not self._warned:
                        self._warned = True
                        warnings.warn(
                            f"rpc request {req.get('op')!r} failed "
                            f"({type(e).__name__}: {e}); connection "
                            "continues", RuntimeWarning)
                    self._try_send(sock, {
                        "op": "error",
                        "error": f"{type(e).__name__}: {e}"})
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def _try_send(self, sock, body) -> None:
        try:
            send_frame(sock, body, self.max_frame)
        except (OSError, FrameError):
            pass

    def _lookup(self, key):
        """A handle by tenant id (int) or request name (latest wins —
        the /tenants endpoint convention)."""
        handles = getattr(self.server, "_handles", {})
        try:
            h = handles.get(int(key))
            if h is not None:
                return h
        except (TypeError, ValueError):
            pass
        found = None
        for h in handles.values():
            if h.request.name == key:
                found = h
        return found

    def _dispatch(self, sock, req: dict) -> bool:
        """Handle one request; returns False when the connection must
        close (stream finished / shutdown)."""
        op = req.get("op")
        if op == "submit":
            return self._op_submit(sock, req)
        if op in ("progress", "cost", "cancel", "result"):
            h = self._lookup(req.get("tenant"))
            if h is None:
                send_frame(sock, {"op": "error", "error":
                                  f"unknown tenant {req.get('tenant')!r}"},
                           self.max_frame)
                return True
            if op == "progress":
                send_frame(sock, {"op": "ok", "progress": h.progress()},
                           self.max_frame)
            elif op == "cost":
                send_frame(sock, {"op": "ok", "cost": h.cost()},
                           self.max_frame)
            elif op == "cancel":
                send_frame(sock, {"op": "ok",
                                  "cancelled": bool(
                                      self.server.cancel(h))},
                           self.max_frame)
            else:
                self._send_result(sock, h, req.get("timeout"))
            return True
        if op == "status":
            send_frame(sock, {"op": "ok", "status": self.server.status()},
                       self.max_frame)
            return True
        if op == "reset":
            # a benchmark's warm-up boundary, over the wire: zero the
            # run-level aggregates so a timed window excludes the
            # pool's warm-up quanta
            self.server.reset_counters()
            send_frame(sock, {"op": "ok"}, self.max_frame)
            return True
        if op == "healthz":
            send_frame(sock, {"op": "ok",
                              "healthz": self.server.healthz()},
                       self.max_frame)
            return True
        if op == "time":
            # NTP-style clock sampling: the worker's wall clock, read
            # as late as possible; a caller brackets it with its own
            # timestamps to estimate the pool's clock offset
            send_frame(sock, {"op": "ok", "t": time.time()},
                       self.max_frame)
            return True
        if op == "trace":
            # the worker's Chrome trace document, over the wire (GET
            # /trace serves the same when the worker has an HTTP port)
            send_frame(sock, {"op": "ok",
                              "trace": self.server._trace_doc()},
                       self.max_frame)
            return True
        if op == "shutdown":
            if self._on_shutdown is None:
                send_frame(sock, {"op": "error",
                                  "error": "shutdown not armed"},
                           self.max_frame)
                return True
            send_frame(sock, {"op": "ok"}, self.max_frame)
            self._on_shutdown()
            return False
        send_frame(sock, {"op": "error", "error": f"unknown op {op!r}"},
                   self.max_frame)
        return True

    def _send_result(self, sock, h, timeout) -> None:
        """The ``result`` reply: the ChainResult pickled whole, or the
        structured tenant-error / rejection / timeout frames."""
        from gibbs_student_t_tpu_torch.serve.scheduler import TenantError

        try:
            res = h.result(timeout=timeout)
        except TimeoutError as e:
            send_frame(sock, {"op": "timeout", "error": str(e)},
                       self.max_frame)
            return
        except TenantError as e:
            send_frame(sock, _tenant_error_body(e), self.max_frame)
            return
        except RuntimeError as e:
            from gibbs_student_t_tpu_torch.serve.scheduler import RetryAfter

            body = (_retry_after_body(e) if isinstance(e, RetryAfter)
                    else {"op": "rejected", "error": str(e)})
            send_frame(sock, body, self.max_frame)
            return
        send_frame(sock, {"op": "result", "result": Pickled(res)},
                   self.max_frame)

    def _op_submit(self, sock, req: dict) -> bool:
        """Admit one remote tenant. A streaming submit dedicates the
        connection: the reply frame is followed by one ``chunk`` frame
        per drained quantum (pushed from this connection thread; the
        drain worker only enqueues — a slow client backpressures
        exactly like a slow local ``on_chunk`` callback) and ends with
        the result/tenant_error/rejected frame."""
        stream = bool(req.get("stream"))
        chunks: Optional[_queue.Queue] = None
        # content-addressed model resolution: a
        # digest-only submit reuses the cached pytree; a miss answers
        # ``need_model`` (the client retries with the model attached)
        digest = req.get("ma_digest")
        if req.get("ma") is None:
            with self._model_lock:
                ma = (self._model_cache.get(digest)
                      if digest is not None else None)
                if ma is not None:
                    self._model_cache.move_to_end(digest)
            if ma is None:
                send_frame(sock, {"op": "need_model",
                                  "digest": digest}, self.max_frame)
                return True
            req["ma"] = ma
        elif digest is not None:
            with self._model_lock:
                self._model_cache[digest] = req["ma"]
                self._model_cache.move_to_end(digest)
                while len(self._model_cache) > self._model_cache_cap:
                    self._model_cache.popitem(last=False)
        try:
            request = _request_from_body(req)
        except Exception as e:  # noqa: BLE001 - reject, don't kill conn
            send_frame(sock, {"op": "rejected",
                              "error": f"{type(e).__name__}: {e}"},
                       self.max_frame)
            return True
        if stream:
            chunks = _queue.Queue(maxsize=self._chunk_queue)
            detached = threading.Event()

            def on_chunk(handle, sweep_end, records):
                # Block (the backpressure contract) only while the
                # push loop below still drains the queue. Once the
                # connection is gone — client disconnect, injected
                # sever — ``detached`` turns this callback into a
                # no-op: a dead wire must never wedge the pool's
                # shared drain worker behind a full queue.
                while not detached.is_set():
                    try:
                        chunks.put((sweep_end, records), timeout=0.2)
                        return
                    except _queue.Full:
                        continue

            request.on_chunk = on_chunk
        try:
            h = self.server.submit(request, timeout=req.get("timeout"))
        except Exception as e:  # noqa: BLE001 - queue-full / validation
            from gibbs_student_t_tpu_torch.serve.scheduler import RetryAfter

            body = (_retry_after_body(e) if isinstance(e, RetryAfter)
                    else {"op": "rejected",
                          "error": f"{type(e).__name__}: {e}"})
            send_frame(sock, body, self.max_frame)
            return True
        send_frame(sock, {"op": "ok", "tenant_id": h.tenant_id},
                   self.max_frame)
        if not stream:
            return True
        # -- dedicated streaming push loop ------------------------------
        try:
            while True:
                try:
                    sweep_end, records = chunks.get(timeout=0.05)
                except _queue.Empty:
                    if h.done() and chunks.empty():
                        break
                    continue
                try:
                    _faults.fire("rpc_sever",
                                 tenant=request.name
                                 if request.name is not None
                                 else h.tenant_id)
                except Exception:  # noqa: BLE001 - abrupt sever
                    return False
                send_frame(sock, {"op": "chunk", "sweep_end": sweep_end,
                                  "records": {f: np.asarray(a)
                                              for f, a in
                                              records.items()}},
                           self.max_frame)
        finally:
            # every exit — clean finish, sever, or a send_frame error
            # on a dead client — detaches the callback; the tenant
            # keeps running and its result stays fetchable by id
            detached.set()
        self._send_result(sock, h, req.get("timeout"))
        return False


# ---------------------------------------------------------------------------
# client side
# ---------------------------------------------------------------------------

class RemoteTenantHandle:
    """Caller-facing proxy for a tenant submitted over the wire —
    the :class:`~gibbs_student_t_tpu_torch.serve.scheduler.TenantHandle`
    surface (``progress()`` / ``cost()`` / ``result()`` / ``done()``)
    backed by RPC calls. ``result()`` caches; a streamed handle's
    reader thread fills the cache as the final frame arrives."""

    def __init__(self, client: "RemoteChainServer", tenant_id: int,
                 request, streamed: bool = False):
        self.client = client
        self.tenant_id = tenant_id
        self.request = request
        self._result = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        # a streamed handle's outcome arrives on ITS connection (the
        # reader thread), after every chunk frame — result() must wait
        # for that, not race it over a side-channel call, or a caller
        # could observe the result before the last on_chunk fired
        self._streamed = streamed

    def _body(self, op: str, **extra) -> dict:
        """A control-frame body for this tenant; carries the job's
        ``trace_id`` (when it has one) so every progress, cost,
        cancel and result frame is correlatable with the tenant's spans
        (the server ignores unknown keys)."""
        body = {"op": op, "tenant": self.tenant_id}
        tid = getattr(self.request, "trace_id", None)
        if tid is not None:
            body["trace_id"] = tid
        body.update(extra)
        return body

    def progress(self) -> Dict[str, object]:
        return self.client._call(self._body("progress"))["progress"]

    def cost(self) -> Dict[str, object]:
        return self.client._call(self._body("cost"))["cost"]

    @property
    def status(self) -> str:
        if self._done.is_set():
            if self._error is None:
                return "done"
            from gibbs_student_t_tpu_torch.serve.scheduler import TenantError

            return ("failed" if isinstance(self._error, TenantError)
                    else "rejected")
        return str(self.progress().get("status"))

    def done(self) -> bool:
        if self._done.is_set():
            return True
        return self.progress().get("status") in ("done", "failed",
                                                 "rejected")

    def cancel(self) -> bool:
        return self.client.cancel(self)

    def _resolve(self, body: dict) -> None:
        """Terminal frame → cached outcome (reader thread / result)."""
        op = body.get("op")
        if op == "result":
            self._result = body["result"]
        elif op == "tenant_error":
            self._error = _tenant_error_from_body(body)
        elif op == "timeout":
            raise TimeoutError(body.get("error") or "result timeout")
        elif op == "rejected":
            self._error = _rejected_error(body)
        else:
            raise RpcError(body.get("error") or f"unexpected reply {op!r}")
        self._done.set()

    def result(self, timeout: Optional[float] = None):
        """Block until the remote job completes and return its
        ChainResult; raises the reconstructed TenantError (partial
        attached) / rejection — the in-process ``result()`` contract
        over the wire."""
        if not self._done.is_set():
            if self._streamed:
                # the stream delivers chunks-then-outcome in order;
                # wait for its reader instead of racing it
                if not self._done.wait(timeout):
                    raise TimeoutError(
                        f"tenant {self.tenant_id} stream not done")
            else:
                body = self.client._call(
                    self._body("result", timeout=timeout),
                    sock_timeout=(None if timeout is None
                                  else timeout + 30.0))
                self._resolve(body)
        if self._error is not None:
            raise self._error
        return self._result


class RemoteChainServer:
    """A :class:`ChainServer`-shaped client for one remote pool.

    ``submit(request)`` mirrors the in-process call: the tenant model
    rides the wire pickled, and the returned
    :class:`RemoteTenantHandle` exposes ``progress()/cost()/result()``.
    A request with ``on_chunk`` set streams: a dedicated connection
    stays open and a reader thread invokes the callback locally with
    each drained quantum's materialized records (handle, sweep_end,
    records — the local signature). Control calls open one connection
    each (submit/progress/cancel are rare next to a quantum).
    """

    def __init__(self, address, timeout: float = 30.0,
                 max_frame: Optional[int] = None):
        if isinstance(address, str):
            host, _, port = address.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self.address = tuple(address)
        self.timeout = timeout
        self.max_frame = (max_frame if max_frame is not None
                          else rpc_max_frame_env())
        self._streams: list = []
        # content-addressed submit: pickled-model digests
        # by object identity (strong refs pin ids valid; bounded), and
        # the digests this server has confirmed holding — repeat
        # submits of one model skip both the re-pickle and the model
        # bytes
        self._digest_cache: Dict[int, tuple] = {}
        self._server_has: set = set()

    # -- plumbing -------------------------------------------------------

    def _connect(self, sock_timeout: Optional[float]) -> socket.socket:
        sock = socket.create_connection(self.address,
                                        timeout=self.timeout)
        sock.settimeout(sock_timeout if sock_timeout is not None
                        else self.timeout)
        return sock

    def _call(self, body: dict,
              sock_timeout: Optional[float] = None) -> dict:
        """One request/reply exchange on a fresh connection; error
        frames re-raise as :class:`RpcError`."""
        sock = self._connect(sock_timeout)
        try:
            send_frame(sock, body, self.max_frame)
            reply = recv_frame(sock, self.max_frame)
        finally:
            try:
                sock.close()
            except OSError:
                pass
        if reply.get("op") == "error":
            raise RpcError(reply.get("error") or "remote error")
        return reply

    # -- the ChainServer-shaped surface ---------------------------------

    def _digest_of(self, ma) -> str:
        key = id(ma)
        hit = self._digest_cache.get(key)
        if hit is not None and hit[0] is ma:
            return hit[1]
        import hashlib

        digest = hashlib.sha256(
            pickle.dumps(ma, protocol=4)).hexdigest()
        if len(self._digest_cache) > 128:
            self._digest_cache.clear()
        self._digest_cache[key] = (ma, digest)
        return digest

    def submit(self, request,
               timeout: Optional[float] = None) -> RemoteTenantHandle:
        """Queue a job on the remote pool; ``timeout`` bounds the
        remote admission-queue wait (the backpressure contract). A
        model the server already holds (by content digest) rides the
        wire as its digest alone; a ``need_model`` reply falls back
        to a full submit — so the first submission is one round trip
        either way and repeats skip the model bytes."""
        digest = self._digest_of(request.ma)
        omit = digest in self._server_has
        body = _request_body(request, include_model=not omit,
                             digest=digest)
        body["timeout"] = timeout
        if not body["stream"]:
            reply = self._call(body)
            if reply.get("op") == "need_model":
                self._server_has.discard(digest)
                body = _request_body(request, digest=digest)
                body["timeout"] = timeout
                reply = self._call(body)
            if reply.get("op") == "rejected":
                raise _rejected_error(reply)
            self._server_has.add(digest)
            return RemoteTenantHandle(self, reply["tenant_id"], request)
        # streaming: the connection outlives the call
        sock = self._connect(None)
        try:
            send_frame(sock, body, self.max_frame)
            reply = recv_frame(sock, self.max_frame)
            if reply.get("op") == "need_model":
                # digest miss on a fresh server: retry with the model
                # on the same connection (the server answered and
                # kept it open)
                self._server_has.discard(digest)
                body = _request_body(request, digest=digest)
                body["timeout"] = timeout
                send_frame(sock, body, self.max_frame)
                reply = recv_frame(sock, self.max_frame)
        except BaseException:
            sock.close()
            raise
        if reply.get("op") in ("rejected", "error"):
            sock.close()
            if reply.get("op") == "rejected":
                raise _rejected_error(reply)
            raise RuntimeError(reply.get("error"))
        self._server_has.add(digest)
        h = RemoteTenantHandle(self, reply["tenant_id"], request,
                               streamed=True)
        t = threading.Thread(target=self._stream_reader,
                             args=(sock, h, request.on_chunk),
                             name="gst-rpc-stream", daemon=True)
        t.start()
        self._streams.append((sock, t))
        return h

    @staticmethod
    def _stream_reader(sock, h: RemoteTenantHandle,
                       on_chunk: Callable) -> None:
        """Consume chunk frames until the terminal frame (or a severed
        connection, which resolves the handle to an error — a client
        must never hang on a dead wire)."""
        try:
            while True:
                # the client's configured ceiling, not the env default
                # — chunk/result frames obey the same limit as _call
                body = recv_frame(sock, h.client.max_frame)
                if body.get("op") == "chunk":
                    try:
                        on_chunk(h, body["sweep_end"], body["records"])
                    except Exception:  # noqa: BLE001 - client callback
                        pass  # local callback bugs never kill the stream
                    continue
                try:
                    h._resolve(body)
                except (TimeoutError, RpcError) as e:
                    h._error = e
                    h._done.set()
                return
        except (FrameError, ConnectionError, OSError) as e:
            h._error = ConnectionError(
                f"stream severed: {type(e).__name__}: {e}")
            h._done.set()
        finally:
            try:
                sock.close()
            except OSError:
                pass

    def cancel(self, handle: RemoteTenantHandle) -> bool:
        return bool(self._call(handle._body("cancel"))["cancelled"])

    def status(self) -> dict:
        return self._call({"op": "status"})["status"]

    def healthz(self) -> dict:
        return self._call({"op": "healthz"})["healthz"]

    def server_time(self):
        """One NTP-style clock sample against the remote worker:
        ``(t0, ts, t1)`` — local wall time at send, the server's wall
        time, local wall time at receive. The sample of least round
        trip among a handful gives the worker's clock offset."""
        t0 = time.time()
        ts = float(self._call({"op": "time"})["t"])
        return (t0, ts, time.time())

    def trace(self) -> Optional[dict]:
        """The remote worker's Chrome trace document (None when the
        worker runs with spans disabled): what its HTTP ``/trace``
        serves, for a worker without an HTTP port."""
        return self._call({"op": "trace"})["trace"]

    def reset_counters(self) -> None:
        """Zero the remote pool's run-level aggregates (a benchmark's
        warm-up boundary, over the wire)."""
        self._call({"op": "reset"})

    def shutdown(self) -> None:
        """Ask the remote worker process to retire (pool_main arms
        the callback; a bare RpcServer answers an error)."""
        self._call({"op": "shutdown"})

    def close(self) -> None:
        """Drop any live stream connections (their handles resolve to
        severed-connection errors if still pending)."""
        streams, self._streams = self._streams, []
        for sock, t in streams:
            try:
                sock.close()
            except OSError:
                pass
            t.join(timeout=2.0)

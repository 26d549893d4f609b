"""Fleet aggregation over the observability wire, and the fleet trace.

Counterpart of ``gibbs_student_t_tpu/obs/aggregate.py`` (standard library
and numpy only), function for function: poll each pool's ``GET /status``
(obs/http.py) or its ``obs_dir`` ``status.json`` and merge the snapshots
into one fleet view (``fleet_status`` in the port's
``obs/observability.schema.json``), which the fleet router
(serve/router.py) places by and serves.

Merge semantics:

- occupancy and queue aggregate by summation over reachable pools
  (``totals``);
- SLO percentiles merge from the raw series, never from per-pool
  percentiles: every pool's status carries ``slo_raw`` and the fleet
  percentiles are computed over their concatenation; a pool without it
  adds nothing to the merged legs;
- an unreachable pool is reported, never fatal: a refused connection, a
  timeout or an unparseable body lands as ``{"reachable": false,
  "error": ...}`` in ``pools`` and the merge continues;
- a pool whose watchdog tripped renders sick, with the trip's cause and
  its executors' heartbeat ages.

The fleet trace: :func:`estimate_clock_offset` (NTP-style, from the
``time`` op's triples), :func:`read_trace`, :func:`stitch_fleet_trace`
(pool swimlanes rebased onto the router's timeline, pids shifted by
:data:`POOL_PID_STRIDE` a pool) and :func:`trace_coverage` (a job's router
and pool spans, by trace id).

Every function returns what the JAX package's returns on the same input,
so the repository's ``tools/fleet_status.py`` and ``tools/serve_top.py``
(which load the JAX module by path) read a port fleet unchanged.
"""

from __future__ import annotations

import json
import os
import time
import urllib.request
from typing import List, Optional, Sequence

import numpy as np

FLEET_SCHEMA = 1

#: slo legs merged across pools (the ``slo_raw`` series names)
SLO_LEGS = ("admission_ms", "first_result_ms", "converged_ms")


def _percentiles(vals: List[float]) -> Optional[dict]:
    """{p50, p90, p99, max, mean} over a ms series (None if empty) —
    the same block shape as ``serve/server.py`` emits per pool."""
    if not vals:
        return None
    a = np.asarray(vals, np.float64)
    return {
        "p50": round(float(np.percentile(a, 50)), 3),
        "p90": round(float(np.percentile(a, 90)), 3),
        "p99": round(float(np.percentile(a, 99)), 3),
        "max": round(float(a.max()), 3),
        "mean": round(float(a.mean()), 3),
    }


def read_status(source: str, timeout: float = 2.0) -> dict:
    """One pool's status snapshot. ``source`` is an endpoint URL (the
    ``/status`` suffix is appended unless already present), an
    ``obs_dir`` directory, or a ``status.json`` path. Raises on any
    failure — :func:`fleet_status` is the caller that degrades."""
    src = str(source)
    if src.startswith(("http://", "https://")):
        url = src.rstrip("/")
        if not url.endswith("/status"):
            url += "/status"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            st = json.loads(resp.read().decode())
    else:
        path = src
        if os.path.isdir(path):
            path = os.path.join(path, "status.json")
        with open(path) as fh:
            st = json.load(fh)
    if not isinstance(st, dict):
        raise ValueError(f"status from {source!r} is not an object")
    return st


def _pool_entry(source: str, st: dict) -> dict:
    """The per-pool row of the fleet snapshot: the placement-relevant
    subset of one reachable pool's status."""
    faults = st.get("faults") or {}
    tenants = st.get("tenants") or []
    # watchdog fold: a pool whose watchdog tripped answers status fine
    # but its healthz is 503, so the fleet row must say SICK, not
    # healthy. Heartbeat ages ride along so a stalling (not yet tripped)
    # pool is visible too.
    wd = st.get("watchdog")
    wd = wd if isinstance(wd, dict) else {}
    tripped = wd.get("state") == "tripped"
    beats = wd.get("heartbeat_age_s")
    beats = beats if isinstance(beats, dict) else {}
    ages = [v for v in beats.values() if isinstance(v, (int, float))]
    # the execution backend, where the pool's status reports one
    # (platform, native probe verdict, admission write path); the
    # fields stay None otherwise
    be = st.get("backend")
    be = be if isinstance(be, dict) else {}
    return {
        "source": str(source),
        "reachable": True,
        "error": None,
        "nlanes": st.get("nlanes"),
        "busy_lanes": st.get("busy_lanes"),
        "free_groups": st.get("free_groups"),
        "occupancy_now": st.get("occupancy_now"),
        "occupancy": st.get("occupancy"),
        "queue_depth": st.get("queue_depth"),
        "staged": st.get("staged"),
        "running_tenants": len(tenants),
        "quanta": st.get("quanta"),
        "uptime_s": st.get("uptime_s"),
        # healthy = the pool itself never failed AND its watchdog has
        # not tripped; tenant-scoped faults are contained by design
        # and do not disqualify a pool
        "healthy": not faults.get("pool_failures") and not tripped,
        "platform": be.get("platform"),
        "native": be.get("native"),
        "scatter": be.get("scatter"),
        "faults": faults,
        "watchdog_state": wd.get("state"),
        "watchdog_cause": ((wd.get("trip") or {}).get("cause")
                           if tripped else None),
        "heartbeat_age_max_s": (round(max(ages), 3) if ages else None),
    }


def fleet_status(sources: Sequence[str], timeout: float = 2.0) -> dict:
    """Poll every source and merge into one fleet snapshot (the
    ``fleet_status`` schema). Unreachable pools are reported in
    ``pools`` with ``reachable: false`` — never fatal."""
    results = []
    for src in sources:
        try:
            results.append((src, read_status(src, timeout=timeout)))
        except Exception as e:  # noqa: BLE001 - a dead pool is data
            results.append((src, e))
    return fleet_merge(results)


def fleet_merge(results) -> dict:
    """Merge already-fetched per-pool statuses into the fleet
    snapshot. ``results`` rows are ``(source_label, status_dict)`` for
    reachable pools or ``(source_label, Exception)`` for dead ones —
    the router (serve/router.py) fetches its own statuses (local pools
    have no wire to poll) and reuses exactly this merge, so the
    router's fleet view and ``tools/fleet_status.py`` can never
    disagree on semantics."""
    pools = []
    raw = {leg: [] for leg in SLO_LEGS}
    tier_raw: dict = {}
    totals = {"nlanes": 0, "busy_lanes": 0, "queue_depth": 0,
              "staged": 0, "running_tenants": 0}
    n_converged = 0
    sched = {"preemptions": 0, "sheds": 0}
    queue_tiers: dict = {}
    for src, st in results:
        if not isinstance(st, dict):
            e = st
            pools.append({"source": str(src), "reachable": False,
                          "error": f"{type(e).__name__}: {e}"})
            continue
        entry = _pool_entry(src, st)
        pools.append(entry)
        for k in ("nlanes", "busy_lanes", "queue_depth", "staged"):
            v = st.get(k)
            if isinstance(v, (int, float)):
                totals[k] += int(v)
        totals["running_tenants"] += entry["running_tenants"]
        slo_raw = st.get("slo_raw") or {}
        for leg in SLO_LEGS:
            raw[leg].extend(v for v in (slo_raw.get(leg) or [])
                            if isinstance(v, (int, float)))
        # per-tier raw series: the same concatenate-then-percentile
        # discipline as the aggregate legs
        for tier, legs in (slo_raw.get("tiers") or {}).items():
            if not isinstance(legs, dict):
                continue
            dst = tier_raw.setdefault(
                str(tier), {leg: [] for leg in SLO_LEGS})
            for leg in SLO_LEGS:
                dst[leg].extend(v for v in (legs.get(leg) or [])
                                if isinstance(v, (int, float)))
        nc = (st.get("slo") or {}).get("n_converged")
        if isinstance(nc, (int, float)):
            n_converged += int(nc)
        # scheduling counters: summed over reachable pools
        sb = st.get("sched")
        if isinstance(sb, dict):
            for k in ("preemptions", "sheds"):
                v = sb.get(k)
                if isinstance(v, (int, float)):
                    sched[k] += int(v)
            for tier, d in (sb.get("queue_tiers") or {}).items():
                if isinstance(d, (int, float)):
                    queue_tiers[str(tier)] = \
                        queue_tiers.get(str(tier), 0) + int(d)
    totals["occupancy_now"] = (totals["busy_lanes"] / totals["nlanes"]
                               if totals["nlanes"] else 0.0)
    slo = {leg: _percentiles(raw[leg]) for leg in SLO_LEGS}
    slo["n_converged"] = n_converged
    if tier_raw:
        slo["tiers"] = {
            tier: {leg: _percentiles(vals)
                   for leg, vals in legs.items()}
            for tier, legs in sorted(tier_raw.items())}
    sched["queue_tiers"] = queue_tiers
    return {
        "schema": FLEET_SCHEMA,
        "t": round(time.time(), 3),
        "n_pools": len(pools),
        "n_reachable": sum(1 for p in pools if p["reachable"]),
        "pools": pools,
        "totals": totals,
        "slo": slo,
        "sched": sched,
    }


def render_fleet(snap: dict, out) -> None:
    """One fleet dashboard frame (the ``tools/fleet_status.py``
    renderer; serve_top-style fixed columns)."""
    tot = snap.get("totals") or {}
    print(f"fleet_status  pools={snap.get('n_reachable')}/"
          f"{snap.get('n_pools')} reachable "
          f"lanes={tot.get('busy_lanes')}/{tot.get('nlanes')} "
          f"({(tot.get('occupancy_now') or 0) * 100:.0f}% now) "
          f"queue={tot.get('queue_depth')} staged={tot.get('staged')} "
          f"tenants={tot.get('running_tenants')}", file=out)
    # router block (serve/router.py fleet snapshots): placement +
    # failover counters — which pool got which share, and how many
    # dead-pool recoveries the fleet has absorbed
    router = snap.get("router")
    if isinstance(router, dict):
        pl = router.get("placements") or {}
        placed = " ".join(f"{k}={v}" for k, v in sorted(pl.items()))
        print(f"router placements: {placed or '-'}  "
              f"failovers={router.get('failovers', 0)} "
              f"resubmitted={router.get('resubmitted', 0)} "
              f"dead_pools={router.get('dead_pools', 0)} "
              f"sheds={router.get('sheds', 0)}", file=out)
    # scheduling layer: fleet preemption/shed totals and
    # the per-tier door-queue depths behind the aggregate queue figure
    sched = snap.get("sched")
    if isinstance(sched, dict) and (sched.get("preemptions")
                                    or sched.get("sheds")
                                    or sched.get("queue_tiers")):
        qt = " ".join(f"t{k}={v}" for k, v in
                      sorted((sched.get("queue_tiers") or {}).items()))
        print(f"sched preemptions={sched.get('preemptions', 0)} "
              f"sheds={sched.get('sheds', 0)} "
              f"queue_tiers: {qt or '-'}", file=out)
    slo = snap.get("slo") or {}
    for leg in SLO_LEGS:
        p = slo.get(leg)
        if isinstance(p, dict):
            print(f"slo {leg:16s} p50={p.get('p50'):>8} "
                  f"p90={p.get('p90'):>8} p99={p.get('p99'):>8} "
                  f"(merged from raw series)", file=out)
    # per-tier SLO rows: the high tier's p99 under overload
    # is the headline the scheduler is graded on
    for tier, legs in sorted((slo.get("tiers") or {}).items()):
        if not isinstance(legs, dict):
            continue
        p = legs.get("admission_ms")
        if isinstance(p, dict):
            print(f"slo tier {tier} admission p50={p.get('p50'):>8} "
                  f"p90={p.get('p90'):>8} p99={p.get('p99'):>8}",
                  file=out)
    print(f"{'POOL':40s} {'OK':>4} {'WD':>5} {'BACKEND':>12} "
          f"{'LANES':>9} {'OCC%':>6} "
          f"{'QUEUE':>5} {'TEN':>4} {'FAULTS'}", file=out)
    for p in snap.get("pools") or []:
        src = str(p.get("source"))[:40]
        if not p.get("reachable"):
            print(f"{src:40s} {'DOWN':>4}  {p.get('error')}", file=out)
            continue
        lanes = f"{p.get('busy_lanes')}/{p.get('nlanes')}"
        occ = (p.get("occupancy_now") or 0) * 100
        f = p.get("faults") or {}
        fstr = " ".join(f"{k}={v}" for k, v in f.items() if v) or "-"
        # a tripped watchdog is a headline: the WD column shouts TRIP
        # (with the cause folded into the fault string) and the max
        # heartbeat age shows a stalling pool before it trips
        wd_state = p.get("watchdog_state")
        wd = {"tripped": "TRIP", "ok": "ok", "off": "off",
              None: "-"}.get(wd_state, str(wd_state))
        hb = p.get("heartbeat_age_max_s")
        if isinstance(hb, (int, float)) and wd == "ok":
            wd = f"{hb:.0f}s" if hb >= 1 else "ok"
        if p.get("watchdog_cause"):
            fstr = (f"wd:{p['watchdog_cause']} " + fstr).rstrip(" -")
        # execution backend column: platform + resolved admission
        # write path; a status without a backend block renders "-" (the
        # full native probe verdict stays on the pool's JSON row)
        if p.get("platform"):
            backend = (f"{p['platform']}/"
                       f"{'scatter' if p.get('scatter') else 'bounce'}")
        else:
            backend = "-"
        # str() the sparse fields: a pool serving a partial status is
        # still a renderable row, not a dashboard crash
        print(f"{src:40s} {'ok' if p.get('healthy') else 'SICK':>4} "
              f"{wd:>5} {backend:>12} {lanes:>9} {occ:6.1f} "
              f"{str(p.get('queue_depth')):>5} "
              f"{str(p.get('running_tenants')):>4} {fstr}", file=out)


# ---------------------------------------------------------------------------
# fleet trace stitching: clock-offset estimation + merge
# ---------------------------------------------------------------------------

#: pool swimlane pid stride in a stitched trace: router events keep
#: their native pids (< _POOL_PID_STRIDE), pool k's pids shift into
#: [_POOL_PID_STRIDE*(k+1), ...) — lanes can never collide, and
#: "which side recorded this" is recoverable from the pid alone
#: (:func:`trace_coverage`).
POOL_PID_STRIDE = 1000


def estimate_clock_offset(samples) -> dict:
    """NTP-style clock offset from request/response wall-time triples.

    ``samples`` is an iterable of ``(t0, ts, t1)``: local wall time at
    send, the server's wall time, local wall time at receive (the
    ``RemoteChainServer.server_time()`` shape). Under the symmetric-
    delay assumption the server clock leads the local clock by
    ``ts - (t0 + t1) / 2``; the estimate is taken at the minimum-RTT
    sample (least queueing noise, the classic NTP selection), so a few
    samples suffice and asymmetric outliers are rejected by
    construction. Returns ``{"offset_s", "rtt_s", "n"}`` — with no
    usable samples, offset 0.0 and ``rtt_s`` None (an uncorrected
    merge beats no merge). Malformed rows are skipped, never fatal.
    """
    best = None
    n = 0
    for s in samples or ():
        try:
            t0, ts, t1 = float(s[0]), float(s[1]), float(s[2])
        except (TypeError, ValueError, IndexError):
            continue
        rtt = t1 - t0
        if rtt < 0:          # non-causal sample: clock stepped mid-RTT
            continue
        n += 1
        if best is None or rtt < best[0]:
            best = (rtt, ts - 0.5 * (t0 + t1))
    if best is None:
        return {"offset_s": 0.0, "rtt_s": None, "n": 0}
    return {"offset_s": round(best[1], 6),
            "rtt_s": round(best[0], 6), "n": n}


def read_trace(source: str, timeout: float = 5.0) -> dict:
    """One pool's Chrome trace document: an endpoint URL (``/trace``
    appended unless present) or a trace JSON path. Raises on failure —
    the stitching caller degrades per pool."""
    src = str(source)
    if src.startswith(("http://", "https://")):
        url = src.rstrip("/")
        if not url.endswith("/trace"):
            url += "/trace"
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            doc = json.loads(resp.read().decode())
    else:
        with open(src) as fh:
            doc = json.load(fh)
    if not isinstance(doc, dict):
        raise ValueError(f"trace from {source!r} is not an object")
    return doc


def stitch_fleet_trace(router_doc: dict, pools) -> dict:
    """Merge the router's Chrome trace with per-pool traces into one
    offset-corrected fleet document (the ``fleet_trace`` schema).

    ``pools`` rows are ``{"label", "doc", "clock"}`` — ``doc`` a pool's
    ``chrome_trace_doc()`` (its ``otherData.epoch_wall`` anchors its
    ts=0 on the pool's wall clock), ``clock`` an
    :func:`estimate_clock_offset` result for that pool. Every pool
    event's ``ts`` is rebased onto the ROUTER timeline::

        ts' = ts + ((pool_epoch_wall - offset) - router_epoch_wall)*1e6

    i.e. the pool's wall clock corrected by its estimated offset, then
    expressed relative to the router's epoch — so one job's router
    placement span, pool staging/dispatch/drain spans and router
    result span line up in causal order even under skewed clocks. Pool
    pids shift by :data:`POOL_PID_STRIDE` per pool (disjoint
    swimlanes); process_name metadata rows gain a ``label/`` prefix.
    Pools whose doc carries no ``epoch_wall`` merge uncorrected
    (shift 0) — degraded, never fatal.
    """
    other = router_doc.get("otherData") or {}
    router_epoch = other.get("epoch_wall")
    dropped = int(other.get("dropped_spans") or 0)
    events = []
    for ev in router_doc.get("traceEvents") or ():
        if (ev.get("ph") == "M" and ev.get("name") == "process_name"
                and ev.get("pid") == 0):
            # the recorder labels pid 0 "pool"; in a fleet doc that
            # lane is the router's own
            ev = dict(ev, args={"name": "router"})
        events.append(ev)
    clocks = {}
    for k, p in enumerate(pools or ()):
        doc = (p.get("doc") or {}) if isinstance(p, dict) else {}
        label = str((p.get("label") if isinstance(p, dict) else None)
                    or f"pool{k}")
        clock = (p.get("clock") if isinstance(p, dict) else None) or {}
        off = clock.get("offset_s")
        off = float(off) if isinstance(off, (int, float)) else 0.0
        pool_other = doc.get("otherData") or {}
        pool_epoch = pool_other.get("epoch_wall")
        if (isinstance(pool_epoch, (int, float))
                and isinstance(router_epoch, (int, float))):
            shift_us = ((float(pool_epoch) - off)
                        - float(router_epoch)) * 1e6
        else:
            shift_us = 0.0
        dropped += int(pool_other.get("dropped_spans") or 0)
        clocks[label] = {"offset_s": off, "rtt_s": clock.get("rtt_s"),
                         "n": int(clock.get("n") or 0),
                         "shift_us": round(shift_us, 3)}
        base = POOL_PID_STRIDE * (k + 1)
        for ev in doc.get("traceEvents") or ():
            ev = dict(ev)
            try:
                ev["pid"] = base + int(ev.get("pid") or 0)
            except (TypeError, ValueError):
                ev["pid"] = base
            if ev.get("ph") == "M":
                if ev.get("name") == "process_name":
                    args = dict(ev.get("args") or {})
                    args["name"] = f"{label}/{args.get('name', '')}"
                    ev["args"] = args
            elif isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = round(float(ev["ts"]) + shift_us, 3)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"dropped_spans": dropped,
                          "epoch_wall": router_epoch,
                          "clocks": clocks,
                          "n_pools": len(list(pools or ()))}}


def trace_coverage(doc: dict) -> dict:
    """Per-job span counts over a stitched fleet trace:
    ``{trace_id: {"router": n, "pool": n}}``. The side is recovered
    from the pid (router lanes sit below :data:`POOL_PID_STRIDE`) —
    the end-to-end completeness evidence of a fleet run."""
    cov = {}
    for ev in doc.get("traceEvents") or ():
        if ev.get("ph") != "X":
            continue
        tid = (ev.get("args") or {}).get("trace_id")
        if not tid:
            continue
        try:
            side = ("router" if int(ev.get("pid") or 0) < POOL_PID_STRIDE
                    else "pool")
        except (TypeError, ValueError):
            continue
        c = cov.setdefault(str(tid), {"router": 0, "pool": 0})
        c[side] += 1
    return cov

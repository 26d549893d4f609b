"""The port's metrics registry, run ledger, trace hooks and timer,
against the JAX package's (CPU).

- ``obs.ledger.config_fingerprint`` gives the JAX package's string for the
  same configs (dataclasses, dicts, numpy values); a ledger record
  round-trips through ``append_record`` / ``read_ledger`` /
  ``last_record`` with the JAX record's keys, ``cuda`` in place of
  ``xla``, its platform the sampler's device;
- ``TelemetryAccumulator.emit_chunk`` on the same drained telemetry gives
  the JAX package's events and counters; a sampler with ``metrics=``
  emits one ``chunk`` event per chunk with the JAX event's fields;
- the manifest's keys are JAX's without ``jax_version`` and ``xla``, with
  ``torch_version`` and ``cuda_version``;
- the registry's metrics, ``read_events`` on a torn line, ``BlockTimer``,
  and ``trace_to`` writing a Chrome trace with the sweep's spans.

Mirrors tests/test_obs.py and tests/test_ledger.py.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

from gibbs_student_t_tpu.config import GibbsConfig as JaxConfig
from gibbs_student_t_tpu.obs import ledger as jax_ledger
from gibbs_student_t_tpu.obs import metrics as jax_metrics
from gibbs_student_t_tpu.obs.telemetry import (
    Telemetry as JaxTelemetry,
)
from gibbs_student_t_tpu.obs.telemetry import (
    TelemetryAccumulator as JaxAccumulator,
)
from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.obs import ledger, metrics, tracing
from gibbs_student_t_tpu_torch.obs.telemetry import (
    Telemetry,
    TelemetryAccumulator,
)
from gibbs_student_t_tpu_torch.utils.timing import BlockTimer

#: event fields that carry the wall clock
CLOCK = ("t", "elapsed_s")


@pytest.fixture(scope="module")
def ma():
    return make_demo_model_arrays(n=30, components=4)


@pytest.mark.parametrize("kw", [
    {},
    {"model": "vvh17", "vary_df": False, "theta_prior": "uniform",
     "vary_alpha": False, "alpha": 1e10, "pspin": 0.00457},
    {"model": "gaussian", "vary_df": True, "theta_prior": "beta"},
])
def test_config_fingerprint_is_the_jax_packages(kw):
    port, jax_cfg = GibbsConfig(**kw), JaxConfig(**kw)
    assert ledger.config_fingerprint(port) == \
        jax_ledger.config_fingerprint(jax_cfg)
    adapted = (port.with_adapt(100, adapt_cov=True),
               jax_cfg.with_adapt(100, adapt_cov=True))
    assert ledger.config_fingerprint(adapted[0]) == \
        jax_ledger.config_fingerprint(adapted[1])
    blob = {"b": np.float32(0.5), "a": [np.int64(3), np.arange(3)],
            "c": float("inf"), "cfg": kw}
    assert ledger.config_fingerprint(blob) == \
        jax_ledger.config_fingerprint(blob)


def test_ledger_record_round_trips(tmp_path, ma):
    smp = TorchGibbs(ma, GibbsConfig(model="mixture"), nchains=2,
                     device="cpu")
    path = str(tmp_path / "ledger.jsonl")
    rec = ledger.make_record("run_sims", {"sweeps_per_sec": 12.5},
                             platform=smp.device.type,
                             config={"nchains": 2}, argv=["x"])
    assert ledger.append_record(rec, path) == path
    ledger.append_record(ledger.make_record("other", {}), path)
    with open(path, "a") as fh:
        fh.write('{"torn": ')
    recs = ledger.read_ledger(path)
    assert len(recs) == 2 and recs[0] == json.loads(json.dumps(rec))
    got = ledger.last_record("run_sims", path)
    assert got["platform"] == "cpu" and got["metrics"] == {
        "sweeps_per_sec": 12.5}
    assert got["config_fingerprint"] == ledger.config_fingerprint(
        {"nchains": 2})
    assert isinstance(got["host_canary_ms"], float)
    assert got["devices"]["backend"] == (
        "cuda" if torch.cuda.is_available() else "cpu")
    jrec = jax_ledger.make_record("run_sims", {}, platform="cpu", xla=None)
    assert set(rec) == (set(jrec) - {"xla"}) | {"cuda"}
    assert ledger.last_record("nope", path) is None
    assert ledger.read_ledger(str(tmp_path / "missing.jsonl")) == []


def test_ledger_path_resolution(monkeypatch, tmp_path):
    monkeypatch.delenv("GST_LEDGER_PATH", raising=False)
    assert ledger.ledger_path() == os.path.join("artifacts", "ledger.jsonl")
    monkeypatch.setenv("GST_LEDGER_PATH", str(tmp_path / "env.jsonl"))
    assert ledger.ledger_path() == str(tmp_path / "env.jsonl")
    assert ledger.ledger_path("explicit.jsonl") == "explicit.jsonl"


def _chunk(rng, chains=4, sweeps=5):
    return dict(
        sweeps=np.full(chains, sweeps, np.int32),
        accept_white=rng.random(chains).astype(np.float32) * sweeps,
        accept_hyper=rng.random(chains).astype(np.float32) * sweeps,
        nonfinite=rng.integers(0, 2, chains).astype(np.int32),
        diverged=rng.random(chains) < 0.3,
        logpost=np.where(rng.random(chains) < 0.2, -np.inf,
                         rng.standard_normal(chains)).astype(np.float32))


def test_emit_chunk_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    chunks = [_chunk(rng) for _ in range(3)]
    regs = {}
    for side, acc, tele, reg_cls in (
            ("port", TelemetryAccumulator(), Telemetry,
             metrics.MetricsRegistry),
            ("jax", JaxAccumulator(), JaxTelemetry,
             jax_metrics.MetricsRegistry)):
        reg = regs[side] = reg_cls(run_dir=str(tmp_path / side))
        for k, c in enumerate(chunks):
            acc.emit_chunk(reg, 5 * (k + 1), acc.add(tele(**c)))
    snaps = {s: r.snapshot() for s, r in regs.items()}
    for s in ("counters", "gauges"):
        assert snaps["port"][s] == snaps["jax"][s]
    assert snaps["port"]["counters"]["sweeps_total"] == 3 * 5 * 4
    events = {}
    for side, reg in regs.items():
        reg.close()
        events[side] = [{k: v for k, v in e.items() if k not in CLOCK}
                        for e in metrics.read_events(str(tmp_path / side))
                        if e["event"] == "chunk"]
    assert len(events["port"]) == 3
    assert events["port"] == events["jax"]


def test_sampler_emits_one_chunk_event_per_chunk(tmp_path, ma):
    reg = metrics.MetricsRegistry(run_dir=str(tmp_path))
    smp = TorchGibbs(ma, GibbsConfig(model="mixture", vary_df=True),
                     nchains=3, device="cpu", chunk_size=4, metrics=reg)
    smp.sample(niter=12, seed=1)
    reg.close()
    chunks = [e for e in metrics.read_events(str(tmp_path))
              if e["event"] == "chunk"]
    assert [e["sweep_end"] for e in chunks] == [4, 8, 12]
    jacc = JaxAccumulator()
    want = set(jacc.add(JaxTelemetry(**_chunk(np.random.default_rng(1)))))
    assert set(chunks[0]) == want | {"event", "sweep_end"} | set(CLOCK)
    snap = [e for e in metrics.read_events(str(tmp_path))
            if e["event"] == "snapshot"][0]["metrics"]
    assert snap["counters"]["sweeps_total"] == 12 * 3
    # telemetry off: no chunk events, and no registry needed; the run's
    # introspection still records its first chunk (one compile event, as
    # the JAX sampler's compile introspection emits one)
    reg2 = metrics.MetricsRegistry(run_dir=str(tmp_path / "off"))
    TorchGibbs(ma, GibbsConfig(model="mixture"), nchains=2, device="cpu",
               chunk_size=4, telemetry=False, metrics=reg2).sample(
        niter=4, seed=1)
    reg2.close()
    assert [e["event"] for e in metrics.read_events(
        str(tmp_path / "off"))] == ["compile", "snapshot"]


def test_manifest_keys_are_the_jax_packages(tmp_path):
    cfg = GibbsConfig(model="mixture")
    path = metrics.write_manifest(str(tmp_path / "p"), config=cfg, seeds=3,
                                  argv=["a"], extra={"device": "cpu"})
    jpath = jax_metrics.write_manifest(str(tmp_path / "j"),
                                       config=JaxConfig(model="mixture"),
                                       seeds=3, argv=["a"],
                                       extra={"device": "cpu"})
    with open(path) as f1, open(jpath) as f2:
        mine, theirs = json.load(f1), json.load(f2)
    assert set(mine) == (set(theirs) - {"jax_version", "xla"}) | {
        "torch_version", "cuda_version"}
    assert mine["torch_version"] == torch.__version__
    assert mine["config"] == theirs["config"]
    assert mine["seeds"] == 3 and mine["device"] == "cpu"
    assert mine["devices"]["probed"]


def test_registry_metrics_and_events(tmp_path):
    reg = metrics.MetricsRegistry(run_dir=str(tmp_path))
    reg.counter("n").inc(2)
    with pytest.raises(ValueError, match="cannot decrease"):
        reg.counter("n").inc(-1)
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("n")
    reg.gauge("g").set(np.float32(1.5))
    h = reg.histogram("h", buckets=(1.0, 2.0))
    for v in (0.5, 1.5, 9.0):
        h.observe(v)
    out = reg.time("block", lambda a: a * 2, torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0))
    reg.emit("custom", value=np.arange(2), nan=float("nan"))
    snap = reg.snapshot()
    assert snap["counters"] == {"n": 2.0} and snap["gauges"] == {"g": 1.5}
    assert snap["histograms"]["h"]["buckets"] == {"1.0": 1, "2.0": 1,
                                                  "+inf": 1}
    assert snap["timers"]["block"]["calls"] == 1
    assert snap["histograms"]["block_seconds"]["count"] == 1
    reg.close()
    reg.close()
    reg.emit("after_close")
    with open(os.path.join(str(tmp_path), "events.jsonl"), "a") as fh:
        fh.write('{"event": "torn"')
    events = metrics.read_events(str(tmp_path))
    assert [e["event"] for e in events] == ["custom", "snapshot"]
    assert events[0]["value"] == [0, 1] and events[0]["nan"] == "nan"
    mem = metrics.MetricsRegistry()
    mem.emit("nothing")
    assert mem.write_manifest() is None


def test_block_timer_times_cpu_results():
    timer = BlockTimer()
    out = timer.time("mm", torch.matmul, torch.ones(4, 4), torch.ones(4, 4))
    assert float(out[0, 0]) == 4.0
    timer.time("mm", lambda: {"a": [torch.zeros(2)]})
    s = timer.summary()["mm"]
    assert s["calls"] == 2 and s["total_s"] >= 0.0
    assert timer.report().startswith("mm")


def test_trace_to_writes_a_chrome_trace_with_sweep_spans(tmp_path, ma):
    with tracing.trace_to(None):
        pass
    with tracing.trace_to(""):
        pass
    # outside a capture the spans are null contexts: no dispatcher call
    assert isinstance(tracing.block_span("gibbs/white_mh"),
                      contextlib.nullcontext)
    assert isinstance(tracing.host_span("test/host"), contextlib.nullcontext)
    smp = TorchGibbs(ma, GibbsConfig(model="mixture", vary_df=True),
                     nchains=2, device="cpu", chunk_size=2)
    d = str(tmp_path / "trace")
    with tracing.trace_to(d):
        smp.sample(niter=2, seed=0)
        with tracing.host_span("test/host"):
            pass
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"gibbs/white_mh", "gibbs/tnt_reduction", "gibbs/hyper_mh",
            "gibbs/b_draw", "test/host"} <= names

"""The port's run introspection (``obs/introspect.py``) on the CPU, held
against the JAX package's module.

- ``compile_summary()`` shares the JAX block's keys and their
  ``"unavailable"`` markers (tests/test_ledger.py), with ``kernels`` and
  ``build`` in place of ``pallas_kernels`` and ``registry``;
- records are deduplicated by content, a launch form is asked for once,
  and ``clear_introspection`` drops everything;
- every kernel wrapper records itself with ``impl="plain"`` on the CPU
  (the solo sampler, the TOA-blocked Gram path, MTM, the ensemble's
  grouped kernels, the serving pool's lanes entries and the factor and
  back-solve lanes entries), each entry point its program record under
  the JAX label, and ``format_summary`` names them;
- a sampler's registry gets one ``compile`` event a program and the
  manifest its ``cuda`` block at the close, valid against the schema;
- ``GST_INTROSPECT=0`` records nothing and a typo raises;
- the ptxas parser on lines of a real ``-Xptxas -v`` report of the
  kernels' build on the card.
"""

import json

import pytest
import torch

from gibbs_student_t_tpu_torch.backends.torch_backend import TorchGibbs
from gibbs_student_t_tpu_torch.config import GibbsConfig
from gibbs_student_t_tpu_torch.data.demo import make_demo_model_arrays
from gibbs_student_t_tpu_torch.obs import introspect
from gibbs_student_t_tpu_torch.obs import schema as port_schema
from gibbs_student_t_tpu_torch.obs.metrics import MetricsRegistry, read_events
from gibbs_student_t_tpu_torch.ops import _cuda, chol

#: JAX keys with no counterpart, and the port's keys in their place
JAX_ONLY = {"pallas_kernels", "registry"}
PORT_ONLY = {"kernels", "build"}


@pytest.fixture(autouse=True)
def _clean():
    introspect.clear_introspection()
    yield
    introspect.clear_introspection()


@pytest.fixture(scope="module")
def ma():
    return make_demo_model_arrays(components=5)


def test_summary_keys_and_markers_match_jax(ma):
    from gibbs_student_t_tpu.obs import introspect as jax_introspect

    jax_introspect.clear_introspection()
    try:
        want = jax_introspect.compile_summary()
    finally:
        jax_introspect.clear_introspection()
    got = introspect.compile_summary()
    assert set(got) - PORT_ONLY == set(want) - JAX_ONLY
    for k in set(got) - PORT_ONLY:
        assert got[k] == want[k], k
    for k in ("flops", "bytes_accessed", "custom_calls", "peak_bytes"):
        assert got[k] == introspect.UNAVAILABLE == jax_introspect.UNAVAILABLE
    TorchGibbs(ma, GibbsConfig(model="mixture"), nchains=2,
               device="cpu").sample(niter=2, seed=0)
    got = introspect.compile_summary()
    assert got["n_programs"] == 1 and got["compile_s"] == 0.0
    # on the CPU no program reports a peak; nothing measures the rest
    for k in ("flops", "bytes_accessed", "custom_calls", "peak_bytes"):
        assert got[k] == "unavailable"
    assert got["build"]["last_build"] is None and not got["build"]["kernels"]


def test_dedup_form_once_and_clear():
    introspect.register_kernel("k", impl="plain", shape=(2, 3))
    introspect.register_kernel("k", impl="plain", shape=[2, 3])
    introspect.register_kernel("k", impl="cuda", shape=(2, 3))
    assert introspect.kernel_builds() == [
        {"kernel": "k", "impl": "plain", "shape": [2, 3]},
        {"kernel": "k", "impl": "cuda", "shape": [2, 3]}]
    asked = []

    def form():
        asked.append(1)
        return {"form": "warp", "per_block": 2}

    for _ in range(3):
        introspect.note_kernel("f", "cuda", (4, 5), form)
    assert len(asked) == 1
    assert introspect.kernel_builds()[-1] == {
        "kernel": "f", "form": "warp", "impl": "cuda", "per_block": 2,
        "shape": [4, 5]}
    for _ in range(2):
        introspect.register_linalg_impl("factor", "chol_fused", jitters=4)
    assert introspect.linalg_impls() == [
        {"op": "factor", "impl": "chol_fused", "jitters": 4}]
    introspect.clear_introspection()
    assert not (introspect.kernel_builds() or introspect.linalg_impls()
                or introspect.compile_records())


def _kernels():
    return {(k["kernel"], k["impl"]) for k in introspect.kernel_builds()}


def test_every_wrapper_records_itself(ma):
    """The CPU paths of every entry point: each kernel wrapper's plain
    version recorded under the kernel's name, and one program a sampler
    or pool under its JAX label."""
    from gibbs_student_t_tpu_torch.parallel.ensemble import EnsembleGibbs
    from gibbs_student_t_tpu_torch.serve.pool import SlotPool

    cfg = GibbsConfig(model="mixture")
    TorchGibbs(ma, cfg, nchains=2, device="cpu").sample(niter=2, seed=0)
    TorchGibbs(ma, cfg, nchains=2, device="cpu", tnt_block_size=64,
               record="light").sample(niter=1, seed=0)
    TorchGibbs(ma, cfg.with_mtm(2), nchains=2, device="cpu").sample(
        niter=1, seed=0)
    EnsembleGibbs([ma, ma], cfg, nchains=2, device="cpu").sample(
        niter=1, seed=0)
    pool = SlotPool(ma, cfg, nlanes=16, quantum=1, device="cpu")
    recs, _, _ = pool.dispatch_quantum()
    pool.wire_host(recs)
    S = torch.eye(3).expand(16, 3, 3).contiguous()
    gid = torch.zeros(16, dtype=torch.int32)
    chol.chol_fused_lanes(S, torch.ones(16, 3), gid)
    chol.tri_solve_T_lanes(S, torch.ones(16, 3), gid)
    want = {"chol_fused", "tri_solve_T", "white_mh", "hyper_mh",
            "sweep_draws", "tnt_batched", "white_mtm", "white_mh_grouped",
            "hyper_mh_grouped", "tnt_lanes", "white_mh_lanes",
            "hyper_mh_lanes", "chol_fused_lanes", "tri_solve_T_lanes"}
    assert _kernels() == {(k, "plain") for k in want}
    labels = [r["label"] for r in introspect.compile_records()]
    assert labels == ["torchgibbs_chunk_c2"] * 3 + [
        "ensemble_grouped_chunk_p2_c2", "serve_pool_chunk_l16"]
    first = introspect.compile_records()[0]
    assert first["platform"] == "cpu" and first["peak_bytes"] is None
    assert {k["kernel"] for k in first["kernels"]} == {
        "chol_fused", "tri_solve_T", "white_mh", "hyper_mh", "sweep_draws"}
    assert {r["op"] for r in first["linalg_impls"]} == {
        "factor", "factor_robust", "bwd_vec", "schur_solves", "quad_logdet"}
    lines = introspect.format_summary("  # ")
    assert lines[0].startswith("  # program[torchgibbs_chunk_c2] "
                               "platform=cpu")
    assert any(ln.startswith("  # build libgst_cuda.so: not loaded")
               for ln in lines)
    named = {ln.split()[2] for ln in lines if ln.startswith("  # kernel ")}
    assert named == want
    assert lines[-1].startswith("  # linalg impls: bwd_vec=tri_solve_T")


def test_registry_event_and_manifest_block(ma, tmp_path):
    reg = MetricsRegistry(run_dir=str(tmp_path))
    reg.write_manifest(config={"a": 1}, seeds=0)
    TorchGibbs(ma, GibbsConfig(model="mixture"), nchains=2, device="cpu",
               chunk_size=2, metrics=reg).sample(niter=4, seed=0)
    reg.close()
    ev = [e for e in read_events(str(tmp_path)) if e["event"] == "compile"]
    assert len(ev) == 1 and ev[0]["label"] == "torchgibbs_chunk_c2"
    snap = [e for e in read_events(str(tmp_path))
            if e["event"] == "snapshot"][0]["metrics"]
    assert snap["counters"]["compiles_total"] == 1
    with open(tmp_path / "manifest.json") as fh:
        man = json.load(fh)
    schemas = port_schema.load_schemas()
    port_schema.assert_valid(man, schemas["manifest"], "manifest",
                             defs=schemas)
    assert man["cuda"]["n_programs"] == 1
    port_schema.assert_valid(man["cuda"], schemas["cuda_summary"],
                             "cuda block", defs=schemas)


def test_offswitch_records_nothing(ma, monkeypatch):
    monkeypatch.setenv("GST_INTROSPECT", "0")
    TorchGibbs(ma, GibbsConfig(model="mixture"), nchains=2,
               device="cpu").sample(niter=2, seed=0)
    assert not (introspect.kernel_builds() or introspect.linalg_impls()
                or introspect.compile_records())
    assert introspect.compile_summary()["n_programs"] == 0
    monkeypatch.setenv("GST_INTROSPECT", "no")
    with pytest.raises(ValueError, match="GST_INTROSPECT"):
        TorchGibbs(ma, GibbsConfig(model="mixture"), nchains=2,
                   device="cpu").sample(niter=2, seed=0)


#: lines of ``_build/ptxas.txt`` as the kernels' build wrote it on an
#: NVIDIA H100 80GB HBM3 (nvcc -Xptxas -v, sm_90a)
PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__94ff5e9f_7_chol_cu_d880538f18tri_solve_T_kernelILi5ELi1EEEvPKfS2_Pfii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__94ff5e9f_7_chol_cu_d880538f18tri_solve_T_kernelILi5ELi1EEEvPKfS2_Pfii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers
ptxas info    : Compile time = 109.667 ms
ptxas info    : Compiling entry function '_ZN39_GLOBAL__N__94ff5e9f_7_chol_cu_d880538f22chol_fused_warp_kernelILi3ELi4EEEvPKfS2_PfS3_S3_ii' for 'sm_90a'
ptxas info    : Function properties for _ZN39_GLOBAL__N__94ff5e9f_7_chol_cu_d880538f22chol_fused_warp_kernelILi3ELi4EEEvPKfS2_PfS3_S3_ii
    16 bytes stack frame, 12 bytes spill stores, 52 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 16 bytes cumulative stack size
ptxas info    : Compile time = 267.214 ms
ptxas info    : 272 bytes gmem
ptxas info    : Compiling entry function '_Z18sweep_draws_kernelPKxS0_iPKfiPfPK4int412DrawSegments' for 'sm_90a'
ptxas info    : Function properties for _Z18sweep_draws_kernelPKxS0_iPKfiPfPK4int412DrawSegments
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 60 registers, used 1 barriers, 40 bytes cumulative stack size, 13312 bytes smem
ptxas info    : Compile time = 176.931 ms
"""


def test_ptxas_parser_on_a_card_report():
    got = _cuda.parse_ptxas(PTXAS)
    # the anonymous namespace is left out, as the profiler's names show it
    assert [g["function"] for g in got] == [
        "tri_solve_T_kernel", "chol_fused_warp_kernel", "sweep_draws_kernel"]
    assert got[0] == {
        "function": "tri_solve_T_kernel",
        "symbol": "_ZN39_GLOBAL__N__94ff5e9f_7_chol_cu_d880538f18tri_solve_"
                  "T_kernelILi5ELi1EEEvPKfS2_Pfii",
        "registers": 40, "spill_stores": 0, "spill_loads": 0,
        "stack_bytes": 0, "smem_bytes": 0}
    fields = ("registers", "spill_stores", "spill_loads", "stack_bytes",
              "smem_bytes")
    assert [got[1][f] for f in fields] == [64, 12, 52, 16, 0]
    assert [got[2][f] for f in fields] == [60, 0, 0, 40, 13312]
    assert _cuda.parse_ptxas("") == []

"""The harness on the CPU: every name in BENCHMARK.json resolves to its
files, the traffic is the seed's and only the seed's, the result line
has the contract's keys, the trace's reduction counts each card's busy
time once, and a run with its timed path broken, or with the fp8
control in the program's place, reads `correct` false. Runs on the CPU
at batch 2 over a window of a few seconds: the program's plain versions
stand in for the kernels."""

import types

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from benchmark import harness, lowprec, trace, weights

SPEC = harness.benchmark_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
SMALL = {"batch": 2, "pool": 2, "warmup_results": 2, "warmup_s": 0.3,
         "queue_depth": 2, "trace_seconds": 1.0}
SEED = 2**31 + 3


def small_cell(name):
    cell = harness.load_cell(name, SMALL)
    cell.spec["check"]["sample"] = 6
    return cell


def run_small(name, trace=False, seed=SEED):
    cell = small_cell(name)
    devices = [torch.device("cpu")] * (len(cell.spec.get("cuts", [])) + 1)
    return harness.run_cell(cell, seed, 3.0, trace, devices, harness.clock())


def test_benchmark_json_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = ([c["name"] for c in SPEC["configs"]] + CELLS
             + [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    pairs = [(c["config"], c["traffic"]) for c in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert c.spec["config"] == entry["config"]
    assert c.spec["traffic"] == entry["traffic"]
    assert int(c.spec["chips"]) == entry["chips"]
    assert c.spec["chips"] == len(c.spec.get("cuts", [])) + 1
    cfg = next(x for x in SPEC["configs"] if x["name"] == entry["config"])
    with open(os.path.join(harness.ROOT, cfg["file"])) as f:
        assert json.load(f)["name"] == cfg["name"]
    for fn in ("entries", "entry_shape", "images_per_result", "prepare",
               "drive", "report"):
        assert callable(getattr(c.kind, fn))
    assert harness.end_to_end_metrics(cell)
    assert any(m["name"] != "setup_s" for m in harness.end_to_end_metrics(cell))
    assert harness.per_layer_metrics(cell)


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_per_layer_metric_has_its_reader(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    assert callable(harness.load_module("metrics", metric).read)
    moved = {e["name"]: e for e in SPEC["end_to_end"]}[m["moves"]]
    for cell in m["workloads"]:
        assert cell in CELLS
        assert cell in moved.get("workloads", CELLS)


def test_closed_stream_inputs_are_the_seeds():
    mix = {"batch": 2, "pool": 3, "image": [4, 4, 3]}
    kind = harness.load_module("traffic", "closed_stream")
    shape = kind.entry_shape(mix)
    cpu = torch.device("cpu")
    a = weights.host_entries(7, 3, shape, cpu, pinned=False)
    b = weights.input_entries(7, 3, shape, cpu)
    c = weights.host_entries(8, 3, shape, cpu, pinned=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert not torch.equal(a[0], a[1])


@pytest.mark.parametrize("cell", ["resnet50.offline_b128",
                                  "vit_b16.offline_b128"])
def test_result_line_has_the_contract_keys(cell):
    res = run_small(cell)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "check"
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] > 0
    want = {m["name"] for m in harness.end_to_end_metrics(cell)}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["check"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_result_reports_per_layer_metrics():
    cell = "resnet50.offline_b128"
    res = run_small(cell, trace=True)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"])
    names = {m["name"] for m in harness.per_layer_metrics(cell)}
    # The CPU has no device trace and no peak: every reader finds
    # nothing and is left out, and the stretch still ran.
    assert set(res["metrics"]) <= names
    assert res["device"]["window_s"] >= 1.0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _event(device, start, end, name):
    return types.SimpleNamespace(
        device_type=torch.autograd.DeviceType.CUDA, device_index=device,
        name=name, time_range=types.SimpleNamespace(start=start, end=end))


def test_reduce_counts_each_cards_busy_time_once():
    """Over a 1 s stretch: card 0 runs two overlapping kernels and a copy
    (busy 0.5 s), card 1 one kernel that began before the stretch (0.2 s
    inside it); host calls and ranges on the device are not work."""
    cpu_call = types.SimpleNamespace(
        device_type=torch.autograd.DeviceType.CPU, device_index=-1,
        name="cudaLaunchKernel", time_range=types.SimpleNamespace(start=0, end=9e5))
    events = [
        _event(0, 100e3, 300e3, "sm90_xmma_fprop_implicit_gemm_5x_cudnn"),
        _event(0, 200e3, 400e3, "nvjet_tst_256x128_64x4_1x2_h"),
        _event(0, 700e3, 800e3, "Memcpy HtoD (Pinned -> Device)"),
        _event(1, -100e3, 200e3, "elementwise_kernel<addcmul_cuda_kernel>"),
        _event(0, 0, 1e6, "ProfilerStep#1"),
        cpu_call,
    ]
    t = trace.reduce(torch, events, 1.0, [0, 1])
    assert t.busy_s == pytest.approx((0.4 + 0.2) / 2)
    assert t.family_ms == pytest.approx(
        {"conv": 200.0, "matmul": 200.0, "copies": 100.0, "pointwise": 200.0})
    # The kernel cut by the stretch's start counts as busy, not as a call.
    assert "elementwise_kernel<addcmul_cuda_kernel>" not in t.kernel_calls
    gaps = dict(t.breakdown["idle_gaps"])
    assert gaps == pytest.approx({
        "waiting for sm90_xmma_fprop_implicit_gemm_5x_cudnn": 0.1,
        "waiting for Memcpy HtoD (Pinned -> Device)": 0.3,
        "the stretch's end": 0.2})
    cell = harness.load_cell("resnet50.chain4_b128")
    reg = {"stretch_start": {"counters": {trace.MICROBATCHES: 10}},
           "stretch_end": {"counters": {trace.MICROBATCHES: 20}}}
    ctx = trace.Context(cell=cell, outcome=None, traced=t, registry=reg,
                        device={"kind": "NVIDIA H100 80GB HBM3"})
    assert ctx.idle_share_pct() == pytest.approx(70.0)
    assert ctx.per_microbatch_ms("conv", "matmul") == pytest.approx(40.0)
    assert harness.load_module("metrics", "device_ms.conv").read(ctx) == (
        pytest.approx(40.0))


@pytest.mark.parametrize("kernel,fam", [
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_optimized_"
     "bf16_256x64_32x4_nhwc_align8>(", "conv"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
     "128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn", "conv"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
     "(cudnnKernelDataType_t)0>(int", "conv"),
    ("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_bias_NNN", "matmul"),
    ("void (anonymous namespace)::flash_fwd_wgmma<__nv_bfloat16, 1>(", "attention"),
    ("Memcpy PtoP (Device -> Device)", "copies"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc<c10::"
     "BFloat16, int>(", "pool"),
    ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_"
     "nocast<at::native::addcmul_cuda_kernel(", "pointwise"),
    ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<"
     "float, float, false>(", "pointwise"),
])
def test_kernels_are_classed_by_name(kernel, fam):
    assert trace.family(kernel) == fam


def _alter_row0(monkeypatch, cell):
    from defer_tpu_torch.parallel.pipeline import Pipeline

    orig = Pipeline.__call__

    def altered(self, x):
        out = orig(self, x).clone()
        out[0] = out[0].flip(-1)
        return out

    monkeypatch.setattr(Pipeline, "__call__", altered)


def _drop_hops(monkeypatch, cell):
    """The activation never crosses to the next stage: what arrives
    there is zeros (the input, float32, still reaches stage 0)."""
    from defer_tpu_torch.parallel.pipeline import Pipeline

    orig = Pipeline._place

    def dropped(x, dev):
        if isinstance(x, torch.Tensor) and x.dtype != torch.float32:
            return torch.zeros_like(x)
        return orig(x, dev)

    monkeypatch.setattr(Pipeline, "_place", staticmethod(dropped))


def _serve_fp8_reference(monkeypatch, cell):
    """The control in the program's place: every microbatch is served
    by the reference in fp8, on the run's own weights and inputs."""
    from defer_tpu_torch.parallel.pipeline import Pipeline

    c = small_cell(cell)
    cfg, ref = c.config, c.reference
    w = weights.draw(ref.param_specs(cfg), cfg["init"], SEED,
                     torch.device("cpu"), getattr(torch, cfg["compute_dtype"]))

    def control(self, x):
        with torch.no_grad():
            return ref.forward(cfg, w, x.float(), quantize=lowprec.fp8)

    monkeypatch.setattr(Pipeline, "__call__", control)


@pytest.mark.parametrize("cell,fault", [
    ("resnet50.offline_b128", _alter_row0),
    ("vit_b16.offline_b128", _alter_row0),
    ("resnet50.chain4_b128", _alter_row0),
    ("resnet50.chain4_b128", _drop_hops),
    ("resnet50.offline_b128", _serve_fp8_reference),
    ("vit_b16.offline_b128", _serve_fp8_reference),
])
def test_a_broken_timed_path_reads_incorrect(cell, fault, monkeypatch):
    fault(monkeypatch, cell)
    res = run_small(cell)
    assert res["correct"] is False
    assert res["check"]["row_rel_err_max"]["value"] > (
        res["check"]["row_rel_err_max"]["limit"])


def test_run_py_refuses_without_a_card():
    """The command exits non-zero with no result line on a machine
    without CUDA, and in a directory without the program."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
         CELLS[0], "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, env=env,
        stdin=subprocess.DEVNULL, cwd=harness.ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    """A short run of each cell through the command, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chips = harness.load_json("workloads", f"{cell}.json")["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA cards")
    out = subprocess.run(
        [sys.executable, os.path.join(harness.BENCH, "run.py"), "--workload",
         cell, "--seed", str(2**31 + 17), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, stdin=subprocess.DEVNULL,
        cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True

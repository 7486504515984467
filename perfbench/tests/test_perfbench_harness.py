"""The harness on the CPU: the result line's keys, a run with no card,
the modules a run loads, and the kernel families."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny
from perfbench.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_result_keys_untraced():
    res, obs = tiny.run(tiny.cell("olmo1b_quafl_b8"))
    assert list(res) == KEYS + ["checks"]
    assert set(res["metrics"]) == {"rounds_per_s", "mfu", "peak_mem_gb",
                                   "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert 0 < res["metrics"]["mfu"]["value"] <= 100
    assert obs["check_rounds"] == 2


def test_result_keys_traced():
    res, _ = tiny.run(tiny.cell("mlp_quafl_paper"), trace=True)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no operation ran on a card: the device metrics say
    # nothing rather than 0
    assert "exchange_roofline" not in res["metrics"]
    assert "device_idle_share" not in res["metrics"]
    assert "round_mfu" not in res["metrics"]


def test_mlp_cell_reports_no_memory_metric():
    res, _ = tiny.run(tiny.cell("mlp_quafl_paper"))
    assert set(res["metrics"]) == {"rounds_per_s", "mfu", "setup_s"}


def test_a_run_without_the_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         "mlp_quafl_paper", "--seed", str(2**33), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, json\n"
        "from perfbench.tests import tiny\n"
        "tiny.run(tiny.cell('olmo1b_quafl_b8'))\n"
        "tiny.run(tiny.cell('mlp_quafl_paper'), trace=True)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:"
                                  f"{ROOT}"))
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_kernel_families_partition_a_recorded_trace():
    rec = json.loads((ROOT / "perfbench" / "tests" / "data"
                      / "recorded_ops.json").read_text())["ops"]
    cell = harness.find_cell(ROOT, "olmo1b_quafl_b8")
    fams = [cell.metric(n) for n in ("exchange_ms_per_round",
                                     "model_kernels_ms_per_round",
                                     "other_kernels_ms_per_round")]
    for op in rec:
        assert sum(bool(f.member(op["name"])) for f in fams) == 1, op
    kernels, t = [], 0.0
    for op in rec:
        kernels.append((op["name"], t, t + op["seconds"] * 1e6))
        t += op["seconds"] * 1e6 + 5.0
    ctx = harness.TraceCtx(kernels=kernels, host=[], rounds=4,
                           window_s=t * 1e-6, exchange_bytes_per_round=1e9,
                           model_flops=1.0, peak_flops=1.0,
                           device_name="NVIDIA H100 80GB HBM3")
    total = sum(op["seconds"] for op in rec) * 1e3 / 4
    assert sum(f.read(ctx) for f in fams) == pytest.approx(total, rel=1e-9)
    for name in ("cutlass::Kernel2<cutlass_80_simt_sgemm_128x128>",
                 "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT",
                 "flash_fwd_kernel", "sm90_xmma_gemm_bf16bf16"):
        assert fams[1].member(name)
    assert fams[0].member("void (anonymous namespace)::"
                          "quantize_vec_kernel<8>(float const*)")


def test_busy_seconds_is_the_union_of_intervals():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 25.0),
           ("d", 21.0, 22.0)]
    assert harness.busy_seconds(ops) == pytest.approx(20e-6)
    gaps = harness.idle_gaps(ops, [("host_op", 14.0, 30.0)])
    assert gaps == [["host:host_op", pytest.approx(5e-6)]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mlp_quafl_paper", "olmo1b_quafl_b8"])
def test_cell_runs_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
         name, "--seed", str(2**33 + 1), "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

"""The result's last line, the checks beside their limits, the import
check, and a run that finds no card."""
import json
import os
import subprocess
import sys

from joinbench import harness

OUT = {"correct": True, "attempted": 7, "failed": 0,
       "metrics": {"join_s": {"value": 1.5123456789, "unit": "s"}},
       "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                  "count": 1, "memory_peak_bytes": 123},
       "checks": {"mismatched_pairs": {"value": 0, "limit": 0}}}
ENV = {**os.environ, "PYTHONPATH": "", "CUDA_VISIBLE_DEVICES": ""}


def test_result_line_is_one_json_object_with_checks_last():
    line = harness.result_line(OUT)
    assert "\n" not in line
    back = json.loads(line)
    assert back == OUT
    assert list(back)[-1] == "checks"
    assert back["metrics"]["join_s"]["value"] == 1.5123456789


def test_check_lines_name_each_number_and_limit():
    assert harness.check_lines(OUT) == ["check mismatched_pairs: 0 (limit 0)"]


def _run(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          env=ENV, capture_output=True, text=True,
                          timeout=120)


def test_harness_and_reference_load_no_jax():
    """Loading the harness, the reference, the control, the trace reader
    and every metric reader (and the port, which the harness drives)
    leaves no top-level ``jax``, ``jaxlib``, ``flax`` or ``repro``."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from joinbench import harness, reference, control, trace, "
        "roofline, datagen\n"
        "for m in harness.load_benchmark()['end_to_end'] + "
        "harness.load_benchmark()['per_layer']:\n"
        "    harness.load_metric(m['name'])\n"
        "import repro_torch.spatial\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    got = _run(code)
    assert got.returncode == 0, got.stderr
    tops = set(json.loads(got.stdout.strip().replace("'", '"')))
    assert not tops & set(harness.FORBIDDEN)
    assert "repro_torch" in tops


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "from joinbench import reference, datagen, roofline\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    got = _run(code)
    assert got.returncode == 0, got.stderr
    tops = set(json.loads(got.stdout.strip().replace("'", '"')))
    assert not tops & ({"repro_torch"} | set(harness.FORBIDDEN))


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.spatial", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "repro.core", "flax", "repro_torch"]) == [
            "flax", "jax", "repro"]


def test_run_without_a_card_prints_no_result():
    got = subprocess.run(
        [sys.executable, "joinbench/run.py", "--workload",
         "t1xt2-intersects", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=harness.ROOT, env=ENV, capture_output=True,
        text=True, timeout=120)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "no CUDA device" in got.stderr

"""The port's examples (``examples_torch/``) run in process on the CPU at
smoke size, each through its ``main(argv)`` with ``--device cpu``; where a
twin reports join pairs they equal the JAX package's staged numpy
``JoinPlan`` at the same size. A subprocess shows that importing them,
``chip_smoke.py`` and the port loads neither JAX nor the reference
package."""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.datagen import make_dataset as r_make_dataset  # noqa: E402
from repro.datagen import make_linestrings as r_make_linestrings  # noqa: E402
from repro.spatial import JoinPlan as RJoinPlan  # noqa: E402
from repro.spatial import selection_queries as r_selection  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples_torch"
NAMES = ("quickstart", "selection_and_within", "distributed_join",
         "serve_spatial", "serve_lm", "serve_pool", "train_lm")


def _example(name):
    """``examples_torch/<name>.py`` imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sorted(pairs):
    return pairs[np.lexsort(pairs.T[::-1])]


def _ref(R, S, method, predicate, n_order, **kw):
    res, _ = RJoinPlan(R, S, filter=method, n_order=n_order,
                       **kw).build().execute(predicate)
    return res


def test_examples_are_the_reference_examples_twins():
    assert sorted(p.stem for p in EXAMPLES.glob("*.py")) == sorted(NAMES)
    assert sorted(p.stem for p in (ROOT / "examples").glob("*.py")) \
        == sorted(NAMES)


def test_quickstart(capsys):
    got = _example("quickstart").main([
        "--device", "cpu", "--count-r", "80", "--count-s", "160",
        "--n-order", "7"])
    out = capsys.readouterr().out
    assert "verdict: TRUE HIT" in out and "the SAME join result" in out
    R0 = r_make_dataset("T1", count=80)
    S0 = r_make_dataset("T2", count=160)
    assert sorted(got) == ["april", "none", "ri"]
    for method, res in got.items():
        want = _ref(R0, S0, method, "intersects", 7)
        assert len(want) > 100
        np.testing.assert_array_equal(res, want, err_msg=method)


def test_selection_and_within(capsys):
    got = _example("selection_and_within").main([
        "--device", "cpu", "--count", "120", "--roads", "200",
        "--counties", "6", "--n-order", "7"])
    data = r_make_dataset("T1", count=120)
    counties = r_make_dataset("T3", count=6)
    small = r_make_dataset("T2", count=120)
    roads = r_make_linestrings(count=200)
    want_sel, _ = r_selection(data, counties, method="april", n_order=7)
    assert len(got["selection"]) == 6
    for a, b in zip(got["selection"], want_sel):
        np.testing.assert_array_equal(a, b)
    for pred in ("within", "intersects"):
        want = _ref(small, counties, "ri", pred, 7)
        assert len(want) > 0
        np.testing.assert_array_equal(got[pred], want, err_msg=pred)
    want = _ref(roads, counties, "april", "linestring", 7, r_kind="line")
    assert len(want) > 0
    np.testing.assert_array_equal(got["linestring"], want)
    assert "linestring:" in capsys.readouterr().out


def test_distributed_join(capsys):
    got = _example("distributed_join").main([
        "--device", "cpu", "--count-r", "120", "--count-s", "200",
        "--n-order", "7"])
    assert "[resume] 4 partitions already joined" in capsys.readouterr().out
    want = _sorted(_ref(r_make_dataset("T1", seed=0, count=120),
                        r_make_dataset("T2", seed=1, count=200), "april",
                        "intersects", 7))
    assert len(want) > 100
    for key in ("april", "resumed", "ri"):
        np.testing.assert_array_equal(_sorted(got[key]), want, err_msg=key)


def test_serve_spatial(capsys):
    _example("serve_spatial").main([
        "--device", "cpu", "--count", "60", "--n-queries", "10",
        "--queries", "12", "--mutate-every", "5", "--n-order", "7"])
    report = json.loads(capsys.readouterr().out)
    assert report["device"] == "cpu" and report["n_requests"] == 12
    assert report["results_total"] > 0
    assert report["service"]["inserts"] == report["service"]["deletes"] == 2


def test_serve_pool(capsys):
    _example("serve_pool").main(["--device", "cpu", "--requests", "3",
                                 "--max-new", "4"])
    assert "served 3/3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-small",
                                  "llama-3.2-vision-11b"])
def test_serve_lm(arch):
    """The default model, and one with encoder frames and one with patch
    tokens."""
    from repro_torch.configs import get_config
    out = _example("serve_lm").main(["--device", "cpu", "--arch", arch,
                                     "--batch", "2", "--prompt-len", "5",
                                     "--steps", "3"])
    vocab = get_config(arch, smoke=True).vocab
    assert out.shape == (2, 3) and out.device.type == "cpu"
    assert int(out.min()) >= 0 and int(out.max()) < vocab


def test_train_lm_resumes(tmp_path, capsys):
    train = _example("train_lm").main
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    first = train(argv + ["--steps", "3"])
    assert len(first) == 3 and all(np.isfinite(first))
    more = train(argv + ["--steps", "5"])
    assert len(more) == 2 and all(np.isfinite(more))
    assert "[resume] restored checkpoint at step 3" in capsys.readouterr().out
    assert train(argv + ["--steps", "5"]) == []


@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_the_card(name):
    """Without ``--device`` each twin runs on the card and raises without
    one; it never carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    argv = {"train_lm": ["--steps", "1"],
            "serve_spatial": ["--queries", "1"]}.get(name, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main(argv)


def test_examples_import_neither_jax_nor_the_reference():
    """Every twin, ``chip_smoke.py`` and every module of the port,
    imported in one fresh process."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "from pathlib import Path\n"
        "import repro_torch\n"
        "paths = sorted(Path(sys.argv[1]).glob('*.py'))\n"
        "paths.append(Path(sys.argv[2]))\n"
        "for p in paths:\n"
        "    spec = importlib.util.spec_from_file_location(p.stem, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__,\n"
        "                               'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(len(paths), bad)\n")
    out = subprocess.run([sys.executable, "-c", code, str(EXAMPLES),
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         timeout=300, check=True).stdout.split()
    assert out == [str(len(NAMES) + 1), "[]"], out

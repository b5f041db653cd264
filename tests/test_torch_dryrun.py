"""The port's dry run, roofline and report held to the JAX package's on the
CPU: ``model_flops`` of every (arch x shape) cell; ``shape_bytes`` and
``collective_bytes`` on the HLO text of the reference's
``tests/test_dryrun_small.py``; ``report.py``'s tables byte for byte from
the same cell dicts; the ``RooflineReport`` fields and ``to_dict`` keys.
Then, in a subprocess (the dry run owns the default process group), a
smoke cell as the reference's ``test_dryrun_cell_smoke`` runs one:
gemma2-2b smoke, vocab 512, ``train_4k`` on a fake 4 x 2 mesh, with
FLOPs, bytes, memory and collective bytes counted, FLOPs over the ranks
at least the model's, a prefill and a decode cell, and a join cell; the
JSONs keep the reference's keys. All exact: the functions are copies and the counts integers.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.launch import report as r_report  # noqa: E402
from repro.launch import roofline as r_roofline  # noqa: E402
from repro import configs as r_configs  # noqa: E402

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun, report, roofline  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = list(r_configs.ARCHS)

HLO = '''
  %ag = bf16[8,128]{1,0} all-gather(bf16[1,128] %x), dimensions={0}
  %ar.1 = f32[256]{0} all-reduce(f32[256] %y), to_apply=%sum
  %t = (f32[16,16]{1,0}, f32[16,16]{1,0}) all-to-all(f32[16,16] %a, f32[16,16] %b)
  %cp = u32[64]{0} collective-permute(u32[64] %z), source_target_pairs={{0,1}}
  %rs = bf16[2,128]{1,0} reduce-scatter(bf16[16,128] %w), dimensions={0}
  %dot = f32[128,128]{1,0} dot(f32[128,8] %p, f32[8,128] %q)
  %s = f32[4,4]{1,0} all-reduce-start(f32[4,4] %v), to_apply=%sum
'''


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, shape):
    assert SHAPES[shape] == r_configs.SHAPES[shape]
    got = roofline.model_flops(get_config(arch), shape, SHAPES)
    want = r_roofline.model_flops(r_configs.get_config(arch), shape,
                                  r_configs.SHAPES)
    assert got == want and got > 0


@pytest.mark.parametrize("text", [HLO] + [ln for ln in HLO.splitlines()
                                         if ln.strip()])
def test_hlo_parsers_match_reference(text):
    assert roofline.collective_bytes(text) == r_roofline.collective_bytes(text)
    assert roofline.shape_bytes(text) == r_roofline.shape_bytes(text)


def _report(cls, **kw):
    base = dict(arch="gemma2-2b", shape="train_4k", mesh="16x16", chips=256,
                flops_per_chip=3.1e14, bytes_per_chip=2.2e12,
                coll_bytes_per_chip=4.5e10,
                coll_breakdown={"all-gather": 2.5e10, "all-reduce": 2e10},
                model_flops_global=1.3e16, memory_per_chip_bytes=4.1e10,
                compile_seconds=3.5)
    base.update(kw)
    return cls(**base)


def test_report_fields_and_keys_match_reference():
    got, want = _report(roofline.RooflineReport), \
        _report(r_roofline.RooflineReport)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert list(got.to_dict()) == list(want.to_dict())
    # the same terms on the card's rates
    assert got.t_memory == got.bytes_per_chip / 3.35e12
    assert got.t_collective == got.coll_bytes_per_chip / 450e9
    assert got.t_compute == got.flops_per_chip / 989e12
    got.peak_flops = roofline.PEAK_FLOPS_F32
    assert got.t_compute == got.flops_per_chip / 67e12
    assert "peak_flops" not in got.to_dict()


def _cells():
    out = []
    for i, (mesh, arch, shape) in enumerate([
            ("16x16", "gemma2-2b", "train_4k"),
            ("2x16x16", "gemma2-2b", "train_4k"),
            ("16x16", "april_join", "join_256k"),
            ("16x16", "falcon-mamba-7b", "prefill_32k"),
            ("4x2", "smollm-135m", "train_4k")]):
        out.append(_report(roofline.RooflineReport, mesh=mesh, arch=arch,
                           shape=shape, flops_per_chip=1.7e13 * (i + 1),
                           bytes_per_chip=9.1e11 / (i + 1),
                           compile_seconds=float(i)).to_dict())
    out.append({"arch": "gemma2-2b", "shape": "long_500k", "mesh": "single",
                "skipped": "full-attention arch: 500k context is quadratic "
                           "(run only for SSM/hybrid per assignment)"})
    return out


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "4x2"])
def test_report_tables_match_reference(mesh):
    cells = _cells()
    assert report.roofline_table(cells, mesh) == \
        r_report.roofline_table(cells, mesh)
    assert report.dryrun_table(cells) == r_report.dryrun_table(cells)
    for x in (0.0031, 9.99, 12.5):
        assert report.fmt_t(x) == r_report.fmt_t(x)


def test_report_main_matches_reference(tmp_path, capsys, monkeypatch):
    for i, c in enumerate(_cells()):
        (tmp_path / f"c{i}.json").write_text(json.dumps(c))
    monkeypatch.setattr(sys, "argv", ["report", str(tmp_path)])
    r_report.main()
    want = capsys.readouterr().out
    report.main()
    assert capsys.readouterr().out == want


def test_xla_only_flags_raise(tmp_path):
    for flag in ("q_chunk", "moe_groups"):
        with pytest.raises(ValueError, match="--" + flag.replace("_", "-")):
            dryrun.run_cell("gemma2-2b", "train_4k", False, str(tmp_path),
                            **{flag: 2})


_CELL = """
import dataclasses, json, sys
from repro_torch.configs import get_config, SHAPES
from repro_torch.launch import dryrun as dr
cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True), vocab=512)
res = dr.run_model_cell(cfg, SHAPES["train_4k"], dr.cell_mesh(
    mesh_shape=(4, 2)), arch="gemma2-2b", shape_name="train_4k")
join = dr.run_cell("april_join", "join_256k", False, sys.argv[1])
decode = dr.run_model_cell(cfg, SHAPES["decode_32k"], dr.cell_mesh(
    mesh_shape=(4, 2)), arch="gemma2-2b", shape_name="decode_32k")
prefill = dr.run_model_cell(cfg, SHAPES["prefill_32k"], dr.cell_mesh(
    mesh_shape=(4, 2)), arch="gemma2-2b", shape_name="prefill_32k")
print(json.dumps({"cell": res, "join": join, "decode": decode,
                  "prefill": prefill}))
"""


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    r = subprocess.run([sys.executable, "-c", _CELL, str(out)],
                       capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                            "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1]), out


def _reference_keys():
    keys = set(_report(r_roofline.RooflineReport).to_dict())
    return keys | {"memory_detail", "hlo_collective_ops", "raw_scan_metrics",
                   "lower_seconds"}


def test_dryrun_cell_smoke(cells):
    res = cells[0]["cell"]
    assert _reference_keys() <= set(res)
    assert res["mesh"] == "4x2" and res["chips"] == 8
    assert res["flops_per_chip"] > 0 and res["bytes_per_chip"] > 0
    assert res["memory_per_chip_bytes"] > 0
    assert res["bottleneck"] in ("compute", "memory", "collective")
    # the mesh's collectives are counted, and the ranks' FLOPs cover the
    # model's (remat's recompute and the split heads' work on top)
    assert sum(res["coll_breakdown"].values()) > 0
    assert res["coll_breakdown"]["all-reduce"] > 0
    assert res["flops_per_chip"] * res["chips"] >= res["model_flops_global"]
    cfg = dataclasses.replace(get_config("gemma2-2b", smoke=True),
                                     vocab=512)
    assert res["model_flops_global"] == roofline.model_flops(
        cfg, "train_4k", SHAPES)
    mem = res["memory_detail"]
    assert mem["params"] == mem["grads"] > 0 and mem["saved_for_backward"] > 0


def test_join_cell_keeps_the_reference_keys(cells):
    join, out = cells[0]["join"], cells[1]
    assert _reference_keys() <= set(join)
    B, I = dryrun.JOIN_SHAPES["join_256k"]
    rows = B // 16
    assert join["bytes_per_chip"] == rows * ((8 * I + 4) * 4 + 4)
    assert join["coll_breakdown"] == {"all-reduce": 12}
    assert json.loads((out / "april_join__join_256k__single.json")
                      .read_text()) == join


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_serving_cells_run(cells, mode):
    """A prefill cell runs the forward to the last logits, a decode cell
    one decode step on caches laid out by ``cache_specs``."""
    res = cells[0][mode]
    assert _reference_keys() <= set(res)
    assert res["flops_per_chip"] > 0 and res["bytes_per_chip"] > 0
    assert res["coll_breakdown"]["all-reduce"] > 0
    assert res["flops_per_chip"] * res["chips"] >= res["model_flops_global"]
    if mode == "decode":
        # the caches of 128 sequences of 32768 over 4 data ranks
        assert res["memory_detail"]["caches"] > 0

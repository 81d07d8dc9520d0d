"""The harness is driven by data: in a copy of the benchmark, a new
configuration, traffic mix, cell, metric and kernel count added as new
files (and entries of BENCHMARK.json) are listed and loaded by name,
with no file of the benchmark edited; a configuration whose slice QPs
vary (CRF) runs through the harness and its check as files only."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys
from types import SimpleNamespace
from portbench import catalog
cell = catalog.cell("superfast-pan-s8")
cfg = catalog.config(cell["config"])
tr = catalog.traffic(cell["traffic"])
gen = catalog.generator(tr["generator"])
names = [m["name"] for m in catalog.metrics_of("superfast-pan-s8", False)]
per = [m["name"] for m in catalog.metrics_of("superfast-pan-s8", True)]
r = SimpleNamespace(frames_done=10, window_s=2.0, S=8, W=64, H=48,
                    me_range=16, config=cfg)
fams = sorted({k.ROOFLINE for k in catalog.kernels()})
print(json.dumps({"qp": cfg["slice_qp"]["P"], "streams": tr["streams"],
                  "scene_ok": tr["scene"] in gen.SCENES, "e2e": names,
                  "per_layer": per, "value": catalog.metric(
                      "frames_per_call").read(r), "fams": fams,
                  "limits": catalog.workload("superfast-pan-s8")["limits"]}))
"""


def copy_benchmark(tmp_path):
    """A checkout holding BENCHMARK.json and portbench/ -> (its root,
    portbench/, the bytes of every file it holds)."""
    dst = tmp_path / "checkout"
    dst.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = dst / "portbench"
    return dst, pb, {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}


def run_probe(dst: Path, probe: str, timeout: int = 120) -> dict:
    out = subprocess.run([sys.executable, "-c", probe], cwd=dst,
                         capture_output=True, text=True, timeout=timeout,
                         env={"PYTHONPATH": f"{dst}:{ROOT}",
                              "PATH": "/usr/bin", "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_cell_config_metric_and_kernel_as_files(tmp_path):
    dst, pb, before = copy_benchmark(tmp_path)
    cfg = json.loads((pb / "configs" / "batch-superfast.json").read_text())
    cfg.update(name="batch-qp30", slice_qp={"I": 27, "P": 30})
    cfg["param"]["rc.i_qp_constant"] = 30
    (pb / "configs" / "batch-qp30.json").write_text(json.dumps(cfg))
    tr = json.loads((pb / "traffic" / "pan-s32.json").read_text())
    tr["streams"] = 8
    (pb / "traffic" / "pan-s8.json").write_text(json.dumps(tr))
    wl = json.loads((pb / "workloads" / "superfast-pan-s32.json")
                    .read_text())
    (pb / "workloads" / "superfast-pan-s8.json").write_text(json.dumps(wl))
    (pb / "metrics" / "frames_per_call.py").write_text(
        "def read(r):\n    return r.frames_done / r.S\n")
    (pb / "kernels" / "deblock.py").write_text(
        'ROOFLINE = "deblock"\nDEVICE_KERNELS = ("deblock_kernel",)\n\n\n'
        "def work(r):\n    return 2 * r.S * r.W * r.H, 0\n")
    b = json.loads((dst / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "batch-qp30", "source": "x264 --qp 30",
                         "file": "portbench/configs/batch-qp30.json",
                         "reduced": [], "why": "a probe"})
    b["workloads"].append({"name": "superfast-pan-s8", "config": "batch-qp30",
                           "traffic": "pan-s8", "chips": 1, "why": "probe"})
    b["per_layer"].append({"name": "frames_per_call", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "pipeline", "moves": "fps",
                           "workloads": ["superfast-pan-s8"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    got = run_probe(dst, PROBE)
    assert got["qp"] == 30 and got["streams"] == 8 and got["scene_ok"]
    assert got["e2e"] == ["fps", "slot_ms_p90", "setup_s"]
    assert got["per_layer"] == ["frames_per_call"]
    assert got["value"] == 10 / 8
    assert got["fams"] == ["deblock", "sad", "windows"]
    assert got["limits"] == wl["limits"]
    # no file of the benchmark was edited, only files added
    for p, data in before.items():
        assert p.read_bytes() == data, p


CRF_PROBE = r"""
import json
from portbench import check, harness
qps = set()
header_faults = check.header_faults


def spy(slots, cfg, sps, pps, ref):
    for _, streams in slots:
        for nals in streams:
            qps.update(ref.parse_slice_header(n, sps, pps)[0]["qp"]
                       for n in nals)
    return header_faults(slots, cfg, sps, pps, ref)


check.header_faults = spy
small = {"config": {"width": 128, "height": 96},
         "traffic": {"streams": 2, "ring": 4},
         "workload": {"sample_p_frames": 3}}
r = harness.run("crf23-pan-s2", 2**33 + 5, 0.6, False, device="cpu",
                overrides=small, log=lambda m: None)
r["qps"] = sorted(qps)
print(json.dumps(r))
"""


def test_config_of_varying_slice_qps_runs_as_files(tmp_path):
    """A CRF configuration (x264's default --crf 23: slice QPs that vary
    by frame and stream) with its cell, added as new files, runs through
    the harness and is judged correct by its own QP range."""
    dst, pb, before = copy_benchmark(tmp_path)
    cfg = json.loads((pb / "configs" / "batch-superfast.json").read_text())
    cfg["name"] = "batch-crf23"
    cfg["slice_qp"] = {"I": [10, 40], "P": [10, 45]}
    cfg["param"].update({"rc.i_rc_method": "RC_CRF",
                         "rc.f_rf_constant": 23.0, "rc.i_aq_mode": "AQ_NONE",
                         "rc.b_mb_tree": 0})
    (pb / "configs" / "batch-crf23.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "crf23-pan-s2.json").write_bytes(
        (pb / "workloads" / "superfast-pan-s32.json").read_bytes())
    b = json.loads((dst / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "batch-crf23", "source": "x264 --crf 23",
                         "file": "portbench/configs/batch-crf23.json",
                         "reduced": [], "why": "a probe"})
    b["workloads"].append({"name": "crf23-pan-s2", "config": "batch-crf23",
                           "traffic": "pan-s32", "chips": 1, "why": "probe"})
    (dst / "BENCHMARK.json").write_text(json.dumps(b))
    r = run_probe(dst, CRF_PROBE, timeout=300)
    assert r["correct"], r["checks"]
    assert r["checks"]["header_faults"] == [0, 0]
    # the slice QPs vary, so one exact QP per slice type would not hold
    assert len(r["qps"]) > 2, r["qps"]
    for p, data in before.items():
        assert p.read_bytes() == data, p

"""The harness finds configurations, cells, traffic mixes and metrics by
name from their files, and BENCHMARK.json keeps to the benchmark's
contract."""

import json
import re
import shutil
from pathlib import Path

import pytest

from slambench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_config_traffic_and_metric_is_found_by_name():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"]["name"] == w["config"] and cell["traffic"] is not None
        driver = harness.load_driver(cell["traffic"])
        assert all(callable(getattr(driver, f)) for f in ("make_probes", "replay", "traced_pass", "worst_ate"))
        assert all(callable(c.install) and callable(c.numbers) for c in harness.load_checks(cell))
        assert callable(harness.load_trajectory(cell["config"]["trajectory"]["kind"]))
        assert json.loads((ROOT / "slambench" / "cells" / f"{w['name']}.json").read_text())["traffic"] == w["traffic"]
        for trace in (False, True):
            for m in harness.cell_metrics(SPEC, w["name"], trace):
                assert callable(harness.load_metric(m["name"]))
    for c in SPEC["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"] and data["reduced"] == c["reduced"]


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path, monkeypatch):
    """A configuration, a trajectory kind, a traffic mix, a driver, a check,
    a cell and a metric, each added as a file, are found by name."""
    bench = tmp_path / "slambench"
    shutil.copytree(ROOT / "slambench", bench, ignore=shutil.ignore_patterns("__pycache__", "tests", "ref"))
    cell = json.loads((bench / "cells" / "kitti_stereo.seq.json").read_text())
    (bench / "traffic" / "seq_async.json").write_text(json.dumps(
        {**json.loads((bench / "traffic" / "seq.json").read_text()), "schedule": "default"}))
    (bench / "cells" / "kitti_stereo.seq_async.json").write_text(json.dumps({**cell, "traffic": "seq_async"}))
    (bench / "metrics" / "passes.py").write_text("def read(run):\n    return run.passes\n")
    monkeypatch.setattr(harness, "BENCH", bench)
    got = harness.load_cell("kitti_stereo.seq_async")
    assert got["traffic"]["schedule"] == "default" and got["config"]["name"] == "kitti_stereo"
    assert harness.load_metric("passes")(type("Run", (), {"passes": 3})) == 3
    with pytest.raises(FileNotFoundError):
        harness.load_cell("kitti_stereo.nothing")
    # A traffic file without a driver runs the stereo driver.
    assert harness.load_driver(got["traffic"]).CALL == "frame"

    # A mono deployment as files only: a configuration on a new trajectory
    # kind, a traffic mix naming a new driver, a cell listing a new check.
    config = json.loads((bench / "configs" / "kitti_stereo.json").read_text())
    (bench / "configs" / "mono_kitti.json").write_text(json.dumps(
        {**config, "name": "mono_kitti", "trajectory": {"kind": "spiral", "step_m": 0.5}}))
    (bench / "trajectories" / "spiral.py").write_text(
        "import numpy as np\n\n\ndef poses(n_frames, spec):\n"
        "    return [(np.eye(3), np.array([0.0, 0.0, -spec['step_m'] * i])) for i in range(n_frames)]\n")
    (bench / "drivers" / "mono.py").write_text(
        "CALL = 'frame'\n\n\ndef frames_per_call(cell):\n    return 1\n")
    (bench / "checks" / "mono_init.py").write_text(
        "def install(probes, cell, seed):\n    probes.installed = seed\n\n\n"
        "def numbers(probes, ctx, control=False):\n    return {'init_frame_gap': 0}\n")
    (bench / "traffic" / "mono_seq.json").write_text(json.dumps(
        {**json.loads((bench / "traffic" / "seq.json").read_text()), "driver": "mono"}))
    (bench / "cells" / "mono_kitti.mono_seq.json").write_text(json.dumps(
        {**cell, "config": "mono_kitti", "traffic": "mono_seq", "checks": ["mono_init"],
         "limits": {"init_frame_gap": 0}}))
    got = harness.load_cell("mono_kitti.mono_seq")
    assert harness.load_driver(got["traffic"]).frames_per_call(got) == 1
    poses = harness.load_trajectory(got["config"]["trajectory"]["kind"])(4, got["config"]["trajectory"])
    assert len(poses) == 4 and poses[3][1][2] == -1.5
    (check_mod,) = harness.load_checks(got)
    probes = type("Probes", (), {})()
    check_mod.install(probes, got, 7)
    assert probes.installed == 7 and check_mod.numbers(probes, None) == {"init_frame_gap": 0}
    # Without the run's frames_not_tracked the cell's limits are not all read: not correct.
    assert harness.decide(check_mod.numbers(probes, None), harness.cell_limits(got))[0] is False
    with pytest.raises(FileNotFoundError):
        harness.load_driver({"driver": "nothing"})
    with pytest.raises(FileNotFoundError):
        harness.load_checks({"checks": ["nothing"]})


def test_cell_metrics_follow_their_workloads_lists():
    lines = [m["name"] for m in harness.cell_metrics(SPEC, "kitti_stereo.seq", True)]
    assert "line_frontend_device_ms" not in lines and "point_frontend_device_ms" in lines
    assert "line_frontend_device_ms" in [m["name"] for m in harness.cell_metrics(SPEC, "euroc_stereo.seq", True)]
    assert [m["name"] for m in harness.cell_metrics(SPEC, "kitti_stereo.seq", False)] == ["frames_per_s", "setup_s"]


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32 and all(1 <= len(w) <= 200 for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [c["name"] for c in SPEC["configs"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert c["file"].startswith("slambench/") and len(c["reduced"]) <= 16
        assert "\n" not in c["source"] + c["why"] and "\t" not in c["source"] + c["why"]
    used = set()
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(names)
    cells = {w["name"] for w in SPEC["workloads"]}
    metric_names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        assert any(True for _ in harness.cell_metrics(SPEC, cell, True))
    # A full check of 24 cells at this window fits in 43,200 seconds.
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200

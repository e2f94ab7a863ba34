"""BENCHMARK.json and the files it names: they load, keep to the
benchmark's contract, and the generators and work counts they rest on
are what they claim."""

from __future__ import annotations

import json
import re

import pytest
import torch

from gpubench import harness, scenes
from gpubench.metrics import _work

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_file_loads(entry):
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    assert config["name"] == entry["name"]
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"] == []
    assert entry["file"].startswith("gpubench/configs/")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_spec_loads(cell):
    spec = harness.load_spec(cell)
    assert (harness.HERE / "drivers" / f"{spec.traffic['driver']}.py").exists()
    e2e = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert callable(harness.load_reader(m["name"]))
        assert m["moves"] in e2e
    assert set(spec.traffic["check"]["limits"])


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["configs"]:
        assert e["source"].startswith("https://") and len(e["source"]) <= 200
    for e in BENCH["workloads"]:
        assert e["chips"] == 1 and len(e["why"]) <= 200
        assert NAME.match(e["traffic"])
    for group in ("end_to_end", "per_layer"):
        for m in BENCH[group]:
            assert NAME.match(m["name"]) and UNIT.match(m["unit"])
            assert m["name"] not in names
            names.add(m["name"])
            assert m["better"] in ("lower", "higher")
            assert set(m["workloads"]) <= set(CELLS) if "workloads" in m \
                else True
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert len(m["workloads"]) == 1


def _dense_traffic():
    return json.loads((harness.HERE / "traffic" / "video.json").read_text())


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, -5])
def test_dense_scenes_follow_the_seed(seed):
    t = dict(_dense_traffic(), frames_per_clip=3)
    t["texture"] = dict(t["texture"], margin=8)
    a = scenes.dense_scenes(t, 40, 64, seed, "cpu")
    b = scenes.dense_scenes(t, 40, 64, seed, "cpu")
    c = scenes.dense_scenes(t, 40, 64, seed + 1, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (3, 40, 64) and a[0].dtype == torch.float32
    assert 0 <= float(a[0].min()) and float(a[0].max()) <= 255


def test_every_seed_asks_for_the_same_pairs():
    from gpubench.drivers import dense_pair
    from gpubench.tests._tiny import tiny_spec

    spec = tiny_spec("dense1080.pair", dense_hw=(24, 40))
    orders = []
    for seed in (1, 2 ** 31 + 1):
        cell = dense_pair.Cell(spec.config, spec.traffic, seed, "cpu")
        cell.make_inputs()
        orders.append(cell.order)
    assert orders[0] != orders[1]
    assert sorted(orders[0]) == sorted(orders[1])


# PERF.md's kernel table prints these bounds (ms) from shapes alone.
@pytest.mark.parametrize("got, want", [
    (lambda: _work.pyramid_bound(5, (1080, 1920), (1088, 2048), 3), "0.0300"),
    (lambda: _work.pyramid_bound(2, (1080, 1920), (1088, 2048), 3), "0.0120"),
    (lambda: _work.pyramid_bound(64, (483, 860), (483, 860), 2), "0.0417"),
    (lambda: _work.finish_bound(1024, 483, 860), "0.635"),
    (lambda: _work.gather_bound(1280, 15, 15, 32, 48), "0.0064"),
    (lambda: _work.level_bound(4, 1088, 2048, 1, True, True), "0.061"),
], ids=["pyramid_chunk", "pyramid_pair", "pyramid_tracker", "finish",
        "window_gather", "fused_level_L0_K4"])
def test_work_counts_reproduce_the_kernel_table(got, want):
    seconds, by = got()
    assert by == "bytes"
    digits = len(want.split(".")[1])
    assert f"{seconds * 1e3:.{digits}f}" == want


def test_cell_work_counts():
    config = json.loads((harness.HERE / "configs" / "dense1080.json")
                        .read_text())
    assert _work.level_sizes(1080, 1920, 4) == [
        (1080, 1920), (540, 960), (270, 480), (135, 240)]
    assert 17e-6 < _work.dense_levels_s(config) < 20e-6
    # a clip of 33 pairs reads its 34 frames once per level, not 66
    clip = _work.dense_levels_s(config, 33, clip=True)
    assert 1.20 < 33 * _work.dense_levels_s(config) / clip < 1.21
    assert 3.2e-6 < _work.dense_frame_pyramid_s(config) < 3.4e-6

"""The benchmark as data: BENCHMARK.json keeps its contract, every cell,
configuration, mix and metric loads by name, and a new one is a new file."""

import json
import re
import shutil

import pytest

from h100bench import cells

SPEC = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["h100bench"]
    assert len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    assert len(json.dumps(SPEC).encode()) <= 64 * 1024


def test_names_units_and_lines():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in SPEC["workloads"]] + \
            [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for item in SPEC["workloads"] + SPEC["configs"]:
        assert _line(item["why"])
    for m in SPEC["per_layer"]:
        assert _line(m["layer"])


def test_metric_keys_sources_and_bounds():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
            assert cell in moved.get("workloads", CELLS)


def test_every_cell_reports_enough():
    for name in CELLS:
        cell = cells.load(name)
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_run_seconds_fits_24_cells():
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_and_chips():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["file"].startswith("h100bench/") and (cells.ROOT / c["file"]).exists()
        assert c["reduced"] == json.loads((cells.ROOT / c["file"]).read_text())["reduced"]
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"]) and four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = cells.load(name)
    assert cell.config["name"] and cell.mix["entry"] in ("extract", "generate")
    assert set(cell.limits) and all("limit" in v for v in cell.limits.values())


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metric_has_a_reader(name):
    assert callable(cells.reader(name))


@pytest.mark.parametrize("name", ["sd-2-1-base", "sdxl-base"])
def test_config_is_the_ports_preset(name):
    """The file runs the port's published preset: every size the same."""
    import dataclasses

    from gswm_torch.models.configs import PRESETS

    config = json.loads((cells.HERE / "configs" / f"{name}.json").read_text())
    preset = PRESETS[name]
    for part in ("unet", "vae", "text", "text2"):
        want = getattr(preset, part)
        want = None if want is None else json.loads(json.dumps(dataclasses.asdict(want)))
        assert config[part] == want, part
    assert config["prediction_type"] == preset.prediction_type
    assert config["default_resolution"] == preset.default_resolution


def test_a_new_cell_is_files_and_entries(tmp_path):
    """A cell, configuration, mix, limits and metric added as new files and a
    new entry load without an edit to any file that is there."""
    here = tmp_path / "h100bench"
    shutil.copytree(cells.HERE, here, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    config = json.loads((here / "configs" / "sd-2-1-base.json").read_text())
    config["name"] = "sd-2-1-base-copy"
    (here / "configs" / "sd-2-1-base-copy.json").write_text(json.dumps(config))
    mix = json.loads((here / "traffic" / "extract-512-b32.json").read_text())
    mix["batch"] = 4
    (here / "traffic" / "extract-512-b4.json").write_text(json.dumps(mix))
    (here / "limits" / "new-cell.json").write_text(
        (here / "limits" / "sd21base-512-extract-b32.json").read_text())
    (here / "metrics" / "new_metric.py").write_text("def read(run, name):\n    return 1.0\n")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "new-cell", "config": "sd-2-1-base-copy",
                              "traffic": "extract-512-b4", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "new_metric.extract", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "a test",
                              "moves": "extract_images_per_s", "workloads": ["new-cell"]})
    bench = tmp_path / "BENCHMARK.json"
    bench.write_text(json.dumps(spec))
    cell = cells.load("new-cell", bench=bench, here=here)
    assert cell.mix["batch"] == 4 and cell.config["name"] == "sd-2-1-base-copy"
    assert [m["name"] for m in cell.per_layer] == ["new_metric.extract"]
    assert cells.reader("new_metric.extract", here=here)(None, "new_metric.extract") == 1.0
    assert cells.load(CELLS[0], bench=bench, here=here).name == CELLS[0]

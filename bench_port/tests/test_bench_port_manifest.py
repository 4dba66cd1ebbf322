"""BENCHMARK.json against the benchmark's contract, and the files it names
found by name."""

from __future__ import annotations

import json
import re

import pytest

from bench_port import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.manifest()
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = {c["name"]: c for c in BENCH["workloads"]}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for path in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
        assert not path.endswith("_torch") and (harness.REPO / path).is_dir()
    assert all(_line(word) and not word.startswith("/") for word in BENCH["command"])
    assert BENCH["command"][1].startswith(BENCH["paths"][0] + "/")
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_budget_fits_twenty_four_cells():
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry and key != "source" or (key == "source" and "file" in entry):
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_configs(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith(BENCH["paths"][0] + "/")
    assert harness.config(entry["name"])["name"] == entry["name"]
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    assert any(c["config"] == entry["name"] for c in BENCH["workloads"]), "config keeps a cell"


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_cells_agree_with_their_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    cell = harness.cell(entry["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key], key
    assert entry["chips"] in (1, 4) and NAME.match(entry["traffic"])
    assert (harness.ROOT / "traffic" / f"{cell['kind']}.py").is_file()
    reported = [m for m in BENCH["end_to_end"] if harness.applies(m, entry["name"])]
    assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
    assert any(harness.applies(m, entry["name"]) for m in BENCH["per_layer"])


def test_four_chip_cells_are_at_most_a_quarter():
    fours = sum(c["chips"] == 4 for c in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("entry", BENCH["end_to_end"], ids=lambda e: e["name"])
def test_end_to_end_metrics(entry):
    assert set(entry) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    assert entry["source"] in ("host_clock", "device_trace")
    assert 0.01 <= entry["bound"] <= 0.25


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_per_layer_metrics_move_what_their_cells_report(entry):
    assert set(entry) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    moved = {m["name"]: m for m in BENCH["end_to_end"]}[entry["moves"]]
    for cell in entry.get("workloads", CELLS):
        assert cell in CELLS and harness.applies(moved, cell)
    if entry["name"].split(".")[0].endswith("_roofline") or "mfu" in entry["name"]:
        assert entry["unit"] == "%"


def test_metrics_of_one_layer_name_it_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("entry", METRICS, ids=lambda e: e["name"])
def test_each_metric_has_a_reader_that_agrees(entry):
    reader = harness.reader(entry["name"])
    assert (reader.SOURCE, reader.UNIT, reader.BETTER) == (
        entry["source"], entry["unit"], entry["better"])


def test_a_new_cell_and_metric_need_no_edit(tmp_path):
    for sub in ("configs", "workloads", "metrics"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "extra.json").write_text(json.dumps({"name": "extra"}))
    (tmp_path / "workloads" / "extra.cell.json").write_text(json.dumps(
        {"config": "extra", "traffic": "t", "chips": 1, "why": "w", "kind": "serve"}))
    (tmp_path / "metrics" / "extra_ms.py").write_text(
        'SOURCE, UNIT, BETTER = "host_clock", "ms", "lower"\n'
        "def read(record, name):\n    return None if record is None else 1.0\n")
    cell = harness.cell("extra.cell", root=tmp_path)
    assert harness.config(cell["config"], root=tmp_path)["name"] == "extra"
    reader = harness.reader("extra_ms.cell", root=tmp_path)
    assert reader.read(object(), "extra_ms.cell") == 1.0 and reader.read(None, "x") is None
    assert harness.traffic("serve").__name__.endswith("serve")


@pytest.mark.parametrize("names,found", [
    (["riffusion_tpu_torch", "riffusion_tpu_torch.server", "numpy"], []),
    (["riffusion_tpu", "riffusion_tpu.models"], ["riffusion_tpu", "riffusion_tpu.models"]),
    (["jax", "jax.numpy"], ["jax", "jax.numpy"]),
    (["flax.linen", "jaxlib.xla_client"], ["flax.linen", "jaxlib.xla_client"]),
])
def test_import_check(names, found):
    assert harness.forbidden_modules(names) == found


def test_a_run_without_a_card_fails_and_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this test is for a machine without one")
    from bench_port import run

    assert run.main(["--workload", "riffusion-v1.player", "--seed", "1", "--seconds", "1"]) != 0
    assert "correct" not in capsys.readouterr().out

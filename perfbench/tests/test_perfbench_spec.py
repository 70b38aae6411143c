"""BENCHMARK.json keeps the contract's shape, and every workload resolves
by name to its configuration, traffic mix, cell data, per-layer readers
and reference family."""

import json
import re
from pathlib import Path

import pytest

from perfbench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    runs = 2 + 14 * 24
    assert runs * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    ends = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in ends
        assert set(m.get("workloads", WORKLOADS)) <= set(WORKLOADS)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])


def test_roofline_and_mfu_metrics_are_percent():
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves(workload):
    cell = spec.load_cell(workload, BENCH)
    assert cell.cfg["name"] == cell.entry["config"]
    assert cell.mix["name"] == cell.entry["traffic"]
    assert cell.data["workload"] == workload
    assert {"plan", "profile_s", "sample", "limits"} <= set(cell.data)
    assert cell.data["limits"]
    assert set(cell.data["limits"]) <= {"max_gap", "mean_gap"}
    assert ("clients" in cell.data) == (cell.mix["arrivals"] == "closed")
    assert ("rate_per_s" in cell.data) == (cell.mix["arrivals"] == "poisson")
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer one
    ends = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in ends and len(ends) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))
        assert m["moves"] in ends
    model = spec.reference_model(cell.cfg["family"])
    assert model.__name__


@pytest.mark.parametrize("workload", WORKLOADS)
def test_config_file_states_the_run(workload):
    cfg = spec.load_cell(workload, BENCH).cfg
    entry = {c["name"]: c for c in BENCH["configs"]}[cfg["name"]]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    # a key changed from the source is named, with its value as run
    for k in cfg["reduced"]:
        assert cfg["as_run"][k] != cfg["published"][k], k
    assert set(cfg.get("as_run", {})) == set(cfg["reduced"])
    a, pub = cfg["arch"], cfg["published"]
    assert a["d_model"] == pub["hidden_size"]
    assert a["n_layers"] == pub["num_hidden_layers"]
    assert a["n_heads"] == pub["num_attention_heads"]
    assert a["n_kv_heads"] == pub["num_key_value_heads"]
    assert a["vocab"] == pub["vocab_size"]
    assert a["rope_theta"] == pub["rope_theta"]
    assert a["tie_embeddings"] == pub["tie_word_embeddings"]
    assert cfg["norm_eps"] == pub["rms_norm_eps"]
    assert a["compute_dtype"] == cfg["dtype"] == pub["torch_dtype"]
    if a.get("moe"):
        assert a["moe"]["n_routed"] == pub["num_local_experts"]
        assert a["moe"]["top_k"] == pub["num_experts_per_tok"]
        assert a["moe"]["d_expert"] == pub["intermediate_size"]
    else:
        assert a["d_ff"] == pub["intermediate_size"]


def test_every_file_is_named_from_a_name():
    for path in (ROOT / "perfbench").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel

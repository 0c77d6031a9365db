"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
resolves to its file."""
import json
import re

import pytest

from conftest import ROOT
from vsbench import check, datagen, harness, loadgen

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token")


def text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(text(w) for w in cmd)
    for w in cmd:
        if (ROOT / w).exists():
            assert any(w.startswith(p + "/") for p in BENCH["paths"])
    r = BENCH["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    confs = BENCH["configs"]
    assert 1 <= len(confs) <= 24
    assert len({c["name"] for c in confs}) == len({c["file"] for c in confs}) \
        == len(confs)
    used = {w["config"] for w in BENCH["workloads"]}
    for c in confs:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert text(c["source"]) and text(c["why"])
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert len(c["reduced"]) <= 16
        assert sorted(c["reduced"]) == sorted(body["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and key in body and not WIDTH.search(key)
        datagen.spec_from_config(body)
        harness.index_params(body)


def test_workloads():
    cells = BENCH["workloads"]
    confs = {c["name"] for c in BENCH["configs"]}
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in confs and w["chips"] in (1, 4) and text(w["why"])
        cell = harness.load_cell(ROOT, w["name"])
        loadgen.generator(cell.traffic, cell.config["n_queries"],
                          cell.kind.knobs)
        assert set(cell.limits) == set(check.GENERIC) | set(cell.kind.numbers)
        e2e = [m["name"] for m in cell.metrics["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics["per_layer"]


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    ms = BENCH[kind]
    assert 1 <= len(ms) <= (16 if kind == "end_to_end" else 128)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in ms:
        keys = ({"name", "unit", "better", "bound", "source"}
                if kind == "end_to_end" else
                {"name", "unit", "better", "source", "layer", "moves"})
        assert set(m) - {"workloads"} == keys
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert callable(harness.load_reader(ROOT, m["name"]))
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert text(m["layer"]) and m["moves"] in e2e
            # the metric it moves is reported in every cell it lists
            assert set(m.get("workloads", cells)) <= set(
                e2e[m["moves"]].get("workloads", cells))
    if kind == "end_to_end":
        assert e2e["setup_s"]["bound"] <= 0.25

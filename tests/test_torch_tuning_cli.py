"""``python -m repro_torch.tuning --device cpu`` against ``python -m
repro.tuning``: the commands of ``docs/tuning.md`` at small settings give
the reference's JSON, ``meta`` aside.

The kernel-backend modes price batches from a calibration table, and the
port's committed table was measured on the card, so both packages are
given that one table (``--calibration``).  ``--tune-window`` reports each
window's mean occupancy of the ``l2_topk`` query tile, 32 queries in the
port and 8 in the reference: its sweep is held field for field to the
reference's except that field, the field to the reference run with its
tile set to 32, and the pick to the reference's own.
"""
import copy
import json

import pytest

torch = pytest.importorskip("torch")

import repro.exec.backend as jbackend  # noqa: E402
from repro.tuning import __main__ as jcli  # noqa: E402
from repro_torch.exec.batched import QUERY_TILE  # noqa: E402
from repro_torch.exec.table import DEFAULT_TABLE_PATH  # noqa: E402
from repro_torch.tuning import __main__ as pcli  # noqa: E402

#: the ``tenants.json`` of ``docs/tenancy.md``
TENANTS = [
    {"name": "search-hot", "n": 600, "dim": 32, "nprobe": 8,
     "scenario": "trace", "rate_qps": 250, "slo_ms": 60, "weight": 2.0},
    {"name": "analytics", "n": 1200, "dim": 32, "nprobe": 64,
     "scenario": "burst", "burst_factor": 10, "slo_ms": 150, "weight": 1.0},
]

#: the commands of ``docs/tuning.md``; ``--n`` caps every rung and eval
#: index at a few hundred points, and the open-loop runs and the split's
#: refinement are cut short
COMMANDS = {
    "screen": ["--budget", "screen"],
    "index": ["--recall", "0.95", "--concurrency", "64", "--dim", "960",
              "--storage", "tos", "--n", "300"],
    "fleet_kernel": ["--fleet", "--backend", "kernel", "--scenario",
                     "poisson", "--rate", "400", "--duration", "0.25",
                     "--n", "400", "--calibration", DEFAULT_TABLE_PATH],
    "tune_window": ["--tune-window", "--scenario", "poisson", "--rate",
                    "400", "--duration", "0.5", "--n", "400",
                    "--calibration", DEFAULT_TABLE_PATH],
    "tune_split": ["--tune-split", "--tenants", "TENANTS", "--cache-gb",
                   "0.004", "--split-steps", "4", "--refine-top", "1"],
    "tune_tier": ["--tune-tier", "--budget-usd-hour", "2.0", "--pricebook",
                  "default", "--n", "400"],
    "write_rate": ["--write-rate", "400", "--n", "600", "--dim", "32"],
}

#: the top-level keys each mode's JSON carries
KEYS = {
    "screen": {"recommendation", "screen", "pareto_frontier"},
    "index": {"recommendation", "screen", "pareto_frontier"},
    "fleet_kernel": {"recommendation", "sweep", "meets_slo", "scenario"},
    "tune_window": {"recommendation", "sweep", "fleet", "meets_target"},
    "tune_split": {"recommendation", "screened", "refined"},
    "tune_tier": {"recommendation", "screened", "refined"},
    "write_rate": {"recommendation", "ingest"},
}


def _cli_json(main, argv, capsys) -> dict:
    assert main(argv) == 0
    out = json.loads(capsys.readouterr().out)
    assert out.pop("meta")["seed"] == 0
    return out


def _without_occupancy(out: dict) -> dict:
    out = copy.deepcopy(out)
    for o in out["sweep"]:
        o.pop("mean_occupancy")
    return out


@pytest.mark.parametrize("mode", list(COMMANDS))
def test_cli_gives_the_reference_json(mode, tmp_path, capsys, monkeypatch):
    spec = tmp_path / "tenants.json"
    spec.write_text(json.dumps(TENANTS))
    argv = [str(spec) if a == "TENANTS" else a for a in COMMANDS[mode]]
    argv += ["--compact"]
    want = _cli_json(jcli.main, argv, capsys)
    got = _cli_json(pcli.main, argv + ["--device", "cpu"], capsys)
    assert KEYS[mode] <= set(got)
    if mode != "tune_window":
        assert got == want
        return
    assert _without_occupancy(got) == _without_occupancy(want)
    assert got["recommendation"] == want["recommendation"]
    monkeypatch.setattr(jbackend, "QUERY_TILE", QUERY_TILE)
    assert got == _cli_json(jcli.main, argv, capsys)


def test_cli_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """Without ``--device cpu`` the tuner builds on the card, and a host
    without one raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pcli.main(["--budget", "screen", "--compact"])

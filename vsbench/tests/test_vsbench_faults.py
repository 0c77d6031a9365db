"""A run with the timed path broken underneath comes out not correct: once
for each fault a search cell can have, past the harness's look for a card
(the CPU path of the same program)."""
import time

import pytest
import torch

from conftest import TINY
from vsbench import harness
from vsbench.system import Program


class Stale(Program):
    """A step that returns its state unchanged: every call answers what the
    first call answered."""
    first = None

    def search(self, state, queries, nprobe, k):
        if self.first is None:
            self.first = super().search(state, queries, nprobe, k)
        return self.first


class Half(Program):
    """Half of the batch left out: the second half gets no answer."""

    def search(self, state, queries, nprobe, k):
        b = queries.shape[0] // 2
        ids, d = super().search(state, queries[:b], nprobe, k)
        pad_i = torch.full((queries.shape[0] - b, k), -1, dtype=ids.dtype)
        pad_d = torch.full((queries.shape[0] - b, k), float("inf"))
        return torch.cat([ids, pad_i]), torch.cat([d, pad_d])


class Altered(Program):
    """An answer altered where it is produced: each query's 5th id is
    another point, its distance kept."""

    def search(self, state, queries, nprobe, k):
        ids, d = super().search(state, queries, nprobe, k)
        n = int(state["arrs"]["list_ids"].max()) + 1
        ids = ids.clone()
        ids[:, 4] = (ids[:, 4] + 1) % n
        return ids, d


class DroppedReplicas(Program):
    """The build's closure broken: every list loses its last entry."""

    def build(self, data, params, device):
        state = super().build(data, params, device)
        a = state["arrs"]
        last = (a["list_len"] - 1).clamp_min(0).long()
        rows = torch.arange(len(last))
        full = a["list_len"] > 0
        a["list_ids"][rows[full], last[full]] = -1
        a["list_len"] -= full.to(a["list_len"].dtype)
        return state


def run(root, system):
    cell = harness.load_cell(root, TINY)
    return harness.run(root, cell, 5, 0.2, False, torch.device("cpu"), system,
                       time.perf_counter())


def test_the_sound_program_is_correct(tiny_root):
    out = run(tiny_root, Program())
    assert out["correct"] and out["failed"] == 0
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", [Stale, Half, Altered, DroppedReplicas])
def test_a_fault_is_not_correct(tiny_root, fault):
    out = run(tiny_root, fault())
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())

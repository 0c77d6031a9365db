"""The control (the reference with TF32 products in the program's place)
comes out not correct, at a size a test run holds, while the program on
the same seeds comes out correct: the limits separate the two."""
import torch

from conftest import TINY, make_root
from vsbench import control
from vsbench.system import Program


def test_control_fails_and_program_passes(tmp_path):
    root = make_root(tmp_path, n_samples=2256, dim=100, centers=20,
                     n_queries=256)
    out = control.readings(root, [TINY], [1, 2], [2, 3], 0.0,
                           torch.device("cpu"), Program(), log=lambda s: None)
    assert [r["seed"] for r in out["program"][TINY]] == [1, 2]
    assert [r["seed"] for r in out["control"][TINY]] == [2, 3]
    assert all(r["correct"] for r in out["program"][TINY])
    assert not any(r["correct"] for r in out["control"][TINY])

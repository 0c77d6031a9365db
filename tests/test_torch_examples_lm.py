"""The port's LM examples (``examples/torch/``) against the reference's
(``examples/``), each run in this process on the same inputs: the
reference's ``LM.init(PRNGKey(0))``, carried across with
``convert.lm_params_from_reference``.

* ``rag_serving.py``: smoke gemma-2b embeds 256 documents, indexes them,
  retrieves for 4 queries and generates 8 tokens each; every printed line
  (the retrieval's virtual time, the documents and the tokens) is the
  reference's;
* ``train_lm.py --quick --steps 30``: the runner's losses within
  ``tests/test_torch_train.py``'s ``DRIFT_RTOL`` of the reference's, with
  the port given the reference's decay of its scanned layers' vectors
  (ROADMAP Queue 3 item 9); and as a user runs it, twice on one
  checkpoint directory: the second run resumes at the last step and runs
  none.

The default device's refusal without a card is tested for every example
in ``tests/test_torch_examples.py``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.archs import smoke as ref_smoke  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from test_torch_examples import ROOT, load_example, printed  # noqa: E402
from test_torch_train import DRIFT_RTOL  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small eager steps: several contend
    with the other test workers' threads and run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_params(ref_cfg, port_cfg) -> dict:
    """The reference's ``LM.init(PRNGKey(0))`` as the port's state dict."""
    params = RefLM(ref_cfg).init(jax.random.PRNGKey(0))
    return lm_params_from_reference(port_cfg,
                                    jax.tree.map(np.asarray, params))


def test_rag_serving_prints_the_reference_lines(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["rag_serving.py"])
    want = printed(load_example("rag_serving", port=False).main)
    params = _ref_params(ref_smoke(REF_ARCHS["gemma-2b"]),
                         smoke(ARCHS["gemma-2b"]))
    got = printed(load_example("rag_serving", port=True).main,
                  ["--device", "cpu"], params=params)
    assert len(want) == 8 and want[-1] == "done."
    assert got == want


def _with_reference_decay(adamw, cfg):
    """``optimizer._adamw`` that also decays the vectors of the layers the
    reference stacks into its scanned unit (2-D there), by ``lr * wd`` of
    their value before the step, as the reference's AdamW does."""
    unit, n_rep, _ = tr.unit_structure(cfg)
    stacked = tuple(f"blocks.{i}." for i in range(n_rep * len(unit)))

    def decayed(ocfg, params, grads, state, scale, lr, bc1, bc2):
        old = {n: p.clone() for n, p in params.items()
               if p.ndim == 1 and n.startswith(stacked)}
        adamw(ocfg, params, grads, state, scale, lr, bc1, bc2)
        for n, p in old.items():
            params[n].sub_(lr * ocfg.weight_decay * p)

    return decayed


def test_train_lm_quick_losses_match_the_reference(tmp_path, monkeypatch):
    ref = load_example("train_lm", port=False)
    port = load_example("train_lm", port=True)
    reports = {}

    def keep(side, run):
        def kept(*a, **kw):
            out = run(*a, **kw)
            reports[side] = out[2]
            return out
        return kept

    monkeypatch.setattr(ref, "run", keep("ref", ref.run))
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--quick", "--steps",
                                      "30", "--ckpt", str(tmp_path / "ref")])
    want = printed(ref.main)
    monkeypatch.setattr(port, "run", keep("port", port.run))
    monkeypatch.setattr(opt, "_adamw", _with_reference_decay(
        opt._adamw, port.CFG_QUICK))
    got = printed(port.main, ["--quick", "--steps", "30", "--device", "cpu",
                              "--ckpt", str(tmp_path / "port")],
                  params=_ref_params(ref.CFG_QUICK, port.CFG_QUICK))
    assert got[0] == want[0] == "model repro-8m: 2.0M params"
    assert got[-1] == want[-1] == "OK"
    a, b = reports["ref"], reports["port"]
    assert a.steps_run == b.steps_run == 30
    np.testing.assert_allclose(b.losses, a.losses, rtol=DRIFT_RTOL)
    # the run learned: the drift bound is not met by two flat curves
    assert np.mean(b.losses[-10:]) < np.mean(b.losses[:10]) - 0.05


def test_train_lm_checkpoints_and_resumes_as_a_script(tmp_path):
    cmd = [sys.executable, str(ROOT / "examples" / "torch" / "train_lm.py"),
           "--quick", "--steps", "50", "--seq", "32", "--batch", "4",
           "--device", "cpu", "--ckpt", str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    first = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert first.returncode == 0, first.stderr[-2000:]
    lines = first.stdout.splitlines()
    assert lines[0] == "model repro-8m: 2.0M params"
    assert lines[-2].startswith("ran 50 steps; loss ") and lines[-1] == "OK"
    assert sorted(os.listdir(tmp_path)) == ["step_0000000050"]
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0, again.stderr[-2000:]
    assert again.stdout.splitlines()[1:] == [
        "resumed from step 50",
        f"ran 0 steps: {tmp_path} already holds step 50 of 50"]

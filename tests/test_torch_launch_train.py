"""The port's training launcher, ``python -m repro_torch.launch.train``.

* As a user runs it (a subprocess, ``--device cpu``): two lines as the
  reference prints them, a checkpoint at step 10 of 12 (``ckpt_every`` is
  ``max(10, steps // 3)``), and a second run that resumes there and runs
  the last 2 steps, as the reference's runner does.
* Given the reference's ``LM.init(PRNGKey(0))`` (through
  ``convert.lm_params_from_reference``), ``build`` and ``train`` print the
  reference launcher's first and last lines, losses to 3 decimals and all.
* The audio and VLM families' batches (frames and image embeddings drawn
  from a ``torch.Generator`` seeded with the step: a deliberate
  difference from ``jax.random``), microbatches, the default device
  without a card, and a world of more than one rank (placed on its
  production mesh).
"""
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.launch.train as ref_train  # noqa: E402
from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.archs import smoke as ref_smoke  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small eager steps: several contend
    with the other test workers' threads and run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cli(*flags):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *flags],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                           OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=300)


def test_cli_trains_checkpoints_and_resumes(tmp_path):
    flags = ["--smoke", "--steps", "12", "--device", "cpu",
             "--ckpt", str(tmp_path)]
    first = _cli(*flags)
    assert first.returncode == 0, first.stderr[-2000:]
    lines = first.stdout.splitlines()
    assert lines[0] == "gemma-2b-smoke: 0.1M params on 1 devices (tp_fsdp)"
    assert lines[-1].startswith("done: 12 steps, loss ")
    assert sorted(os.listdir(tmp_path)) == ["step_0000000010"]
    again = _cli(*flags)
    assert again.returncode == 0, again.stderr[-2000:]
    lines = again.stdout.splitlines()
    assert "resumed from step 10" in lines
    assert lines[-1].startswith("done: 2 steps, loss ")


def _args(**kw):
    args = port_train.build_parser().parse_args([])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_launcher_prints_the_reference_lines_on_its_weights(tmp_path,
                                                          monkeypatch):
    """The reference's ``main`` in this process, then the port's ``build`` and
    ``train`` on the reference's weights, with the same flags."""
    flags = ["--smoke", "--steps", "12", "--seq", "32", "--batch", "4"]
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--ckpt",
                                      str(tmp_path / "ref")])
    want = io.StringIO()
    with contextlib.redirect_stdout(want):
        ref_train.main()
    cfg = ref_smoke(REF_ARCHS["gemma-2b"])
    params = jax.tree.map(np.asarray, RefLM(cfg).init(jax.random.PRNGKey(0)))
    pcfg = ModelConfig(**{f: getattr(cfg, f) for f in
                          ModelConfig.__dataclass_fields__})
    args = port_train.build_parser().parse_args(
        [*flags, "--device", "cpu", "--ckpt", str(tmp_path / "port")])
    got = io.StringIO()
    with contextlib.redirect_stdout(got):
        try:
            lm = port_train.build(args, lm_params_from_reference(pcfg, params))
            port_train.train(lm, args)
        finally:
            torch.distributed.destroy_process_group()
    want, got = want.getvalue().splitlines(), got.getvalue().splitlines()
    assert got[0] == want[0]
    assert got[-1] == want[-1]


@pytest.mark.parametrize("arch", ["musicgen-medium", "llama-3.2-vision-11b"])
def test_audio_and_vlm_batches(arch, tmp_path, capsys):
    cfg = smoke(ARCHS[arch])
    args = _args(arch=arch, smoke=True, seq=16, batch=2, steps=2,
                 device="cpu", ckpt=str(tmp_path))
    nb = port_train.batch_fn(cfg, args, torch.device("cpu"))
    b3 = nb(3)
    key, shape = (("frames", (2, 16, cfg.d_model)) if cfg.family == "audio"
                  else ("image_embeds", (2, cfg.n_frontend_tokens,
                                         cfg.d_model)))
    want = torch.randn(shape, generator=torch.Generator().manual_seed(3))
    assert torch.equal(b3[key], want)
    assert not torch.equal(nb(4)[key], want)
    assert ("tokens" in b3) == (cfg.family == "vlm")
    assert b3["labels"].shape == (2, 16)
    port_train.main(["--arch", arch, "--smoke", "--steps", "2", "--seq", "16",
                     "--batch", "2", "--device", "cpu", "--ckpt",
                     str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"{cfg.name}: ") and out[-1].startswith(
        "done: 2 steps, loss ")


def test_microbatches_flag(tmp_path, capsys):
    port_train.main(["--smoke", "--steps", "3", "--seq", "16", "--batch",
                     "4", "--microbatches", "2", "--device", "cpu",
                     "--ckpt", str(tmp_path)])
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "done: 3 steps, loss ")


def test_default_device_is_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_train.main(["--smoke", "--steps", "1", "--ckpt", str(tmp_path)])


def test_more_than_one_rank_is_refused(tmp_path):
    """Named for the refusal it replaced: a world of more than one rank is
    now placed, not refused.  ``build`` puts the model on the production
    mesh of the world, its parameters DTensors under the sharding rules
    (here a fake world of 4 ranks; the training itself is
    ``test_torch_train_multirank.py``'s)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.models import parallel
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            lm = port_train.build(_args(device="cpu", ckpt=str(tmp_path),
                                        smoke=True))
        assert text.getvalue() == ("gemma-2b-smoke: 0.1M params on 4 "
                                   "devices (tp_fsdp)\n")
        assert parallel.is_sharded(lm)
        assert lm.embed.device_mesh.mesh_dim_names == ("data", "model")
        assert tuple(lm.embed.device_mesh.shape) == (1, 4)
        assert lm.embed.to_local().shape == (256 // 4, 64)
    finally:
        dist.destroy_process_group()

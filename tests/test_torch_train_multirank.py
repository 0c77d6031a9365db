"""Training on several ranks: the port's DTensor path against one rank.

Four ``gloo`` ranks (spawned processes, ``tests/torch_train_worker.py``)
train the smoke configs of gemma-2b, dbrx-132b (MoE) and mamba2-1.3b (SSM)
for three steps from the reference's ``LM.init(PRNGKey(0))`` (carried over
with ``convert.lm_params_from_reference``), under ``tp_fsdp`` on a 2 x 2
mesh and under ``fsdp`` on a 1 x 4 mesh:

* step 0's loss equals the reference's one-device loss (``src/repro`` on
  the CPU) within 1e-5 relative;
* all three losses equal the port's one-rank run's within 1e-5 relative,
  and the parameters after the three steps are within 1e-5 x each leaf's
  max |p| of its.  Later steps are held to the port's own one-rank run,
  not the reference's: the reference's AdamW also decays its stacked norm
  vectors (a deliberate difference, pinned in ``test_torch_train.py``);
* each rank's local shard has the shape its placements give;
* a checkpoint saved on 4 ranks restores on 1 with the same parameters,
  bit for bit, and one saved on 1 rank restores onto the 4-rank mesh bit
  for bit;
* a save holds one leaf on the host at a time, and on 4 ranks only rank 0
  copies leaves to its host;
* ``torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke
  --steps 3 --device cpu`` prints the reference's lines "on 4 devices",
  with the losses of the same command on one rank;
* the runner's spike guard and a SIGTERM save and resume work on DTensor
  parameters and state (a 1x1 mesh in this process).

Every collective the sharded step needs (all-gather, reduce-scatter,
all-reduce) runs on gloo; nothing is replicated in its place.
"""
import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.archs import smoke as ref_smoke  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from torch_train_worker import (BATCH, CASES, SEQ, STEPS,  # noqa: E402
                                args_for, case_name)
from torch_train_worker import run as worker_run  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5
ARCH_NAMES = sorted({arch for arch, _, _ in CASES})
IDS = [case_name(*c) for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's step-0 loss and the port's one-rank run of each arch,
    then the four ranks' runs of every case."""
    tmp = tmp_path_factory.mktemp("multirank")
    inp, out = tmp / "inp", tmp / "out"
    inp.mkdir()
    out.mkdir()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    one, ref_loss = {}, {}
    try:
        for arch in ARCH_NAMES:
            ref_cfg = ref_smoke(REF_ARCHS[arch])
            ref_params = RefLM(ref_cfg).init(jax.random.PRNGKey(0))
            params = lm_params_from_reference(
                smoke(ARCHS[arch]), jax.tree.map(np.asarray, ref_params))
            torch.save(params, inp / f"{arch}.pt")
            ckpt.save(str(inp / f"{arch}_ckpt"), 0, {"params": params})
            b = TokenPipeline(DataConfig(vocab=ref_cfg.vocab, seq_len=SEQ,
                                         global_batch=BATCH)).batch(0)
            ref_loss[arch] = float(RefLM(ref_cfg).loss(
                ref_params, {k: jnp.asarray(v) for k, v in b.items()}))
            args = args_for(arch, "tp_fsdp", str(tmp / f"{arch}_one"))
            with contextlib.redirect_stdout(io.StringIO()) as text:
                lm, _, report = port_train.train(
                    port_train.build(args, params), args)
            one[arch] = {"losses": report.losses, "stdout": text.getvalue(),
                         "params": {n: p.detach().clone()
                                    for n, p in lm.named_parameters()}}
    finally:
        torch.set_num_threads(threads)
        if dist.is_initialized():
            dist.destroy_process_group()
    ctx = mp.start_processes(
        worker_run, args=(4, str(tmp / "store"), str(inp), str(out)),
        nprocs=4, join=False, start_method="spawn")
    while not ctx.join(timeout=300):
        pass
    four = {name: torch.load(out / f"{name}.pt") for name in IDS}
    return {"one": one, "ref_loss": ref_loss, "four": four, "out": out}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_step0_loss_matches_the_reference(runs, case):
    got = runs["four"][case_name(*case)]["losses"][0]
    want = runs["ref_loss"][case[0]]
    assert abs(got - want) <= RTOL * abs(want), (got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_losses_match_one_rank(runs, case):
    got = runs["four"][case_name(*case)]["losses"]
    want = runs["one"][case[0]]["losses"]
    assert len(got) == len(want) == STEPS
    for g, w in zip(got, want):
        assert abs(g - w) <= RTOL * abs(w), (got, want)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_params_match_one_rank(runs, case):
    got = runs["four"][case_name(*case)]["params"]
    want = runs["one"][case[0]]["params"]
    assert set(got) == set(want)
    for name, w in want.items():
        scale = max(float(w.abs().max()), 1e-30)
        err = float((got[name] - w).abs().max())
        assert err <= RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_local_shards_have_their_placements_shape(runs, case):
    assert runs["four"][case_name(*case)]["shapes_ok"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_rank_checkpoint_restores_on_four(runs, case):
    assert runs["four"][case_name(*case)]["restored_ok"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_four_rank_checkpoint_restores_on_one(runs, case):
    arch = case[0]
    name = case_name(*case)
    lm = LM(smoke(ARCHS[arch]), seed=None, device="cpu")
    target = {"params": lm.state_dict(),
              "opt": opt.init_state(dict(lm.named_parameters()))}
    back = ckpt.restore(str(runs["out"] / f"{name}_ckpt"), STEPS, target)
    want = runs["four"][name]["params"]
    for n, p in back["params"].items():
        assert torch.equal(p, want[n]), n
    assert int(back["opt"]["step"]) == STEPS


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_four_rank_save_copies_to_the_host_on_rank_0_only(runs, case):
    """Every rank takes part in each leaf's gather; rank 0 alone copies the
    leaves to its host, one alive at a time."""
    arch = case[0]
    lm = LM(smoke(ARCHS[arch]), seed=None, device="meta")
    n_leaves = len(lm.state_dict()) + len(
        opt.init_state(dict(lm.named_parameters()))["m"]) * 2 + 1
    copies = runs["four"][case_name(*case)]["host_copies"]
    assert copies == [(n_leaves, 1), (0, 0), (0, 0), (0, 0)], copies


def test_save_holds_one_leaf_on_the_host(tmp_path, monkeypatch):
    """``save`` copies a leaf to the host, writes it and drops it before the
    next: one leaf's array is alive at a time, and the checkpoint restores
    bit for bit."""
    import weakref
    seen = {"copies": 0, "live": 0, "most": 0}
    host = ckpt._host

    def drop():
        seen["live"] -= 1

    def counted(leaf):
        arr = host(leaf)
        seen["copies"] += 1
        seen["live"] += 1
        seen["most"] = max(seen["most"], seen["live"])
        weakref.finalize(arr, drop)
        return arr
    monkeypatch.setattr(ckpt, "_host", counted)
    gen = torch.Generator().manual_seed(0)
    tree = {"params": {f"w{i}": torch.randn((64, 32), generator=gen)
                       for i in range(6)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 1, tree)
    assert seen["copies"] == 7 and seen["most"] == 1, seen
    back = ckpt.restore(str(tmp_path), 1, tree)
    for name, w in tree["params"].items():
        assert torch.equal(back["params"][name], w), name
    assert int(back["opt"]["step"]) == 3


def test_torchrun_four_ranks_prints_the_reference_lines(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "4", "--standalone", "-m", "repro_torch.launch.train",
         "--arch", "gemma-2b", "--smoke", "--steps", str(STEPS), "--batch",
         str(BATCH), "--seq", str(SEQ), "--device", "cpu", "--ckpt",
         str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [ln for ln in r.stdout.splitlines() if ln]
    assert lines[0] == "gemma-2b-smoke: 0.1M params on 4 devices (tp_fsdp)"
    # the one-rank run's last line (the same seed-0 weights), to the
    # reference's 3 decimals
    args = args_for("gemma-2b", "tp_fsdp", str(tmp_path / "one"))
    try:
        with contextlib.redirect_stdout(io.StringIO()) as text:
            port_train.train(port_train.build(args), args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    want = text.getvalue().splitlines()
    assert want[0] == "gemma-2b-smoke: 0.1M params on 1 devices (tp_fsdp)"
    assert lines[-1] == want[-1]


def _sharded_run(tmp_path, tag, steps, spike_guard=False, wrap=None,
                 hook=None):
    """The runner over gemma-2b's smoke config as DTensors on a 1x1 mesh of
    a one-rank gloo group in this process (seed-0 weights)."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.models import parallel
    from repro_torch.train.runner import RunnerConfig, run
    from repro_torch.train.train_step import make_train_step
    args = args_for("gemma-2b", "tp_fsdp", str(tmp_path / tag))
    args.steps = steps
    mesh = DeviceMesh("cpu", [[0]], mesh_dim_names=("data", "model"))
    with contextlib.redirect_stdout(io.StringIO()):
        lm = port_train.build(args, mesh=mesh)
    assert parallel.is_sharded(lm)
    step_fn = make_train_step(lm, opt.OptimizerConfig(total_steps=steps))
    batches = port_train.batch_fn(lm.cfg, args, lm.device, mesh)

    def next_batch(s):
        if hook is not None:
            hook(s)
        return batches(s)
    rcfg = RunnerConfig(total_steps=steps, ckpt_dir=args.ckpt,
                        ckpt_every=100, log_every=100,
                        spike_guard=spike_guard)
    return run(rcfg, wrap(step_fn) if wrap else step_fn, lm,
               opt.init_state(dict(lm.named_parameters())), next_batch,
               log=lambda *_: None)


@pytest.fixture
def one_rank_gloo():
    created = not dist.is_initialized()
    if created:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    if created:
        dist.destroy_process_group()


def _full_params(lm):
    return {n: p.full_tensor() for n, p in lm.named_parameters()}


def test_spike_guard_restores_dtensors(tmp_path, one_rank_gloo):
    """Step 10's loss is reported 100x: the guard restores its copy of the
    DTensor parameters and state, bit for bit those of a run whose step 10
    made no update."""
    def poison(skip_update):
        def wrap(step_fn):
            calls = [0]

            def wrapped(lm, state, batch):
                calls[0] += 1
                if calls[0] == 11 and skip_update:
                    with torch.no_grad():
                        return lm, state, {"loss": lm.loss(batch)
                                           .full_tensor() * 100}
                lm, state, m = step_fn(lm, state, batch)
                if calls[0] == 11:
                    m = dict(m, loss=m["loss"] * 100)
                return lm, state, m
            return wrapped
        return wrap
    lm, state, rep = _sharded_run(tmp_path, "guard", 14, True, poison(False))
    lm2, state2, rep2 = _sharded_run(tmp_path, "skip", 14, True, poison(True))
    assert rep.n_spikes_skipped == rep2.n_spikes_skipped == 1
    assert rep.losses == rep2.losses
    want = _full_params(lm2)
    for n, p in _full_params(lm).items():
        assert torch.equal(p, want[n]), n
    assert int(state["step"]) == int(state2["step"]) == 13


def test_preemption_saves_and_resumes_dtensors(tmp_path, one_rank_gloo):
    """SIGTERM while step 3's batch is made: the run saves the DTensor state
    at step 4 and stops; the resumed run ends on the parameters of a run
    that was never stopped, bit for bit."""
    import signal

    def hook(s):
        if s == 3:
            os.kill(os.getpid(), signal.SIGTERM)
    _, _, rep = _sharded_run(tmp_path, "stop", 6, hook=hook)
    assert rep.preempted and rep.final_step == 4
    assert ckpt.latest_step(str(tmp_path / "stop")) == 4
    lm, state, again = _sharded_run(tmp_path, "stop", 6)
    assert again.steps_run == 2 and int(state["step"]) == 6
    lm_full, _, _ = _sharded_run(tmp_path, "full", 6)
    want = _full_params(lm_full)
    for n, p in _full_params(lm).items():
        assert torch.equal(p, want[n]), n

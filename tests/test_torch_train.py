"""The port's training path against ``repro.train`` on the same inputs.

The nine tests of ``tests/test_train.py`` run on the port (their subject is
the port's own behaviour: the loss falls, microbatches, the schedule's
shape, checkpoints, the runner's resume, the token pipeline).  The parity
tests feed both packages the reference's ``LM.init(PRNGKey(0))``, carried
across with ``convert.lm_params_from_reference``, and the same numpy
batches:

* the gradients of ``lm.loss`` for all ten smoke configs (the port with
  remat on, under both remat policies for two of them, and through several
  loss chunks and the chunked attention paths), each leaf within 1e-4 of
  its largest |g|: f32 sums in another order than XLA's;
* ``schedule`` at steps 0-100 within 1e-7 relative (one f32 rounding);
* two ``apply_updates``: ``lr`` and ``grad_norm`` at rtol 1e-5; ``m``,
  ``v`` and the parameters at the reference's own 5e-3 absolute
  (``tests/test_train.py:56-57``): step 1's ``g/|g|`` turns a sign
  difference of a near-zero gradient into 2 lr;
* the one deliberate difference, pinned: the reference decays its scanned
  layers' vectors (norm scales), which stacking gives 2 dims, and the port
  does not (``DRIFT_RTOL``);
* five steps of ``run`` with ``microbatches`` 1 and 4, each step's loss
  within 1e-4 relative;
* a preemption (SIGTERM from ``next_batch`` at step 3) and its resume, and
  a spike the guard skips, each against the reference's ``run`` (losses
  past the fifth step within ``DRIFT_RTOL``).
"""
import dataclasses
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.archs import ARCHS as REF_ARCHS  # noqa: E402
from repro.configs.archs import smoke as ref_smoke  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.model import LM as RefLM  # noqa: E402
from repro.train import optimizer as ref_opt  # noqa: E402
from repro.train.runner import RunnerConfig as RefRunnerConfig  # noqa: E402
from repro.train.runner import run as ref_run  # noqa: E402
from repro.train.train_step import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs.archs import ARCHS, smoke  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.model import LM  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.runner import RunnerConfig, run  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402

GRAD_RTOL = 1e-4        # of each leaf's max |g|
LOSS_RTOL = 1e-4
ADAM_ATOL = 5e-3        # the reference's own bound for m, v and parameters
# The reference decays the norm scales and other vectors of its scanned
# layers (stacking gives them 2 dims; ROADMAP Queue 3 item 12), the port
# only tensors of 2+ dims: on the runs below the losses move apart by
# 3.5e-5 at step 5 and 4.7e-4 at step 14 (CPU); given the reference's decay,
# the port's stay within 2e-7 of them over 14 steps
DRIFT_RTOL = 1e-3
B, S = 2, 32
OCFG = dict(peak_lr=3e-3, warmup_steps=5, total_steps=200)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small eager steps: several contend
    with the other test workers' threads and run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_cfg(cfg, **kw):
    return dataclasses.replace(ModelConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}), **kw)


def _port_lm(cfg, params, **kw):
    """The port's LM on the reference's parameters (numpy tree)."""
    pcfg = _port_cfg(cfg, **kw)
    lm = LM(pcfg, seed=None, device="cpu")
    lm.load_state_dict(lm_params_from_reference(
        pcfg, jax.tree.map(np.asarray, params)))
    return lm


def _batch(cfg, seq=S, seed=1, b=B):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal((b, seq, cfg.d_model)
                                              ).astype(np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, seq)
                                       ).astype(np.int32)
    batch["labels"] = rng.integers(0, cfg.vocab, (b, seq)).astype(np.int32)
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _jx(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pt(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _port_grads(lm, batch):
    lm.zero_grad(set_to_none=True)
    loss = lm.loss(_pt(batch))
    loss.backward()
    return float(loss.detach()), {n: (p.grad if p.grad is not None
                             else torch.zeros_like(p)).clone()
                         for n, p in lm.named_parameters()}


def _assert_grads_close(got, want_tree, cfg):
    want = lm_params_from_reference(cfg, jax.tree.map(np.asarray, want_tree))
    assert set(got) == set(want)
    for name, g in got.items():
        scale = max(float(want[name].abs().max()), 1e-30)
        err = float((g - want[name]).abs().max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


# ------------------------------------------------- the reference's tests --

@pytest.fixture(scope="module")
def setup():
    cfg = smoke(ARCHS["gemma-2b"])
    lm = LM(cfg, seed=0, device="cpu")
    ocfg = opt.OptimizerConfig(**OCFG)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, seed=0))
    return lm, ocfg, pipe


def _fresh(lm):
    """A copy of ``lm`` (the train step updates its model in place)."""
    out = LM(lm.cfg, seed=None, device="cpu")
    out.load_state_dict(lm.state_dict())
    return out


def _nb(pipe):
    return lambda s: {k: torch.from_numpy(v).long()
                      for k, v in pipe.batch(s).items()}


def test_loss_decreases(setup):
    lm, ocfg, pipe = setup
    lm = _fresh(lm)
    step_fn = make_train_step(lm, ocfg)
    state = opt.init_state(dict(lm.named_parameters()))
    losses = []
    for s in range(30):
        lm, state, m = step_fn(lm, state, _nb(pipe)(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2


def test_microbatch_equivalence(setup):
    lm, ocfg, pipe = setup
    batch = _nb(pipe)(0)
    out = []
    for mb in (1, 4):
        m = _fresh(lm)
        state = opt.init_state(dict(m.named_parameters()))
        m, _, metrics = make_train_step(m, ocfg, microbatches=mb)(
            m, state, batch)
        out.append((m.state_dict(), float(metrics["loss"])))
    (p1, l1), (p2, l2) = out
    np.testing.assert_allclose(l1, l2, rtol=1e-4)
    assert max(float((p1[k] - p2[k]).abs().max()) for k in p1) < 5e-3


def test_schedule_shape():
    ocfg = opt.OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                               total_steps=100)
    lrs = [float(opt.schedule(ocfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(101)]
    assert lrs[0] < lrs[9] <= 1e-3 + 1e-12
    assert abs(lrs[10] - 1e-3) < 1e-9
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-2)


def test_checkpoint_roundtrip(tmp_path, setup):
    lm, *_ = setup
    tree = {"params": lm.state_dict(),
            "opt": opt.init_state(dict(lm.named_parameters()))}
    tree["opt"]["step"] += 7
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    target = {"params": {k: torch.empty_like(v, device="meta")
                         for k, v in tree["params"].items()},
              "opt": tree["opt"]}
    restored = ckpt.restore(str(tmp_path), 7, target)
    flat = lambda t: list(ckpt._leaves(t))  # noqa: E731
    assert [n for n, _ in flat(restored)] == [n for n, _ in flat(tree)]
    for (_, a), (_, b) in zip(flat(tree), flat(restored)):
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    # a missing leaf and a shape mismatch raise
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path), 7, {"params": {"nope": tree["opt"]["step"]}})
    bad = {"params": dict(target["params"], embed=torch.zeros(3, 3))}
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), 7, bad)


def test_checkpoint_torn_write_invisible(tmp_path, setup):
    lm, *_ = setup
    ckpt.save(str(tmp_path), 1, {"p": lm.state_dict()})
    # simulate a torn write: step dir without manifest
    torn = tmp_path / "step_0000000002"
    torn.mkdir()
    (torn / "junk.npy").write_bytes(b"xx")
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_gc(tmp_path, setup):
    lm, *_ = setup
    for s in [1, 2, 3, 4]:
        ckpt.save(str(tmp_path), s, {"p": lm.state_dict()})
    ckpt.gc_old(str(tmp_path), keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path))[-2:] == [
        "step_0000000003", "step_0000000004"]


def test_runner_resume(tmp_path, setup):
    lm, ocfg, pipe = setup
    lm = _fresh(lm)
    step_fn = make_train_step(lm, ocfg)
    state = opt.init_state(dict(lm.named_parameters()))
    rcfg = RunnerConfig(total_steps=6, ckpt_dir=str(tmp_path),
                        ckpt_every=3, log_every=100)
    _, _, rep1 = run(rcfg, step_fn, lm, state, _nb(pipe),
                     log=lambda *_: None)
    assert rep1.final_step == 6
    # a second run resumes from step 6's checkpoint... extend total
    lm2 = _fresh(setup[0])
    rcfg2 = RunnerConfig(total_steps=9, ckpt_dir=str(tmp_path),
                         ckpt_every=3, log_every=100)
    _, s2, rep2 = run(rcfg2, step_fn, lm2,
                      opt.init_state(dict(lm2.named_parameters())),
                      _nb(pipe), log=lambda *_: None)
    assert rep2.steps_run == 3          # only the remaining steps
    assert int(s2["step"]) == 9


def test_pipeline_deterministic_and_sharded():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8, seed=3)
    p = TokenPipeline(cfg)
    a = p.batch(5)
    b = p.batch(5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = p.batch(6)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # worker shards are disjoint streams covering the global batch
    w0 = p.batch(5, worker=0, n_workers=2)
    w1 = p.batch(5, worker=1, n_workers=2)
    assert w0["tokens"].shape[0] == 4
    assert not np.array_equal(w0["tokens"], w1["tokens"])
    # labels are next-token shifted
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_pipeline_learnable_structure():
    """The synthetic language must carry signal (bigram structure)."""
    cfg = DataConfig(vocab=64, seq_len=64, global_batch=16, seed=0)
    b = TokenPipeline(cfg).batch(0)
    pairs = {}
    for row in range(16):
        for t in range(63):
            pairs.setdefault(int(b["tokens"][row, t]), []).append(
                int(b["tokens"][row, t + 1]))
    frac_top4 = []
    for succ in pairs.values():
        if len(succ) >= 8:
            _, counts = np.unique(succ, return_counts=True)
            frac_top4.append(np.sort(counts)[::-1][:4].sum() / len(succ))
    assert np.mean(frac_top4) > 0.5


# ------------------------------------------------ against the reference --

_REF = {}


def _ref(arch):
    """The reference's smoke LM and its ``init(PRNGKey(0))``, once."""
    if arch not in _REF:
        cfg = ref_smoke(REF_ARCHS[arch])
        lm = RefLM(cfg)
        _REF[arch] = (cfg, lm, lm.init(jax.random.PRNGKey(0)))
    return _REF[arch]


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_grads_match_reference(arch):
    """The port with remat on (each unit checkpointed, as the full-size
    configs train) against ``jax.value_and_grad`` of the reference."""
    cfg, ref, params = _ref(arch)
    batch = _batch(cfg)
    want_loss, want = jax.jit(jax.value_and_grad(ref.loss))(params, _jx(batch))
    lm = _port_lm(cfg, params, remat=True)
    loss, got = _port_grads(lm, batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    assert all(np.isfinite(g.numpy()).all() for g in got.values())
    _assert_grads_close(got, want, cfg)


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b"])
def test_remat_policies_give_the_same_grads(arch):
    """No remat, full recompute and ``dots`` give the same gradients."""
    cfg, _, params = _ref(arch)
    batch = _batch(cfg)
    _, plain = _port_grads(_port_lm(cfg, params, remat=False), batch)
    for policy in (None, "dots"):
        tr.set_remat_policy(policy)
        try:
            _, got = _port_grads(_port_lm(cfg, params, remat=True), batch)
        finally:
            tr.set_remat_policy(None)
        for name, g in got.items():
            torch.testing.assert_close(g, plain[name], rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        tr.set_remat_policy("everything")


@pytest.mark.parametrize("arch,seq,chunk", [
    ("gemma-2b", 512, None),            # two checkpointed loss chunks
    ("gemma-2b", 32, 8),                # causal blocks, unrolled
    ("gemma-2b", 32, 2),                # every q chunk over all KV chunks
    ("recurrentgemma-2b", 64, 8),       # banded local attention
])
def test_grads_through_loss_chunks_and_chunked_attention(monkeypatch, arch,
                                                         seq, chunk):
    """Gradients through the checkpointed loss chunks and attention
    q-blocks (the threshold is lowered in both packages to reach the
    chunked attention at a smoke length)."""
    if chunk:
        for mod in (ref_layers, layers):
            monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 16)
            monkeypatch.setattr(mod, "ATTN_CHUNK", chunk)
    cfg, ref, params = _ref(arch)
    batch = _batch(cfg, seq=seq)
    want_loss, want = jax.jit(jax.value_and_grad(ref.loss))(params,
                                                            _jx(batch))
    loss, got = _port_grads(_port_lm(cfg, params, remat=True), batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL)
    _assert_grads_close(got, want, cfg)


@pytest.mark.parametrize("kw,decay_to_zero", [
    ({}, False), (OCFG, False), (dict(warmup_steps=0, total_steps=1), False),
    (dict(warmup_steps=30, total_steps=60, min_lr_frac=0.0), True)])
def test_schedule_matches_reference(kw, decay_to_zero):
    """1e-7 relative; for a decay to 0, 1e-7 of the peak: there ``1 + cos``
    cancels near the end, and a one-ulp difference of the two libraries'
    f32 ``cos`` is a larger share of the small rate (3.2e-7 at step 54)."""
    ref_cfg, port_cfg = ref_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    for s in range(101):
        want = float(ref_opt.schedule(ref_cfg, jnp.int32(s)))
        got = float(opt.schedule(port_cfg, torch.tensor(s, dtype=torch.int32)))
        tol = 1e-7 * (port_cfg.peak_lr if decay_to_zero else abs(want))
        assert abs(got - want) <= tol, (s, got, want)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_apply_updates_matches_reference(clip_norm):
    """Two AdamW steps on gradients drawn from a seed: one clipped
    (|g| > clip_norm) or not, matrices decayed and vectors not."""
    cfg, _, params = _ref("gemma-2b")
    kw = dict(OCFG, clip_norm=clip_norm)
    rcfg, pcfg = ref_opt.OptimizerConfig(**kw), opt.OptimizerConfig(**kw)
    rng = np.random.default_rng(3)
    lm = _port_lm(cfg, params)
    pparams = {k: p.detach() for k, p in lm.named_parameters()}
    pstate = opt.init_state(pparams)
    rparams, rstate = params, ref_opt.init_state(params)
    for _ in range(2):
        rgrads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(
                np.float32) * 0.01), rparams)
        pgrads = lm_params_from_reference(
            cfg, jax.tree.map(np.asarray, rgrads))
        rparams, rstate, rstats = jax.jit(
            lambda p, g, s: ref_opt.apply_updates(rcfg, p, g, s))(
            rparams, rgrads, rstate)
        pstats = opt.apply_updates(pcfg, pparams, pgrads, pstate)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(pstats[key]),
                                       float(rstats[key]), rtol=1e-5)
        assert int(pstats["step"]) == int(rstats["step"])
        assert pstate["step"].dtype == torch.int32
    want = {"params": rparams, "m": rstate["m"], "v": rstate["v"]}
    got = {"params": pparams, "m": pstate["m"], "v": pstate["v"]}
    for part, tree in want.items():
        conv = lm_params_from_reference(cfg, jax.tree.map(np.asarray, tree))
        for name, w in conv.items():
            torch.testing.assert_close(got[part][name], w, rtol=0,
                                       atol=ADAM_ATOL)
    # the update moved the parameters (not a trivially-passing tolerance)
    moved = lm_params_from_reference(cfg, jax.tree.map(np.asarray, params))
    assert max(float((pparams[k] - moved[k]).abs().max())
               for k in moved) > 1e-3


def test_vector_decay_differs_from_reference_as_documented():
    """One step from the same state and gradients: a vector of a layer in
    the reference's scanned unit (stacked, so 2-D there) is decayed by the
    reference and not by the port, by exactly ``lr * wd * p``; the final
    norm (1-D in both) and every matrix agree."""
    cfg, _, params = _ref("recurrentgemma-2b")     # unit layers and a tail
    rcfg, pcfg = ref_opt.OptimizerConfig(**OCFG), opt.OptimizerConfig(**OCFG)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda p: jnp.asarray(
        (rng.standard_normal(p.shape) * 0.01).astype(np.float32)), params)
    new, _, stats = jax.jit(lambda p, g: ref_opt.apply_updates(
        rcfg, p, g, ref_opt.init_state(p)))(params, grads)
    lm = _port_lm(cfg, params)
    pparams = {k: p.detach() for k, p in lm.named_parameters()}
    old = {k: v.clone() for k, v in pparams.items()}
    opt.apply_updates(pcfg, pparams, lm_params_from_reference(
        cfg, jax.tree.map(np.asarray, grads)), opt.init_state(pparams))
    want = lm_params_from_reference(cfg, jax.tree.map(np.asarray, new))
    unit, n_rep, _ = tr.unit_structure(lm.cfg)
    in_unit = {f"blocks.{i}." for i in range(n_rep * len(unit))}
    decay = float(stats["lr"]) * rcfg.weight_decay
    n_vectors = 0
    for name, p in pparams.items():
        stacked = any(name.startswith(u) for u in in_unit)
        if p.ndim == 1 and stacked:
            n_vectors += 1
            # a difference of two f32 values near |p|: a few ulps of it
            torch.testing.assert_close(p - want[name], decay * old[name],
                                       rtol=1e-3, atol=1e-6)
        else:
            torch.testing.assert_close(p, want[name], rtol=0, atol=1e-6)
    assert n_vectors > 0 and decay > 50 * 1e-6


def _pair_runs(tmp_path, steps, microbatches=1, ref_wrap=None,
               port_wrap=None, spike_guard=False, next_batch_hook=None,
               tag="", sides=("ref", "port")):
    """The reference's ``run`` and the port's on one weights and batches
    (``TokenPipeline`` at batch 8 x 32); returns both (state, report)."""
    cfg, ref, params = _ref("gemma-2b")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, seed=0))
    out = {}
    for side in sides:
        ckdir = str(tmp_path / f"{side}{tag}")
        if side == "ref":
            step_fn = jax.jit(ref_make_train_step(
                ref, ref_opt.OptimizerConfig(**OCFG),
                microbatches=microbatches))
            conv = lambda b: {k: jnp.asarray(v) for k, v in b.items()}  # noqa: E731
            rcfg = RefRunnerConfig(total_steps=steps, ckpt_dir=ckdir,
                                   ckpt_every=100, log_every=100,
                                   spike_guard=spike_guard)
            state0, opt0 = params, ref_opt.init_state(params)
            runner, wrap = ref_run, ref_wrap
        else:
            lm = _port_lm(cfg, params)
            step_fn = make_train_step(lm, opt.OptimizerConfig(**OCFG),
                                      microbatches=microbatches)
            conv = lambda b: {k: torch.from_numpy(v).long()  # noqa: E731
                              for k, v in b.items()}
            rcfg = RunnerConfig(total_steps=steps, ckpt_dir=ckdir,
                                ckpt_every=100, log_every=100,
                                spike_guard=spike_guard)
            state0, opt0 = lm, opt.init_state(dict(lm.named_parameters()))
            runner, wrap = run, port_wrap

        def next_batch(s, conv=conv):
            if next_batch_hook is not None:
                next_batch_hook(s)
            return conv(pipe.batch(s))

        p, o, rep = runner(rcfg, wrap(step_fn) if wrap else step_fn, state0,
                           opt0, next_batch, log=lambda *_: None)
        out[side] = (p, o, rep, ckdir)
    return out


def _same_reports(a, b):
    """The reports' fields equal, each loss within ``LOSS_RTOL`` for the
    first five steps and ``DRIFT_RTOL`` after."""
    for f in ("steps_run", "final_step", "n_spikes_skipped", "preempted"):
        assert getattr(a, f) == getattr(b, f), f
    assert len(a.losses) == len(b.losses) == len(b.step_times)
    np.testing.assert_allclose(b.losses[:5], a.losses[:5], rtol=LOSS_RTOL)
    np.testing.assert_allclose(b.losses[5:], a.losses[5:], rtol=DRIFT_RTOL)


@pytest.mark.parametrize("microbatches", [1, 4])
def test_run_matches_reference(tmp_path, microbatches):
    out = _pair_runs(tmp_path, 5, microbatches=microbatches)
    (_, _, rrep, _), (lm, state, prep, _) = out["ref"], out["port"]
    _same_reports(rrep, prep)
    assert prep.steps_run == 5 and int(state["step"]) == 5


def test_preemption_matches_reference(tmp_path):
    """SIGTERM arrives while step 3's batch is made: both runners finish
    that step, save it and stop; a second run resumes there."""
    before = signal.getsignal(signal.SIGTERM)

    def hook(s):
        if s == 3:
            # the runner's handler must be in place, or the signal would
            # kill this process instead of preempting the run
            assert signal.getsignal(signal.SIGTERM) is not before
            os.kill(os.getpid(), signal.SIGTERM)

    out = _pair_runs(tmp_path, 6, next_batch_hook=hook)
    rrep, prep = out["ref"][2], out["port"][2]
    _same_reports(rrep, prep)
    assert prep.preempted and prep.final_step == 4 and prep.steps_run == 4
    assert ckpt.latest_step(out["port"][3]) == 4
    assert signal.getsignal(signal.SIGTERM) is before
    # resume both: the remaining two steps, from the saved step
    again = _pair_runs(tmp_path, 6)
    _same_reports(again["ref"][2], again["port"][2])
    assert again["port"][2].steps_run == 2
    assert int(again["port"][1]["step"]) == 6


def test_spike_guard_matches_reference(tmp_path):
    """Step 10's loss is reported 100x: both guards skip it; the port's
    parameters and state afterwards are exactly those of a run whose step
    10 made no update."""
    def poison(scale_loss, skip_update=False):
        def wrap(step_fn):
            calls = [0]

            def wrapped(p, o, b):
                calls[0] += 1
                if calls[0] == 11 and skip_update:
                    with torch.no_grad():
                        return p, o, {"loss": p.loss(b) * 100}
                p, o, m = step_fn(p, o, b)
                if calls[0] == 11:
                    m = dict(m, loss=scale_loss(m["loss"]))
                return p, o, m
            return wrapped
        return wrap

    out = _pair_runs(tmp_path, 14, spike_guard=True,
                     ref_wrap=poison(lambda x: x * 100),
                     port_wrap=poison(lambda x: x * 100))
    rrep, prep = out["ref"][2], out["port"][2]
    _same_reports(rrep, prep)
    assert prep.n_spikes_skipped == 1 and prep.final_step == 14
    assert len(prep.losses) == 13
    lm, state = out["port"][0], out["port"][1]
    # the same run where step 10 made no update
    alt = _pair_runs(tmp_path, 14, spike_guard=True, tag="alt",
                     port_wrap=poison(lambda x: x * 100, skip_update=True),
                     sides=("port",))
    lm2, state2 = alt["port"][0], alt["port"][1]
    for k, v in lm.state_dict().items():
        assert torch.equal(v, lm2.state_dict()[k]), k
    assert int(state["step"]) == int(state2["step"]) == 13

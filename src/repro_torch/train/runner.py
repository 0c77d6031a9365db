"""Fault-tolerant training loop.

Counterpart of ``repro.train.runner``, with its behaviour:

* checkpoint/restart: resumes from the newest complete checkpoint (the
  model's parameters and the optimizer state); the data pipeline seeks to
  the restored step (no replay);
* preemption handling: SIGTERM/SIGINT trigger a save-and-exit at the next
  step boundary;
* straggler watchdog: steps slower than ``straggler_factor`` x the median
  of the last 64 step times are counted and logged;
* loss-spike guard: a step whose loss exceeds ``spike_factor`` x the median
  of the last 32 losses is undone.  The train step updates the parameters
  and the state in place, so the guard keeps a copy of both from before
  each step; that copy is only made when ``spike_guard`` is set (the
  default is off): parameters, ``m`` and ``v``, 12 bytes a parameter, 30 GB
  of device memory for gemma-2b's 2.5 B.

``float(loss)`` waits for each step on the device, as the reference's
``jax.device_get`` does, so a step time is the step's own.

On several ranks (a sharded model) every rank runs the loop: the ranks
agree on a preemption at each step (one rank's SIGTERM stops them all at
the same step, where they save together), and the spike guard's copy and
restore work on DTensors as on tensors.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.train import checkpoint as ckpt


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 100
    keep_last: int = 2
    log_every: int = 10
    straggler_factor: float = 2.0
    spike_factor: float = 4.0
    spike_guard: bool = False


@dataclasses.dataclass
class RunReport:
    steps_run: int
    final_step: int
    losses: list
    step_times: list
    n_stragglers: int
    n_spikes_skipped: int
    preempted: bool


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


def _state(lm, opt_state) -> dict:
    return {"params": lm.state_dict(), "opt": opt_state}


def _load(lm, state) -> Any:
    """Write ``state`` into ``lm``'s parameters; returns its optimizer
    state."""
    lm.load_state_dict(state["params"])
    return state["opt"]


def _any_rank(flag: bool) -> bool:
    """``flag`` on any rank of the default group (itself on one rank)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(flag)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def run(cfg: RunnerConfig, train_step: Callable, lm: torch.nn.Module,
        opt_state: Any, next_batch: Callable[[int], Any],
        log: Callable[[str], None] = print) -> tuple[Any, Any, RunReport]:
    """Train ``lm`` (updated in place) from ``opt_state`` to
    ``cfg.total_steps`` with ``train_step(lm, opt_state, batch)``.
    Returns ``(lm, opt_state, report)``."""
    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _handler)
        except ValueError:                      # non-main thread (tests)
            pass

    start = ckpt.latest_step(cfg.ckpt_dir)
    step = 0
    if start is not None:
        opt_state = _load(lm, ckpt.restore(
            cfg.ckpt_dir, start, _state(lm, opt_state)))
        step = start
        log(f"resumed from step {step}")

    losses: list[float] = []
    times: list[float] = []
    n_strag = 0
    n_spikes = 0
    steps_run = 0
    try:
        while step < cfg.total_steps:
            t0 = time.perf_counter()
            batch = next_batch(step)
            prev = _clone(_state(lm, opt_state)) if cfg.spike_guard else None
            lm, opt_state, metrics = train_step(lm, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if cfg.spike_guard and len(losses) >= 8:
                med = float(np.median(losses[-32:]))
                if loss > cfg.spike_factor * max(med, 1e-6):
                    opt_state = _load(lm, prev)    # skip the poisoned step
                    n_spikes += 1
                    step += 1
                    continue
            losses.append(loss)
            times.append(dt)
            if len(times) >= 8:
                med_t = float(np.median(times[-64:]))
                if dt > cfg.straggler_factor * med_t:
                    n_strag += 1
                    log(f"straggler step {step}: {dt:.2f}s vs median "
                        f"{med_t:.2f}s")
            step += 1
            steps_run += 1
            if step % cfg.log_every == 0:
                log(f"step {step} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            preempted["flag"] = _any_rank(preempted["flag"])
            if step % cfg.ckpt_every == 0 or preempted["flag"]:
                ckpt.save(cfg.ckpt_dir, step, _state(lm, opt_state))
                ckpt.gc_old(cfg.ckpt_dir, cfg.keep_last)
                if preempted["flag"]:
                    log(f"preemption save at step {step}; exiting")
                    break
    finally:
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    report = RunReport(steps_run=steps_run, final_step=step, losses=losses,
                       step_times=times, n_stragglers=n_strag,
                       n_spikes_skipped=n_spikes,
                       preempted=preempted["flag"])
    return lm, opt_state, report

"""``repro_torch.sim`` — the discrete-event simulation layer.

* :mod:`repro_torch.sim.kernel` — deterministic event kernel (EventQueue with
  seq tie-breaking, Clock, timers/Ticker, named RNG streams).  Storage,
  serving and fleet all run on one kernel per run.
* :mod:`repro_torch.sim.arrivals` — how queries arrive: closed-loop windows,
  open-loop Poisson (optionally diurnal/burst-modulated) and trace
  replay.
* :mod:`repro_torch.sim.faults` — shard failure/recovery schedules.
* :mod:`repro_torch.sim.autoscale` — SLO-driven replica autoscaling policy.

The port's own copy of ``repro.sim``, imports rewritten to
``repro_torch``; ``tests/test_torch_fleet.py`` holds the two to the same
code.
"""
from repro_torch.sim.kernel import Clock, Event, EventQueue, Kernel, Ticker

__all__ = ["Clock", "Event", "EventQueue", "Kernel", "Ticker"]

"""``online`` lab backend: scenarios run through :class:`SchedulerService`.

Same scenarios, same metrics schema, same extras as the ``events``
backend — but instead of scheduling the whole trace offline, tasks stream
into the service one arrival batch at a time and the engine advances in
bounded micro-steps. ``Metrics.summary()`` is byte-identical to offline
replay (the conformance property the tests pin down); what differs is
only *when* the engine learns about each task.
"""

from __future__ import annotations

from ..lab.backends import (
    Backend,
    assemble_events_result,
    events_eligible,
    register_backend,
)
from .scheduler import DecisionLog, SchedulerService

__all__ = ["OnlineBackend"]


@register_backend
class OnlineBackend(Backend):
    name = "online"

    def eligible(self, scenario):
        # anything the discrete-event engine can replay it can also stream
        return events_eligible(scenario)

    def run(self, scenario, *, step: float | None = None, **options):
        """``step`` sets a fixed micro-step width; by default the service
        paces itself on arrival times (one admission batch per step)."""
        if options:
            raise TypeError(f"online backend options: step only; got "
                            f"{sorted(options)}")
        self.check(scenario)
        log = DecisionLog(keep=False)  # count, don't accumulate
        svc = SchedulerService.from_scenario(scenario, log=log)
        wl = svc.session._sources[0].workload
        n_steps = 0
        if step is not None:
            if step <= 0:
                raise ValueError(f"step must be > 0, got {step}")
            while svc.session.pending_sources:
                svc.advance(until=svc.now + step)
                n_steps += 1
        else:
            while True:
                t_next = svc.session.next_feed_time()
                if t_next is None:
                    break
                svc.advance(until=t_next)
                n_steps += 1
        svc.drain()
        svc.close()
        return assemble_events_result(
            scenario, svc.rt, wl, svc.instruments, backend=self.name,
            backend_options={
                "model": "incremental-service",
                "pacing": "arrivals" if step is None else step,
                "micro_steps": n_steps,
                "decisions": dict(log.counts),
            })

"""Tracing / profiling utilities (SURVEY.md §5.1).

The reference has a bespoke wall-clock ladder: per-phase accumulation at
verbose>3 and init-vs-solve split (reference: src/include/timer.h:6-13,
src/cpu/pogs.cpp:206-209, 484-506).  Equivalents here:

  * :func:`trace` — context manager around ``jax.profiler`` producing a
    TensorBoard-loadable device trace of everything inside.
  * :class:`PhaseTimer` — host-side wall-clock phase accumulator with the
    reference's per-phase/percentage summary format.
  * :func:`device_time` — per-call wall time of a jitted callable,
    amortized over pipelined dispatches that end in one
    ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional


@contextlib.contextmanager
def trace(log_dir: str, create_perfetto_link: bool = False):
    """Capture a jax.profiler device trace into ``log_dir``.

    View with TensorBoard (`tensorboard --logdir <log_dir>`) or Perfetto.
    """
    import jax

    jax.profiler.start_trace(log_dir, create_perfetto_link=create_perfetto_link)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Accumulate wall-clock time per named phase.

    Mirrors the reference's verbose>3 phase report (prox/project/residual
    averages per iteration, pogs.cpp:501-506) at solve granularity:
    init / solve / transfer / overhead.
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = ["phase                 total_ms   calls   avg_ms   share"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            c = self.counts[name]
            lines.append(
                f"{name:<20} {t * 1e3:9.3f} {c:7d} {t / c * 1e3:8.3f} "
                f"{t / total * 100:6.1f}%"
            )
        return "\n".join(lines)

    def report(self):
        print(self.summary())


def device_time(
    fn: Callable,
    *args,
    reps: int = 30,
    vary: Optional[Callable[[int], tuple]] = None,
    warmup: int = 10,
) -> float:
    """Median per-call wall time (seconds) of a jitted ``fn`` measured by
    dispatching ``reps`` calls back-to-back and syncing once.

    ``vary(i)`` may return per-call replacement args (defaults to reusing
    ``args``).
    """
    import jax
    import jax.numpy as jnp

    def call(i):
        a = vary(i) if vary is not None else args
        return fn(*a)

    jax.block_until_ready(call(0))
    for i in range(warmup):
        call(i + 1)

    t0 = time.perf_counter()
    outs = [call(warmup + i + 1) for i in range(reps)]
    leaves = [jax.tree_util.tree_leaves(o)[0] for o in outs]
    jax.block_until_ready(jnp.stack([jnp.ravel(l)[0] for l in leaves]))
    return (time.perf_counter() - t0) / reps

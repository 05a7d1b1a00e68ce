"""Per-stage timing and device profiling.

Replaces the reference's ad-hoc ``cv::getTickCount`` stopwatches (the two
duplicate Timer classes, linemod/linemod_if.cpp:6-33 and test/my_timer.h:
3-30, and the 9-stage ICP report ``printTimeOfICP``, ICP/ICP.cpp:283-311)
with:

- :class:`StageTimer` — accumulating named-stage stopwatch whose report is
  the structured analog of printTimeOfICP;
- :func:`trace` — ``jax.profiler`` trace context for real device timelines
  (xprof/tensorboard), the replacement for printf timing;
- :func:`time_jitted` — steady-state wall-time of a jitted callable with
  proper warmup + ``block_until_ready`` fencing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    total_s: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.total_s / self.calls if self.calls else 0.0


class StageTimer:
    """Accumulating per-stage stopwatch.

    Usage::

        timer = StageTimer(sync=jax.block_until_ready)
        with timer.stage("match"):
            out = match_fn(...)         # sync(out) runs before stopping
        print(timer.report())
    """

    def __init__(self, sync: Optional[Callable[[Any], Any]] = None):
        self._stats: Dict[str, StageStats] = {}
        self._sync = sync
        self._order: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str, value: Any = None):
        if name not in self._stats:
            self._stats[name] = StageStats()
            self._order.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync is not None and value is not None:
                self._sync(value)
            s = self._stats[name]
            s.calls += 1
            s.total_s += time.perf_counter() - t0

    def add(self, name: str, seconds: float) -> None:
        if name not in self._stats:
            self._stats[name] = StageStats()
            self._order.append(name)
        self._stats[name].calls += 1
        self._stats[name].total_s += seconds

    def stats(self) -> Dict[str, StageStats]:
        return dict(self._stats)

    def report(self) -> str:
        """printTimeOfICP-style table (ICP/ICP.cpp:283-311)."""
        lines = [f"{'stage':<24}{'calls':>8}{'total ms':>12}{'mean ms':>10}"]
        for name in self._order:
            s = self._stats[name]
            lines.append(f"{name:<24}{s.calls:>8}{1e3 * s.total_s:>12.2f}"
                         f"{s.mean_ms:>10.3f}")
        return "\n".join(lines)

    def reset(self) -> None:
        self._stats.clear()
        self._order.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler device trace (view in xprof/tensorboard)."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def chain_slope(body: Callable[[Any], Any], x0: Any, iters: int = 20,
                reps: int = 2) -> float:
    """Per-iteration device seconds of ``body`` via the on-device
    dependency-chain slope (bench.py protocol): ``body(carry) -> carry``
    runs inside one ``lax.fori_loop`` whose trip count varies, and the
    slope between a short and a long chain isolates the device time.
    ``body`` must make its output depend on every stage it exercises.
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(b, steps):
        out = jax.lax.fori_loop(0, steps, lambda i, bb: body(bb), b)
        # reduce EVERY leaf to one real scalar: materializing it fences
        # the whole chain (np.asarray on a pytree would fetch nothing)
        return sum(jnp.real(leaf).astype(jnp.float32).sum()
                   for leaf in jax.tree.leaves(out))

    def run(n):
        t0 = time.perf_counter()
        np.asarray(chain(x0, n))
        return time.perf_counter() - t0

    run(2)
    lo, hi = 2, 2 + iters
    ts = [run(n) for _ in range(reps) for n in (lo, hi)]
    return (min(ts[1::2]) - min(ts[0::2])) / iters


def time_jitted(fn: Callable[[], Any], iters: int = 20,
                warmup: int = 3) -> float:
    """Mean steady-state seconds per call of ``fn`` (which must return a
    jax value to fence on).  Calls are enqueued back-to-back and fenced
    once, amortizing host->device round-trip latency exactly like the
    production frame loop."""
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn())
    t0 = time.perf_counter()
    outs = [fn() for _ in range(iters)]
    jax.block_until_ready(outs)
    return (time.perf_counter() - t0) / iters

"""Always-on sampling profiler.

A ``sys._current_frames()`` stack sampler on its own daemon thread:
every tick it snapshots each live thread's Python stack, folds it into
a bounded table of collapsed stacks (the flamegraph "folded" format),
and tags each sample with the thread's **active trace stage** via the
tracer's cross-thread span registry (``obs.trace.active_spans``) — so a
profile answers not only "where is the CPU" but "inside which wire/
admission stage".

Design constraints:

- **Bounded rate.** ``hz`` is clamped to [0, MAX_HZ]; the default 7 Hz
  (an off-round prime, so the sampler never phase-locks with periodic
  work) costs one ``sys._current_frames()`` + a fold-memo probe per
  live thread per tick (parked threads are never re-folded) —
  measured <5% on the fleet throughput bench (OBS_r11, the
  acceptance budget), 1-core-box scheduler churn included.
- **Bounded memory.** At most ``max_stacks`` unique collapsed stacks
  are retained (default 8192); samples landing past the bound are
  counted in ``overflow`` (exported as ``profiler_overflow_total``) —
  the profile's tail truncates, it never grows without bound.
- **Never on the hot path.** Request threads pay nothing: sampling is
  pull-based from the sampler thread; the only shared state is the
  stats dict behind a lock held for dict ops only.  A wedged sampler
  (the seeded ``obs.profiler_stall`` hang fault) parks the sampler
  thread alone — ``collapsed()``/``snapshot()`` keep serving whatever
  was already aggregated, and ``stop()`` is bounded by
  ``util.join_thread``.

Output: ``/debug/profilez`` (shared debug router, both listeners) in
collapsed-stack text — ``thread;stage:<s>;outer;...;inner count`` lines
ready for ``flamegraph.pl`` / speedscope, with a ``#``-comment header
(rate, window, sample/overflow counts).  ``?reset=1`` clears the table
after rendering.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional, Tuple

from .. import faults
from .. import logging as gklog
from ..metrics.catalog import record_profiler
from ..util import join_thread
from . import trace as obstrace

log = gklog.get("obs.profiler")

DEFAULT_HZ = 7.0      # off-round prime: never phase-locks periodic work.
#                       Low on purpose: a CONTINUOUS profiler accumulates
#                       over minutes, and every wakeup costs scheduler
#                       churn on a saturated (or 1-core) box — 7 Hz keeps
#                       the fleet-stream overhead within the <5% budget
#                       with plenty of samples (420/min)
MAX_HZ = 200.0        # rate bound: the sampler is telemetry, not a load
DEFAULT_MAX_STACKS = 8192
MAX_DEPTH = 64        # frames kept per stack (innermost dropped past it)


# filename -> basename memo: the sampler folds hundreds of frames per
# tick across every live thread, and the set of distinct filenames is
# tiny — basename() per frame is the folding loop's dominant cost
_BASENAMES: Dict[str, str] = {}


def _basename(path: str) -> str:
    b = _BASENAMES.get(path)
    if b is None:
        if len(_BASENAMES) > 4096:
            _BASENAMES.clear()  # pathological churn: reset, never grow
        b = _BASENAMES[path] = os.path.basename(path)
    return b


def _fold_frame(frame) -> str:
    code = frame.f_code
    return (
        f"{code.co_name} "
        f"({_basename(code.co_filename)}:{frame.f_lineno})"
    )


class SamplingProfiler:
    """The process profiler singleton (module ``get_profiler()``)."""

    def __init__(self, hz: float = DEFAULT_HZ,
                 max_stacks: int = DEFAULT_MAX_STACKS):
        self._lock = threading.Lock()   # guards the aggregate table only
        # per-INCARNATION stop event (created by start(), set by stop()):
        # a sampler wedged past its stop-join (the obs.profiler_stall
        # hang) keeps ITS OWN already-set event, so when it unwedges it
        # exits immediately instead of resuming alongside its
        # replacement — a shared cleared event would orphan it sampling
        # (and double-counting) forever
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.hz = 0.0
        self.max_stacks = max(int(max_stacks), 16)
        # (thread_name, stage, folded_stack) -> sample count
        self._counts: Dict[Tuple[str, str, Tuple[str, ...]], int] = {}
        # per-thread fold memo: ident -> (top-frame id, code id, lineno,
        # stage, folded key).  A parked thread sits in ONE frame for
        # minutes; re-walking+folding its unchanged stack every tick was
        # the sampler's dominant cost (only threads that MOVED get
        # folded).  The code-object id is part of the signature: frame
        # objects are recycled by the allocator, so a bare frame id at
        # the same lineno could false-hit across different functions
        self._fold_memo: Dict[int, Tuple[int, int, int, str, tuple]] = {}
        self.samples = 0
        self.overflow = 0
        self.stalls = 0            # error-mode obs.profiler_stall hits
        self._window_t0 = time.perf_counter()
        self.configure(hz=hz)

    # ---- configuration -----------------------------------------------------

    def configure(self, hz: Optional[float] = None,
                  max_stacks: Optional[int] = None):
        """Re-rate the sampler (restarting its thread when running);
        hz <= 0 stops it.  Returns self."""
        if max_stacks is not None:
            self.max_stacks = max(int(max_stacks), 16)
        if hz is not None:
            hz = min(max(float(hz), 0.0), MAX_HZ)
            running = self._thread is not None and self._thread.is_alive()
            self.hz = hz
            if running:
                self.stop()
                if hz > 0:
                    self.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        """Idempotent: a live sampler is kept, a dead one replaced."""
        if self.hz <= 0 or self.running:
            return self
        # a FRESH event per incarnation (never .clear() the old one: a
        # wedged predecessor must still see its own event set)
        stop = self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(stop,), name="gk-profiler",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            # bounded: a sampler wedged by the obs.profiler_stall hang
            # fault must not wedge shutdown (it is daemonized)
            join_thread(self._thread, 2.0, "sampling profiler")
            self._thread = None

    # ---- sampling ----------------------------------------------------------

    def _run(self, stop: threading.Event):
        interval = 1.0 / self.hz
        me = threading.get_ident()
        while not stop.wait(interval):
            if faults.ENABLED:
                try:
                    # hang-mode rules park the sampler HERE: the wedged-
                    # profiler failure class — aggregation and /debug/
                    # profilez must keep serving without it
                    faults.fire(faults.PROFILER_STALL)
                except Exception:
                    # error mode: skip this tick only, and count it
                    self.stalls += 1
                    continue
            try:
                self._sample_once(me)
            except Exception:
                # one bad tick (a thread died mid-walk) must not kill
                # the sampler; the miss is visible as a stall count
                self.stalls += 1
                log.debug("profiler tick failed", exc_info=True)

    def _sample_once(self, own_ident: int):
        frames = sys._current_frames()
        actives = obstrace.active_spans()
        names = {t.ident: t.name for t in threading.enumerate()}
        memo = self._fold_memo
        n = 0
        overflow = 0
        for ident, frame in frames.items():
            if ident == own_ident:
                continue
            span = actives.get(ident)
            stage = ""
            if span is not None:
                stage = str(span.attrs.get("stage") or span.name)
            sig = (id(frame), id(frame.f_code), frame.f_lineno, stage)
            cached = memo.get(ident)
            if cached is not None and cached[:4] == sig:
                key = cached[4]
            else:
                stack = []
                f = frame
                while f is not None and len(stack) < MAX_DEPTH:
                    stack.append(_fold_frame(f))
                    f = f.f_back
                stack.reverse()  # outermost first (folded convention)
                key = (names.get(ident, f"thread-{ident}"), stage,
                       tuple(stack))
                memo[ident] = (*sig, key)
            with self._lock:
                if key not in self._counts and \
                        len(self._counts) >= self.max_stacks:
                    self.overflow += 1
                    overflow += 1
                else:
                    self._counts[key] = self._counts.get(key, 0) + 1
                    self.samples += 1
                    n += 1
        # dead threads leave the memo (bounded by live-thread count)
        if len(memo) > 2 * len(frames):
            for ident in list(memo):
                if ident not in frames:
                    memo.pop(ident, None)
        record_profiler(n, overflow)

    # ---- output ------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            samples, overflow = self.samples, self.overflow
        return {
            "hz": self.hz,
            "running": self.running,
            "window_s": round(time.perf_counter() - self._window_t0, 3),
            "samples": samples,
            "unique_stacks": len(counts),
            "overflow": overflow,
            "stalls": self.stalls,
            "counts": counts,
        }

    def collapsed(self, reset: bool = False) -> str:
        """Folded flamegraph text: ``thread;stage:<s>;outer;...;inner
        count`` per line, preceded by ``#`` header comments."""
        snap = self.snapshot()
        lines = [
            f"# gk-profiler hz={snap['hz']} window_s={snap['window_s']} "
            f"samples={snap['samples']} "
            f"unique_stacks={snap['unique_stacks']} "
            f"overflow={snap['overflow']} stalls={snap['stalls']} "
            f"running={snap['running']}",
        ]
        for (thread, stage, stack), count in sorted(
            snap["counts"].items(), key=lambda kv: -kv[1]
        ):
            head = [thread]
            if stage:
                head.append(f"stage:{stage}")
            lines.append(";".join(head + list(stack)) + f" {count}")
        if reset:
            self.reset()
        return "\n".join(lines) + "\n"

    def reset(self):
        with self._lock:
            self._counts.clear()
            self.samples = 0
            self.overflow = 0
        self._window_t0 = time.perf_counter()


def env_hz(default: float = DEFAULT_HZ) -> float:
    """``$GK_PROFILER_HZ``, defensively parsed: a malformed value must
    not crash module import or argparse construction (every replica and
    supervisor spawn would die on a typo) — it falls back to the
    default with a warning."""
    raw = os.environ.get("GK_PROFILER_HZ", "")
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        log.warning("ignoring malformed GK_PROFILER_HZ=%r; using %s",
                    raw, default)
        return default


_PROFILER = SamplingProfiler(hz=env_hz())


def get_profiler() -> SamplingProfiler:
    return _PROFILER


def configure(hz: Optional[float] = None,
              max_stacks: Optional[int] = None) -> SamplingProfiler:
    return _PROFILER.configure(hz=hz, max_stacks=max_stacks)

"""Measure/View/Registry — the aggregation model behind the metric catalog.

Mirrors the semantics the reference gets from OpenCensus (views over
measures with tag keys; reference pkg/metrics/record.go): a view names one
aggregation of one measure, partitioned by tag values.  Supported
aggregations are the ones the catalog actually uses: count, sum,
last-value, and bucketed distribution.
"""

from __future__ import annotations

import bisect
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

# wall-clock anchor for exemplar timestamps: captured once at import so
# the hot-path record() never touches the wall clock (the obs/trace.py
# pattern; tools/check_observability.py enforces it)
_WALL_ANCHOR = time.time()  # wall-clock: ok (import-time anchor)
_PERF_ANCHOR = time.perf_counter()

AGG_COUNT = "count"
AGG_SUM = "sum"
AGG_LAST_VALUE = "last_value"
AGG_DISTRIBUTION = "distribution"


@dataclass(frozen=True)
class Measure:
    name: str
    description: str = ""
    unit: str = "1"


@dataclass
class View:
    name: str
    measure: Measure
    aggregation: str
    description: str = ""
    tag_keys: Tuple[str, ...] = ()
    buckets: Tuple[float, ...] = ()  # AGG_DISTRIBUTION only

    def __post_init__(self):
        if not self.description:
            self.description = self.measure.description
        if self.aggregation == AGG_DISTRIBUTION and not self.buckets:
            raise ValueError(f"view {self.name}: distribution requires buckets")


@dataclass(frozen=True)
class Exemplar:
    """One trace-linked sample on a distribution bucket: the
    OpenMetrics exemplar triple linking a hot histogram bucket to the
    /debug/traces entry that produced it."""

    value: float
    trace_id: str
    ts: float  # epoch seconds (anchor-derived, never a hot-path time.time)


@dataclass
class DistributionData:
    bucket_counts: List[int]
    count: int = 0
    sum: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    # bucket index -> latest exemplar; bounded by construction at one
    # exemplar per bucket (len(buckets)+1 entries at most)
    exemplars: Dict[int, Exemplar] = field(default_factory=dict)


@dataclass
class _ViewState:
    view: View
    # tag-value tuple (aligned with view.tag_keys) -> aggregated value
    rows: Dict[Tuple[str, ...], object] = field(default_factory=dict)


class Registry:
    """Thread-safe collection of registered views and their rows."""

    def __init__(self):
        self._views: Dict[str, _ViewState] = {}
        # measure name -> view states: record() is on the admission hot
        # path (stage histograms record per request), so the per-record
        # cost must be O(views of this measure), not O(all views)
        self._by_measure: Dict[str, List[_ViewState]] = {}
        self._lock = threading.Lock()

    def register(self, *views: View) -> None:
        with self._lock:
            for v in views:
                existing = self._views.get(v.name)
                if existing is not None:
                    # idempotent re-registration of an equal view keeps the
                    # accumulated rows; a conflicting definition is an error
                    if existing.view != v:
                        raise ValueError(f"view {v.name} already registered")
                    continue
                state = _ViewState(view=v)
                self._views[v.name] = state
                self._by_measure.setdefault(v.measure.name, []).append(state)

    def record(
        self,
        measure: Measure,
        value: float,
        tags: Optional[Dict[str, str]] = None,
        count: int = 1,
        exemplar_trace_id: Optional[str] = None,
    ) -> None:
        """Record one measurement against every view of this measure.
        ``count`` batches AGG_COUNT increments (N cache hits recorded in
        one lock hold); the other aggregations treat the call as a single
        sample regardless.  ``exemplar_trace_id`` (when the caller has an
        active trace) attaches a bounded per-bucket exemplar to every
        distribution view of the measure."""
        tags = tags or {}
        with self._lock:
            for state in self._by_measure.get(measure.name, ()):
                key = tuple(tags.get(k, "") for k in state.view.tag_keys)
                self._apply(state, key, value, count, exemplar_trace_id)

    def record_many(
        self,
        measure: Measure,
        samples,
        exemplar_trace_id: Optional[str] = None,
    ) -> None:
        """Record N ``(value, tags)`` measurements of one measure under
        a SINGLE lock hold — the event-loop edge flushes a request's
        six wire-stage observes in one call instead of six lock
        round-trips on the reactor thread."""
        with self._lock:
            for state in self._by_measure.get(measure.name, ()):
                keys = state.view.tag_keys
                for value, tags in samples:
                    key = tuple(tags.get(k, "") for k in keys)
                    self._apply(state, key, value, 1, exemplar_trace_id)

    def observer(self, measure: Measure, tag_key: str):
        """Prebound recorder for a single-tag measure on a reactor hot
        path: returns ``obs(pairs, exemplar_trace_id=None)`` with pairs
        ``[(tag_value, value)]`` — one lock hold for the whole batch,
        and the per-tag-value row key tuples memoized instead of
        rebuilt per sample.  Row objects are still fetched per call so
        :meth:`clear` keeps working.  Views registered after a tag
        value is first seen are not picked up for that value — build
        observers after catalog registration (the catalog does)."""
        memo: Dict[str, list] = {}

        def keyed(tv: str) -> list:
            rows = [
                (st, tuple(tv if k == tag_key else ""
                           for k in st.view.tag_keys))
                for st in self._by_measure.get(measure.name, ())
            ]
            memo[tv] = rows
            return rows

        bisect_left = bisect.bisect_left

        def obs(pairs, exemplar_trace_id: Optional[str] = None) -> None:
            with self._lock:
                for tv, value in pairs:
                    for st, key in (memo.get(tv) or keyed(tv)):
                        v = st.view
                        if v.aggregation != AGG_DISTRIBUTION:
                            self._apply(st, key, value, 1,
                                        exemplar_trace_id)
                            continue
                        # inlined _apply distribution branch: the stage
                        # histogram flush is the reactor's hottest
                        # metric path, worth skipping a frame per sample
                        dist = st.rows.get(key)
                        if dist is None:
                            dist = DistributionData(
                                bucket_counts=[0] * (len(v.buckets) + 1)
                            )
                            st.rows[key] = dist
                        idx = bisect_left(v.buckets, value)
                        dist.bucket_counts[idx] += 1
                        dist.count += 1
                        dist.sum += value
                        if value < dist.min:
                            dist.min = value
                        if value > dist.max:
                            dist.max = value
                        if exemplar_trace_id:
                            dist.exemplars[idx] = Exemplar(
                                value=float(value),
                                trace_id=exemplar_trace_id,
                                ts=_WALL_ANCHOR
                                + (time.perf_counter() - _PERF_ANCHOR),
                            )

        return obs

    def _apply(self, state, key, value, count, exemplar_trace_id) -> None:
        """One measurement into one view's row (caller holds _lock)."""
        v = state.view
        if v.aggregation == AGG_COUNT:
            state.rows[key] = int(state.rows.get(key, 0)) + count
        elif v.aggregation == AGG_SUM:
            state.rows[key] = float(state.rows.get(key, 0.0)) + value
        elif v.aggregation == AGG_LAST_VALUE:
            state.rows[key] = float(value)
        elif v.aggregation == AGG_DISTRIBUTION:
            dist = state.rows.get(key)
            if dist is None:
                dist = DistributionData(
                    bucket_counts=[0] * (len(v.buckets) + 1)
                )
                state.rows[key] = dist
            # first bound >= value, i.e. the "value <= bound" bucket;
            # bisect beats the linear scan on the wide stage histograms
            idx = bisect.bisect_left(v.buckets, value)
            dist.bucket_counts[idx] += 1
            dist.count += 1
            dist.sum += value
            dist.min = min(dist.min, value)
            dist.max = max(dist.max, value)
            if exemplar_trace_id:
                dist.exemplars[idx] = Exemplar(
                    value=float(value),
                    trace_id=exemplar_trace_id,
                    ts=_WALL_ANCHOR
                    + (time.perf_counter() - _PERF_ANCHOR),
                )

    def snapshot(self) -> List[Tuple[View, Dict[Tuple[str, ...], object]]]:
        import copy

        with self._lock:
            return [
                (s.view, copy.deepcopy(s.rows)) for s in self._views.values()
            ]

    def view_rows(self, name: str) -> Dict[Tuple[str, ...], object]:
        """Test/introspection helper: rows of one view by name."""
        import copy

        with self._lock:
            s = self._views.get(name)
            return copy.deepcopy(s.rows) if s else {}

    def clear(self) -> None:
        with self._lock:
            for s in self._views.values():
                s.rows.clear()


_global = Registry()


def global_registry() -> Registry:
    return _global


def record(measure: Measure, value: float, tags: Optional[Dict[str, str]] = None):
    """The analogue of metrics.Record (reference pkg/metrics/record.go)."""
    _global.record(measure, value, tags)

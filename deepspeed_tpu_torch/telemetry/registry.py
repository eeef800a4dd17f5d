"""Dependency-free metrics registry: Counter / Gauge / Histogram with labels.

Parity: ``deepspeed_tpu/telemetry/registry.py`` (a trimmed copy: the
lifetime state, without the sliding-window ring and the collectors, which
come with the exposition layer in a later slice). The port keeps its own
copy because importing anything of ``deepspeed_tpu`` imports jax.

* stdlib-only on the record path;
* rank-0 gated: under ``torch.distributed`` only rank 0 records (every rank
  records the same values in SPMD serving); resolved lazily, once;
* recording is a dict update under a lock, cheap enough for per-tick paths.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

LabelKey = Tuple[Tuple[str, str], ...]

# Prometheus-style latency buckets (seconds), from a sub-millisecond tick
# up to a long request.
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

_process_zero: Optional[bool] = None


def _is_process_zero() -> bool:
    """Rank-0 gate (``torch.distributed`` rank, when a group is up)."""
    global _process_zero
    if _process_zero is None:
        import torch.distributed as dist

        _process_zero = (not dist.is_available() or not dist.is_initialized()
                         or dist.get_rank() == 0)
    return _process_zero


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_labels(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, description: str, registry: "MetricsRegistry"):
        self.name = name
        self.description = description
        self._registry = registry
        self._lock = registry._lock
        self._children: Dict[LabelKey, Any] = {}

    def _enabled(self) -> bool:
        return self._registry.enabled and _is_process_zero()

    def labels_items(self):
        with self._lock:
            return list(self._children.items())


class Counter(_Metric):
    """Monotone counter; ``inc`` only accepts non-negative amounts."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._enabled():
            return
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._children[key] = self._children.get(key, 0.0) + amount

    def total(self) -> float:
        """Sum across every label combination."""
        with self._lock:
            return sum(self._children.values())


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._enabled():
            return
        with self._lock:
            self._children[_label_key(labels)] = float(value)

    def set_max(self, value: float, **labels) -> None:
        """Monotone high-water mark (peak queue depth, peak occupancy)."""
        if not self._enabled():
            return
        key = _label_key(labels)
        with self._lock:
            self._children[key] = max(self._children.get(key, float("-inf")),
                                      float(value))


class _HistogramChild:
    __slots__ = ("bucket_counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * (n_buckets + 1)  # +1 = the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def copy(self) -> "_HistogramChild":
        c = _HistogramChild(len(self.bucket_counts) - 1)
        c.bucket_counts = list(self.bucket_counts)
        c.count, c.sum, c.min, c.max = self.count, self.sum, self.min, self.max
        return c


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics). ``observe`` takes
    an optional ``n`` weight so a fused window can credit its per-item mean
    once per item without a Python loop."""

    kind = "histogram"

    def __init__(self, name: str, description: str, registry: "MetricsRegistry",
                 buckets: Optional[Sequence[float]] = None):
        super().__init__(name, description, registry)
        self.buckets = tuple(sorted(buckets if buckets is not None
                                    else DEFAULT_BUCKETS))

    def observe(self, value: float, n: int = 1, **labels) -> None:
        if not self._enabled() or n < 1:
            return
        value = float(value)
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = _HistogramChild(len(self.buckets))
            idx = len(self.buckets)
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    idx = i
                    break
            child.bucket_counts[idx] += n
            child.count += n
            child.sum += value * n
            child.min = min(child.min, value)
            child.max = max(child.max, value)

    def child(self, **labels) -> Optional[_HistogramChild]:
        with self._lock:
            live = self._children.get(_label_key(labels))
            return None if live is None else live.copy()

    @staticmethod
    def _quantile(buckets: Sequence[float], child: _HistogramChild,
                  q: float) -> float:
        """Bucket-interpolated quantile estimate (exact samples are not
        retained)."""
        if child.count == 0:
            return 0.0
        target = q * child.count
        seen = 0
        lo = 0.0
        for i, edge in enumerate(buckets):
            n = child.bucket_counts[i]
            if seen + n >= target and n > 0:
                frac = (target - seen) / n
                return min(lo + (edge - lo) * frac, child.max)
            seen += n
            lo = edge
        return child.max

    def summary(self, **labels) -> Dict[str, float]:
        child = self.child(**labels)
        if child is None or child.count == 0:
            return {"count": 0, "sum": 0.0}
        return {
            "count": child.count,
            "sum": round(child.sum, 9),
            "mean": round(child.sum / child.count, 9),
            "min": round(child.min, 9),
            "max": round(child.max, 9),
            "p50": round(self._quantile(self.buckets, child, 0.5), 9),
            "p95": round(self._quantile(self.buckets, child, 0.95), 9),
        }


class MetricsRegistry:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_make(self, cls, name: str, description: str, **kw):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}, requested {cls.kind}")
                return existing
            metric = cls(name, description, self, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, description: str = "") -> Counter:
        return self._get_or_make(Counter, name, description)

    def gauge(self, name: str, description: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, description)

    def histogram(self, name: str, description: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get_or_make(Histogram, name, description,
                                 buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready ``{"counters", "gauges", "histograms"}`` keyed by
        ``name{labels}`` (the JAX exposition's snapshot layout)."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {}, "histograms": {}}
        for metric in self.metrics():
            for key, value in metric.labels_items():
                name = metric.name + format_labels(key)
                if isinstance(metric, Histogram):
                    out["histograms"][name] = metric.summary(**dict(key))
                elif isinstance(metric, Counter):
                    out["counters"][name] = value
                else:
                    out["gauges"][name] = value
        return out

    def reset(self) -> None:
        """Tests only: zero every metric in place (engines cache their
        metric handles at construction)."""
        with self._lock:
            for m in self._metrics.values():
                m._children.clear()

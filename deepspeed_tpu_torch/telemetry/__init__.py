"""Telemetry of the port: one process-wide metrics registry and ``span()``.

Parity: ``deepspeed_tpu/telemetry/__init__.py`` (module-level API over the
default registry). Metric names are the JAX package's (``fastgen_*``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

from deepspeed_tpu_torch.telemetry.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from deepspeed_tpu_torch.telemetry.spans import span as _span

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "counter",
           "gauge", "histogram", "get_registry", "span", "snapshot", "reset"]

_default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _default_registry


def counter(name: str, description: str = "") -> Counter:
    return _default_registry.counter(name, description)


def gauge(name: str, description: str = "") -> Gauge:
    return _default_registry.gauge(name, description)


def histogram(name: str, description: str = "",
              buckets: Optional[Sequence[float]] = None) -> Histogram:
    return _default_registry.histogram(name, description, buckets=buckets)


def span(name: str, **labels):
    return _span(name, _default_registry, **labels)


def snapshot() -> Dict[str, Any]:
    return _default_registry.snapshot()


def reset() -> None:
    """Tests only: clear the default registry."""
    _default_registry.reset()

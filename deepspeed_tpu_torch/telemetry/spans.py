"""``span()``: wall-time histogram + a profiler range.

Parity: ``deepspeed_tpu/telemetry/spans.py`` ``span``. The JAX span emits a
``jax.profiler.TraceAnnotation``; here ``torch.profiler.record_function``
brackets the kernels the section launched in a ``torch.profiler`` trace.
The structured tracer and the stall watchdog (with the registry's
last-span record it reads) come in a later slice.

The wall time of a span that only enqueues GPU work is host time, not
device time: PyTorch returns before the card finishes. Fenced timings take
CUDA events or a ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import contextlib
import time

from torch.profiler import record_function

from deepspeed_tpu_torch.telemetry.registry import MetricsRegistry

SPAN_HISTOGRAM = "span_seconds"


@contextlib.contextmanager
def span(name: str, registry: MetricsRegistry, **labels):
    hist = registry.histogram(
        SPAN_HISTOGRAM, "wall time of telemetry.span sections")
    t0 = time.perf_counter()
    with record_function(name):
        try:
            yield
        finally:
            hist.observe(time.perf_counter() - t0, span=name, **labels)

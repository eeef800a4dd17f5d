"""Device seam of the port (counterpart of ``deepspeed_tpu/accelerator``)."""
from deepspeed_tpu_torch.accelerator.real_accelerator import (
    PinnedHost,
    device_count,
    device_name,
    memory_stats,
    on_device,
    resolve_device,
    synchronize,
)

__all__ = ["PinnedHost", "device_count", "device_name", "memory_stats", "on_device",
           "resolve_device", "synchronize"]

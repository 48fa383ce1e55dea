"""Device ms a step of the flash-attention kernels, forward and backward, found
by name (``benchmark/harness/attention.py::KERNELS``, ``pytorch_flash::
flash_fwd_*`` and ``pytorch_flash::flash_bwd_*``); None where none ran."""

from benchmark.harness import attention
from benchmark.harness.metrics import Context


def read(ctx: Context):
    s = attention.device_s(ctx.trace)
    return None if s is None else 1e3 * s / ctx.trace.units

"""The attention calls' least time over their profiled device time, %.

The calls (teacher, student forward and backward, target-stats forward)
are counted on the reference's architecture at the cell's shapes
(``benchmark/harness/attention.py``); the configuration and traffic are
read by path, as the context carries neither.  The kernels are those
``attn_device_ms.train`` reads; a forward call launches one
``pytorch_flash::flash_fwd_kernel``, a backward one
``pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel``.  None
where the trace shows another number of calls."""

from benchmark.harness import attention
from benchmark.harness.metrics import Context

CONFIG, TRAFFIC = "mitb5_daformer", "gta2city_warmup_mitb5_batch"


def read(ctx: Context):
    config, traffic = attention.read_cell_files(CONFIG, TRAFFIC)
    return attention.roofline(ctx.trace, attention.step_calls(config, traffic), ctx.elem_bytes,
                              ctx.peaks)

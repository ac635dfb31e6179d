"""Kernel layer (K1, ``ops/kernels/middle_block.py``, ``csrc/middle_block.cu``):
the middle flow's least time on the card over its measured time, in %.

The least time is the larger of its operations over the bf16 peak and its
bytes over HBM bandwidth (``flops.middle_flow``). The measured time is the
CUDA-event time of the folded backbone up to the last middle block minus
its time up to the block before the middle flow, both with the scorer's own
routes, on one call's images: the same work, whatever implements it."""
from bench_port import flops

UNIT = "%"


def read(ctx):
    fb = ctx.scorer.folded_backbone
    if ctx.probe_args is None or ctx.device.type != "cuda" or fb is None:
        return None
    cfg = ctx.cell.config
    rows = cfg["xception_blocks"]["rows"]
    middle = [k for k, r in enumerate(rows) if r[0] == r[1] and r[3] == 1]
    first, last = middle[0], middle[-1]
    _, x, _ = ctx.probe_inputs()
    kw = dict(use_kernels=ctx.scorer.use_kernels, **ctx.scorer.routes)
    upto = lambda k: (lambda: fb(x, upto=f"block{k + 1}", **kw))
    ms = ctx.cuda_ms(upto(last)) - ctx.cuda_ms(upto(first - 1))
    ops, nbytes = flops.middle_flow(cfg, x.shape[0], cfg["image_size"])
    least_s, _ = flops.least_seconds(ops, nbytes)
    return least_s * 1e3 / ms * 100

"""Whole step: the benchmark's operations of one ``score()`` (backbone over
every image the device computes, LSTM, head; ``flops.score_flops``) times
the window's calls, over the window's seconds, over the bf16 peak, in %."""
from bench_port import flops

UNIT = "%"


def read(ctx):
    per_call = ctx.cache.get("flops_per_call")
    if per_call is None or not ctx.window.calls or ctx.device.type != "cuda":
        return None
    return per_call * len(ctx.window.calls) / ctx.window.seconds / flops.PEAK_BF16_FLOPS * 100

"""Engine layer (``models/serve.py`` ``score()``): the median host-clock
time of the window's calls, each ending with the scores on the host."""
import statistics

UNIT = "ms"


def read(ctx):
    if not ctx.window.calls:
        return None
    return statistics.median(ctx.window.calls) * 1e3

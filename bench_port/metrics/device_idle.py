"""Device: the share of a profiled steady window of the cell's own traffic
in which no operation ran on the card (1 minus the union of the kernel,
copy and set intervals over the window), in %. The profiler is known to
drop kernel records on some cards, which reads high; the traced run prints
its records against the launches of a captured CUDA graph."""
UNIT = "%"


def read(ctx):
    if ctx.profile is None:
        return None
    return ctx.profile.idle_share * 100

"""Backbone layer (``models/fold.py::FoldedXception``): CUDA-event time of
the scorer's backbone over one call's images, already on the device."""
UNIT = "ms"


def read(ctx):
    if ctx.probe_args is None or ctx.device.type != "cuda":
        return None
    _, x, _ = ctx.probe_inputs()
    return ctx.cuda_ms(lambda: ctx.scorer._backbone_features(x))

"""MFCC frontend (``ops/mfcc.py``, ``models/serve.py::mfcc_images``):
CUDA-event time of one call's waveforms, on the device, to the backbone's
64 x 64 images."""
UNIT = "ms"


def read(ctx):
    if ctx.probe_args is None or ctx.device.type != "cuda" or ctx.cell.config["engine"] != "audio":
        return None
    d, _, _ = ctx.probe_inputs()
    return ctx.cuda_ms(lambda: ctx.cell.engine.images(ctx.scorer, d))

"""Head (``ops/lstm.py::lstm_apply``, ``models/heads.py``): the CUDA-event
time of the program's whole device call (``_score_impl``) over one call's
inputs, minus that of its own input conversion (uint8 to float, or the
MFCC frontend) and backbone over the same inputs. Both are the program's
functions, so the difference follows whatever implements the LSTM, the
last valid step and the head."""
UNIT = "ms"


def read(ctx):
    if ctx.probe_args is None or ctx.device.type != "cuda":
        return None
    d, _, _ = ctx.probe_inputs()
    eng, scorer = ctx.cell.engine, ctx.scorer
    whole = ctx.cuda_ms(lambda: scorer._score_impl(*d))
    upto_features = ctx.cuda_ms(lambda: scorer._backbone_features(eng.images(scorer, d)))
    return whole - upto_features

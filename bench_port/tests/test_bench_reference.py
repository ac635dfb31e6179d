"""The plain reference agrees with the port in fp32, kernels off, and the
weight maker's bundle has the port's layout."""
import numpy as np
import pytest
import torch

from bench_port import reference, spec, weights
from bench_port.tests.small import small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["visual-bulk", "audio-bulk"])
def test_reference_matches_the_port_in_fp32(cell):
    cfg, mix = small_cell(cell)
    eng = spec.engine(cfg["engine"])
    bundle = weights.make_bundle(cfg, 2 ** 31 + 21, eng.calibration(cfg, 3, CPU),
                                 eng.CALIBRATION_CLIPS)
    gen = spec.generator(mix["generator"])
    plan = gen.plan(mix, cfg, eng, 11, 1.0, CPU)
    args = plan.data["batches"][0]
    scorer = eng.build(cfg, bundle, CPU, {"compute_dtype": "float32", "device": "cpu"})
    got = eng.bulk_call(scorer, args)
    keys = [(0, i) for i in range(len(got))]
    with reference.ieee_fp32():
        ref = eng.reference(cfg, reference.load(bundle), [plan.clips[k] for k in keys], CPU)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    assert ref.std() > 0.01  # the seeded head spreads the scores


def test_bundle_keys_and_shapes_are_the_ports():
    from multimodal_deepfake_detection_tpu_torch.core.checkpoint import load_bundle
    from multimodal_deepfake_detection_tpu_torch.models.serve import load_visual_bundle

    cfg = spec.config("xception_lstm_v")
    eng = spec.engine("visual")
    small = dict(cfg, image_size=32)
    bundle = weights.make_bundle(small, 1, eng.calibration(small, 2, CPU), 2)
    model, arc = load_visual_bundle(bundle, cfg["hidden_dim"])  # strict: every key, every shape
    assert tuple(arc.w.shape) == (2, cfg["hidden_dim"])
    bundle.seek(0)
    n = sum(v.size for k, v in np.load(bundle).items() if not k.startswith("state/"))
    assert n == weights.parameter_count(cfg)
    bundle.seek(0)
    assert "state" in load_bundle(bundle)

"""The benchmark's operation count against the JAX package's."""
from bench_port import flops, spec

# bench.py::xception_net_flops(256, 256) and (1, 64), computed once with the
# JAX package on the CPU (the benchmark imports no JAX)
JAX_FLOPS_256_AT_256 = 3046776717312
JAX_FLOPS_1_AT_64 = 726560064


def test_xception_flops_equal_the_jax_count():
    cfg = spec.config("xception_lstm_v")
    assert flops.xception_flops(cfg, 256, 256) == JAX_FLOPS_256_AT_256
    assert flops.xception_flops(spec.config("xception_lstm_a"), 1, 64) == JAX_FLOPS_1_AT_64


def test_middle_flow_is_the_middle_blocks_share():
    cfg = spec.config("xception_lstm_v")
    assert flops.trunk_size(cfg, 256) == 16 and flops.trunk_size(cfg, 64) == 4
    ops, nbytes = flops.middle_flow(cfg, 400, 256)
    per_unit = 16 * 16 * (728 * 9 + 728 * 728) * 2
    assert ops == 400 * 8 * 3 * per_unit
    assert nbytes == (2 * 400 * 16 * 16 * 728 + 8 * 3 * (728 * 9 + 728 * 728 + 728)) * 2
    assert flops.least_seconds(ops, nbytes)[1] == "operations"


def test_score_flops_add_the_lstm_and_head():
    cfg = spec.config("xception_lstm_a")
    got = flops.score_flops(cfg, 64, 101)
    lstm = 64 * 101 * (2048 + 512) * 4 * 512 * 2
    head = 64 * (512 * 1024 + 3 * 1024 * 1024 + 1024) * 2
    assert got == flops.xception_flops(cfg, 64 * 101, 64) + lstm + head

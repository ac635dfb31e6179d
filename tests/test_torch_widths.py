"""No kernel wrapper refuses a width: the depthwise stages tiles of rows by
columns, so any W fits (the first design's band of whole rows refused W >
512, 256 with K4's fp32 mid and 1024 in the int8 depthwise). The CPU has no
CUDA tensor, so each wrapper's operand check runs on stand-ins that report
a CUDA device, at W = 65,536; N*H*W past int32 still raises.
"""
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.ops.kernels import (
    dw_w8a8,
    entry_block,
    entry_pair,
    middle_block,
    middle_block_w8,
    sepconv_unit,
)

WIDE = 1 << 16


class FakeCuda:
    """The attributes the operand checks read, of a contiguous, aligned
    CUDA tensor of ``shape`` and ``dtype``."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, shape, dtype=torch.float32):
        self.shape, self.dtype = torch.Size(shape), dtype

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 0


def _checks(W, N=1, H=2, C=16):
    """Each wrapper's operand check with x of (N, H, W, C) and well-formed
    weights."""
    x = FakeCuda((N, H, W, C), torch.bfloat16)
    bf = lambda *shape: FakeCuda(shape, torch.bfloat16)
    f32 = lambda *shape: FakeCuda(shape)
    i8 = lambda *shape: FakeCuda(shape, torch.int8)
    pair = (f32(9, C), bf(C, C), f32(C), f32(9, C), bf(C, C), f32(C))
    return {
        "middle_block": lambda: middle_block._check(x, f32(3, 9, C), bf(3, C, C), f32(3, C)),
        "middle_block_w8": lambda: middle_block_w8._check(
            x, f32(3, 9, C), i8(3, C, C), f32(3, C), f32(3, C), f32(3), f32(3, C)),
        "dw_w8a8": lambda: dw_w8a8._check(x, i8(C, 1, 3, 3), f32(C), f32(C), torch.bfloat16),
        "entry_pair": lambda: entry_pair.check_pair("entry_pair", x, *pair),
        "entry_block": lambda: entry_block._check(x, *pair, bf(C, C), f32(C)),
        "sepconv_unit": lambda: sepconv_unit._check(x, f32(9, C), bf(C, C), f32(C)),
    }


@pytest.mark.parametrize("kernel", sorted(_checks(8)))
def test_no_wrapper_refuses_a_width(kernel):
    _checks(WIDE)[kernel]()


@pytest.mark.parametrize("kernel", sorted(_checks(8)))
def test_pixels_past_int32_still_raise(kernel):
    with pytest.raises(ValueError, match="int32"):
        _checks(WIDE, N=1 << 15)[kernel]()

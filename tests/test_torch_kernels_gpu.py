"""K1's CUDA kernel against its plain PyTorch version, on the GPU.

Marked ``gpu``; skips where CUDA is absent. Run on a machine with an H100:
``python -m pytest tests/test_torch_kernels_gpu.py -q``. TF32 is off so the
plain version's fp32 matmul is exact on bf16 operands; the bound is the CPU
test's bf16 bound (rtol = atol = 1.6e-2) plus mean |d| <= 1e-3.
"""
import pytest
import torch

from multimodal_deepfake_detection_tpu_torch.ops.kernels.middle_block import (
    middle_block,
    middle_block_ref,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "N,H,C,dtype,ldk",
    [(15, 4, 728, torch.bfloat16, 736), (15, 4, 728, torch.bfloat16, 728),
     (3, 2, 728, torch.bfloat16, 736), (1, 1, 728, torch.bfloat16, 736),
     (5, 4, 728, torch.float32, 736), (4, 8, 40, torch.bfloat16, 64)],
)
def test_middle_block_kernel_matches_plain(cuda, N, H, C, dtype, ldk):
    """``ldk`` is the pointwise weight's row length; its padding holds NaN,
    which the kernel must never read."""
    g = torch.Generator().manual_seed(N * 1000 + H * 10 + C)
    x = torch.randn((N, H, H, C), generator=g).to(cuda, dtype)
    dw = (torch.randn((3, 9, C), generator=g) * 0.2).to(cuda)
    pw = torch.full((3, C, ldk), float("nan"))
    pw[..., :C] = torch.randn((3, C, C), generator=g) / C ** 0.5
    pw = pw.to(cuda, torch.bfloat16)
    b = (torch.randn((3, C), generator=g) * 0.1).to(cuda)
    before = middle_block.launches
    got = middle_block(x, dw, pw, b)
    torch.cuda.synchronize()
    assert middle_block.launches == before + 1
    ref = middle_block_ref(x, dw, pw, b)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=1.6e-2, atol=1.6e-2)
    assert (got.float() - ref.float()).abs().mean().item() <= 1e-3


def test_middle_block_rejects_non_contiguous(cuda):
    C = 16
    x = torch.randn((2, 4, C, 4), device=cuda).permute(0, 1, 3, 2)
    with pytest.raises(ValueError, match="contiguous"):
        middle_block(x, torch.zeros((3, 9, C), device=cuda),
                     torch.zeros((3, C, C), device=cuda, dtype=torch.bfloat16),
                     torch.zeros((3, C), device=cuda))

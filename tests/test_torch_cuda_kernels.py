"""The port's CUDA kernels (attention, selective scan) against their plain
versions, on a card.

Marked ``gpu``: without a CUDA card every test here skips.  The file
imports neither ``jax`` nor the JAX package, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_kernels.py

Tolerances are those of the CPU tests: 2e-5 in fp32; 2e-2 (prefill) and
3e-2 (decode) in bf16, where the plain version rounds scores and
probabilities to bf16 and the kernel keeps them in fp32; 2e-4 for the
scan (fp32), whose kernel sums over the states in another order.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.mamba_scan import (DISPATCHES as SCANS, mamba_scan,
                                            mamba_scan_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,S,D,window", [(37, 200, 16, None),
                                          (256, 256, 128, 64),
                                          (65, 65, 256, None)])
def test_flash_kernel_matches_plain_on_the_card(cuda, dtype, tol, T, S, D,
                                                window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 4, T, D), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((2, 2, S, D), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((2, 2, S, D), generator=g, device=cuda, dtype=dtype)
    got = flash_attention(q, k, v, causal=True, window=window)
    want = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 3e-2)])
def test_decode_kernel_matches_plain_on_the_card(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((4, 32, 128), generator=g, device=cuda, dtype=dtype)
    k = torch.randn((4, 16, 2048, 128), generator=g, device=cuda, dtype=dtype)
    v = torch.randn((4, 16, 2048, 128), generator=g, device=cuda, dtype=dtype)
    lens = torch.tensor([1, 700, 1553, 2048], dtype=torch.int32, device=cuda)
    got = decode_attention(q, k, v, lens)
    want = decode_attention_ref(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,D,N", [(1, 1, 64, 16), (2, 37, 96, 8),
                                     (4, 777, 8192, 16), (3, 130, 40, 16),
                                     (2, 50, 24, 3)])
def test_mamba_scan_kernel_matches_plain_on_the_card(cuda, B, T, D, N):
    g = torch.Generator(device=cuda).manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=cuda)

    x = normal(B, T, D)
    delta = torch.nn.functional.softplus(normal(B, T, D) - 4.6)
    A = -torch.exp(normal(D, N))
    args = (x, delta, A, normal(B, T, N), normal(B, T, N), normal(D))
    launched = SCANS.kernel_launches
    y, hT = mamba_scan(*args)
    assert SCANS.kernel_launches == launched + 1
    y_want, h_want = mamba_scan_ref(*args)
    assert hT.shape == (B, D, N)
    torch.testing.assert_close(y, y_want, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(hT, h_want, atol=2e-4, rtol=2e-4)

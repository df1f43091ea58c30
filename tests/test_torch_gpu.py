"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: they need an NVIDIA card and ``nvcc``, and skip with a
reason elsewhere.  On a machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py imports JAX, and this file needs
none.)
"""
import pytest
import torch

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: dict(atol=2e-5, rtol=2e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels import _lib
    try:
        _lib._nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("N,D", [(1, 896), (8, 896), (13, 960), (2048, 896),
                                 (5, 100), (3, 16384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, N, D, dtype):
    from repro_torch.kernels import _lib
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd, rmsnorm_fwd_plain
    x = torch.randn(N, D, generator=cuda, device="cuda").to(dtype)
    s = torch.randn(D, generator=cuda, device="cuda") + 1.0
    before = _lib.launches["rmsnorm_fwd"]
    got = rmsnorm_fwd(x, s, 1e-6)
    torch.cuda.synchronize()
    assert _lib.launches["rmsnorm_fwd"] == before + 1
    torch.testing.assert_close(got, rmsnorm_fwd_plain(x, s, 1e-6),
                               **TOLS[dtype])


@pytest.mark.parametrize("B,S,H,KVH,hd", [
    (8, 1024, 14, 2, 64),      # qwen2-0.5b serve shape (G=7)
    (3, 37, 15, 5, 64),        # smollm-360m heads, odd S
    (2, 2048, 8, 1, 128),      # MQA, hd=128
    (2, 100, 6, 3, 36),        # bf16 rows of 72 bytes: the scalar-load path
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, B, S, H, KVH, hd, dtype):
    from repro_torch.kernels.decode_attention import (flash_decode,
                                                      flash_decode_plain)
    q = torch.randn(B, H, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=cuda, device="cuda",
                            dtype=torch.int32)
    lengths[0] = S                              # one full-length sequence
    got = flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, flash_decode_plain(q, k, v, lengths),
                               **TOLS[dtype])


def test_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    x = torch.randn(8, 64, device="cuda", dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        rmsnorm_fwd(x, torch.ones(64, device="cuda"))
    q = torch.randn(2, 4, 256, device="cuda")
    k = torch.randn(2, 8, 2, 256, device="cuda")
    with pytest.raises(ValueError, match="hd=256"):
        flash_decode(q, k, k, torch.ones(2, dtype=torch.int32, device="cuda"))

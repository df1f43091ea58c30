"""The port's kernels on the CPU: each plain PyTorch version against the
JAX package's Pallas kernel in interpret mode (the shapes and tolerances
of tests/test_kernels.py), and the CUDA wrappers' refusals.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.rmsnorm import rmsnorm_fwd as jax_rmsnorm_fwd
from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (flash_decode,
                                                  flash_decode_plain)
from repro_torch.kernels.rmsnorm import rmsnorm_fwd, rmsnorm_fwd_plain

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tols(dtype):
    # tests/test_kernels.py:17-19
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def both(a: np.ndarray, dtype: str):
    """The same numbers in both frameworks, rounded once to ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def close(t: torch.Tensor, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tols(dtype))


# ---------------------------------------------------------------------------
# rmsnorm_fwd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,D", [(256, 512), (1024, 960), (512, 896),
                                 (8, 896), (13, 960)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(N, D, dtype):
    rs = np.random.RandomState(N + D)
    xj, xt = both(rs.randn(N, D).astype(np.float32), dtype)
    s = (rs.randn(D) + 1.0).astype(np.float32)
    expected = jax_rmsnorm_fwd(xj, jnp.asarray(s), interpret=True)
    out = ops.rmsnorm(xt, torch.from_numpy(s))
    assert out.dtype == xt.dtype and out.shape == (N, D)
    close(out, expected, dtype)
    close(ref.rmsnorm_ref(xt, torch.from_numpy(s)),
          jax_ref.rmsnorm_ref(xj, jnp.asarray(s)), dtype)


def test_rmsnorm_ops_keeps_leading_dims():
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 1, 64)
                         .astype(np.float32))
    s = torch.ones(64)
    out = ops.rmsnorm(x, s, 1e-6)
    assert out.shape == (3, 1, 64)
    torch.testing.assert_close(out.reshape(3, 64),
                               rmsnorm_fwd_plain(x.reshape(3, 64), s))


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,KVH,hd", [
    (1, 512, 4, 2, 64),
    (2, 1024, 8, 8, 64),
    (3, 512, 14, 2, 64),     # qwen2-0.5b head layout (G=7)
    (2, 2048, 8, 1, 128),    # MQA long cache
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_plain_matches_pallas(B, S, H, KVH, hd, dtype):
    rs = np.random.RandomState(B * S + H)
    qj, qt = both(rs.randn(B, H, hd).astype(np.float32), dtype)
    kj, kt = both(rs.randn(B, S, KVH, hd).astype(np.float32), dtype)
    vj, vt = both(rs.randn(B, S, KVH, hd).astype(np.float32), dtype)
    lengths = rs.randint(1, S, size=(B,)).astype(np.int32)
    expected = jax_flash_decode(qj, kj, vj, jnp.asarray(lengths),
                                block_k=256, interpret=True)
    out = ops.flash_decode(qt, kt, vt, torch.from_numpy(lengths))
    assert out.dtype == qt.dtype and out.shape == (B, H, hd)
    close(out, expected, dtype)


@pytest.mark.parametrize("S", [1, 37, 1000])
def test_flash_decode_plain_any_length_matches_oracle(S):
    """Cache lengths the Pallas wrapper refuses (S % block_k != 0): the
    port takes any S; held against the JAX oracle."""
    rs = np.random.RandomState(S)
    B, H, KVH, hd = 3, 14, 2, 64
    qj, qt = both(rs.randn(B, H, hd).astype(np.float32), "float32")
    kj, kt = both(rs.randn(B, S, KVH, hd).astype(np.float32), "float32")
    vj, vt = both(rs.randn(B, S, KVH, hd).astype(np.float32), "float32")
    lengths = rs.randint(1, S + 1, size=(B,)).astype(np.int32)
    expected = jax_ref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths))
    close(flash_decode_plain(qt, kt, vt, torch.from_numpy(lengths)),
          expected, "float32")
    close(ref.decode_attention_ref(qt, kt, vt, torch.from_numpy(lengths)),
          expected, "float32")


def test_flash_decode_plain_empty_sequence_is_zero():
    """length 0: no key is valid; the kernel's -1e30 mask and l floor
    give zeros (the -inf oracle would give NaN)."""
    q = torch.randn(2, 4, 16)
    k = torch.randn(2, 8, 2, 16)
    out = flash_decode_plain(q, k, k, torch.tensor([0, 3], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------
# no silent fallback: the CUDA wrappers refuse what is not on the card
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.randn(8, 64)
    with pytest.raises(ValueError, match="rmsnorm_fwd"):
        rmsnorm_fwd(x, torch.ones(64))
    q, k = torch.randn(2, 4, 16), torch.randn(2, 8, 2, 16)
    lengths = torch.tensor([1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="flash_decode"):
        flash_decode(q, k, k, lengths)
    with pytest.raises(NotImplementedError, match="logit_cap"):
        flash_decode(q, k, k, lengths, logit_cap=30.0)


def test_ops_dispatch_non_cpu_tensor_to_the_kernel():
    """A tensor that is not on the CPU never takes the plain version: a
    meta tensor goes to the CUDA wrapper, which raises."""
    x = torch.empty(8, 64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(x, torch.empty(64, device="meta"))
    q = torch.empty(2, 4, 16, device="meta")
    k = torch.empty(2, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_decode(q, k, k, torch.empty(2, dtype=torch.int32,
                                              device="meta"))


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the refusal is for CPU-only boxes")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)                  # the default is the card
    assert resolve_device("cpu").type == "cpu"

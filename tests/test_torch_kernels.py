"""The port's kernels on the CPU: each plain PyTorch version against the
JAX package's Pallas kernel in interpret mode (the shapes and tolerances
of tests/test_kernels.py), the training ops' gradients against
``jax.grad`` of the JAX ``ops``, and the CUDA wrappers' refusals.  The
CUDA kernels themselves are held against the plain versions on the card
by tests/test_torch_gpu.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.decode_attention import flash_decode as jax_flash_decode
from repro.kernels.flash_attention import \
    flash_attention as jax_flash_attention
from repro.kernels.rmsnorm import rmsnorm_bwd as jax_rmsnorm_bwd
from repro.kernels.rmsnorm import rmsnorm_fwd as jax_rmsnorm_fwd
from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (flash_decode,
                                                  flash_decode_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (BWD_BLOCK_ROWS, rmsnorm_bwd,
                                         rmsnorm_bwd_plain, rmsnorm_fwd,
                                         rmsnorm_fwd_plain)

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
# rmsnorm_bwd and the rmsnorm op's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [512, 77])
def test_rmsnorm_bwd_plain_matches_pallas(N):
    """tests/test_kernels.py:111-122: dx within 1e-4, the summed dscale
    within 1e-3 (the partials are summed in another grouping: 256-row
    blocks in the Pallas kernel, 32-row blocks here).  N=77 has a ragged
    last block, which the Pallas wrapper refuses: it is held against the
    autodiff of the JAX oracle."""
    rs = np.random.RandomState(N)
    x = rs.randn(N, 256).astype(np.float32)
    s = (rs.randn(256) + 1.0).astype(np.float32)
    g = rs.randn(N, 256).astype(np.float32)
    if N % 256 == 0:
        dx, ds = jax_rmsnorm_bwd(jnp.asarray(x), jnp.asarray(s),
                                 jnp.asarray(g), interpret=True)
        ds = jnp.sum(ds, axis=0)
    else:
        dx, ds = jax.vjp(jax_ref.rmsnorm_ref, jnp.asarray(x),
                         jnp.asarray(s))[1](jnp.asarray(g))
    pdx, part = rmsnorm_bwd_plain(torch.from_numpy(x), torch.from_numpy(s),
                                  torch.from_numpy(g))
    assert part.shape == (-(-N // BWD_BLOCK_ROWS), 256)
    assert part.dtype == torch.float32 and pdx.dtype == torch.float32
    np.testing.assert_allclose(pdx.numpy(), np.asarray(dx),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(part.sum(0).numpy(), np.asarray(ds),
                               atol=1e-3, rtol=1e-3)


def test_rmsnorm_bwd_plain_keeps_bf16():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randn(40, 64).astype(np.float32))
    g = torch.from_numpy(rs.randn(40, 64).astype(np.float32))
    s = torch.ones(64)
    dx, part = rmsnorm_bwd_plain(x.bfloat16(), s, g.bfloat16())
    want, _ = rmsnorm_bwd_plain(x.bfloat16().float(), s, g.bfloat16().float())
    assert dx.dtype == torch.bfloat16 and part.dtype == torch.float32
    close(dx, want.numpy(), "bfloat16")


def test_rmsnorm_op_grad_matches_jax():
    """tests/test_kernels.py:124-132: the custom-VJP op's gradients."""
    rs = np.random.RandomState(4)
    x = rs.randn(256, 128).astype(np.float32)
    s = (rs.randn(128) + 1.0).astype(np.float32)
    gx, gs = jax.grad(lambda x_, s_: jnp.sum(
        jax_ops.rmsnorm(x_, s_, 1e-6, True) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(s))
    xt = torch.from_numpy(x).requires_grad_()
    st = torch.from_numpy(s).requires_grad_()
    (ops.rmsnorm(xt.reshape(4, 64, 128), st, 1e-6) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=1e-4)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), atol=1e-3)


# ---------------------------------------------------------------------------
# flash_attention and the attention op's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd", [
    (1, 256, 512, 6, 3, 64),     # GQA, Sk > Sq
    (2, 128, 128, 8, 2, 128),
    (1, 384, 384, 3, 1, 64),     # MQA, odd head count
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(B, Sq, Sk, H, KVH, hd, causal,
                                              dtype):
    rs = np.random.RandomState(B * Sq + H + causal)
    qj, qt = both(rs.randn(B, Sq, H, hd).astype(np.float32), dtype)
    kj, kt = both(rs.randn(B, Sk, KVH, hd).astype(np.float32), dtype)
    vj, vt = both(rs.randn(B, Sk, KVH, hd).astype(np.float32), dtype)
    expected = jax_flash_attention(qj, kj, vj, causal=causal, interpret=True)
    out = ops.flash_attention(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == (B, Sq, H, hd)
    close(out, expected, dtype)
    close(ref.flash_attention_ref(qt, kt, vt, causal=causal),
          jax_ref.flash_attention_ref(qj, kj, vj, causal=causal), dtype)


@pytest.mark.parametrize("Sq,Sk", [(100, 100), (37, 101)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_any_length_matches_oracle(Sq, Sk, causal):
    """Lengths the Pallas wrapper refuses (not multiples of its blocks):
    the port takes them; held against the JAX oracle."""
    rs = np.random.RandomState(Sq + Sk)
    qj, qt = both(rs.randn(2, Sq, 6, 32).astype(np.float32), "float32")
    kj, kt = both(rs.randn(2, Sk, 3, 32).astype(np.float32), "float32")
    vj, vt = both(rs.randn(2, Sk, 3, 32).astype(np.float32), "float32")
    close(flash_attention_plain(qt, kt, vt, causal=causal),
          jax_ref.flash_attention_ref(qj, kj, vj, causal=causal), "float32")


def test_flash_attention_op_grad_matches_jax():
    """tests/test_kernels.py:55-73: the backward recomputes through the
    oracle, as the JAX custom VJP does."""
    rs = np.random.RandomState(5)
    arrays = [rs.randn(1, 128, 2, 64).astype(np.float32) for _ in range(3)]
    want = jax.grad(lambda q, k, v: jnp.sum(
        jax_ops.flash_attention(q, k, v, True, True) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    (ops.flash_attention(*leaves, causal=True) ** 2).sum().backward()
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_training_ops_under_no_grad_record_nothing():
    x = torch.randn(4, 32, requires_grad=True)
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    with torch.no_grad():
        assert ops.rmsnorm(x, torch.ones(32)).grad_fn is None
        assert ops.flash_attention(q, q, q).grad_fn is None


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
    with pytest.raises(ValueError, match="rmsnorm_bwd"):
        rmsnorm_bwd(x, torch.ones(64), x)
    q4 = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention(q4, q4, q4)


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
    q4 = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q4, q4, q4)


def test_new_cuda_wrappers_raise_for_the_card_without_cuda():
    """On a box without CUDA, asking for the card raises: no tensor can be
    placed there, and the wrappers never take the plain version."""
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the refusal is for CPU-only boxes")
    with pytest.raises((RuntimeError, AssertionError)):
        torch.empty(8, 64, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA: the refusal is for CPU-only boxes")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)                  # the default is the card
    assert resolve_device("cpu").type == "cpu"

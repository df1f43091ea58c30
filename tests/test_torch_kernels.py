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
from repro.kernels.ssd_scan import ssd_chunk as jax_ssd_chunk
from repro_torch import resolve_device
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (CARD_SMS, KEY_TILE,
                                                  decode_split_keys,
                                                  decode_splits, flash_decode,
                                                  flash_decode_plain,
                                                  flash_decode_split_plain)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (BWD_BLOCK_ROWS, rmsnorm_bwd,
                                         rmsnorm_fwd_path,
                                         rmsnorm_bwd_plain, rmsnorm_fwd,
                                         rmsnorm_fwd_plain)
from repro_torch.kernels.ref import prefix_sum
from repro_torch.kernels.ssd_scan import (MAX_HEAD_BLOCK, ssd_chunk,
                                          ssd_grid, ssd_head_block,
                                          ssd_states_bf16_plain)

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


@pytest.mark.parametrize("S,split_keys,lens", [
    (512, 64, [0, 64, 65, 512]),      # length 0, on a boundary, one past, S
    (512, 128, [1, 127, 128, 300]),   # empty splits behind every length
    (1024, 64, [1000, 5, 129, 1024]),
    (1024, 1024, [3, 1023, 0, 640]),  # one split
])
def test_flash_decode_split_plain_matches_pallas(S, split_keys, lens):
    """The CUDA kernel's split partials and their combine, in plain
    PyTorch, against the JAX package's flash_decode (interpret mode) and,
    where a key is valid, its oracle."""
    rs = np.random.RandomState(S + split_keys)
    B, H, KVH, hd = 4, 14, 2, 64
    qj, qt = both(rs.randn(B, H, hd).astype(np.float32), "float32")
    kj, kt = both(rs.randn(B, S, KVH, hd).astype(np.float32), "float32")
    vj, vt = both(rs.randn(B, S, KVH, hd).astype(np.float32), "float32")
    lengths = np.asarray(lens, np.int32)
    out = flash_decode_split_plain(qt, kt, vt, torch.from_numpy(lengths),
                                   split_keys=split_keys)
    assert out.shape == (B, H, hd) and torch.isfinite(out).all()
    expected = jax_flash_decode(qj, kj, vj, jnp.asarray(lengths),
                                block_k=256, interpret=True)
    close(out, expected, "float32")
    seen = lengths > 0                 # the -inf oracle gives NaN at length 0
    oracle = np.asarray(jax_ref.decode_attention_ref(qj, kj, vj,
                                                     jnp.asarray(lengths)))
    close(out[torch.from_numpy(seen)], oracle[seen], "float32")
    assert torch.all(out[torch.from_numpy(~seen)] == 0)


@pytest.mark.parametrize("B,KVH,S", [(8, 2, 1024), (64, 4, 256), (64, 2, 1024),
                                     (1, 1, 40000), (3, 5, 37), (2, 1, 2048),
                                     (1, 1, 1)])
def test_decode_split_rule(B, KVH, S):
    """Keys per split: a multiple of the kernel's key tile, from the shapes
    alone; the splits cover S with no empty tail split, and B*KVH*splits
    is at most about two CTAs a SM and, for a long cache, at least one (one
    split once B*KVH covers the SMs)."""
    sk = decode_split_keys(B, KVH, S)
    n = decode_splits(B, KVH, S)
    assert sk % KEY_TILE == 0 and sk >= KEY_TILE
    assert (n - 1) * sk < S <= n * sk
    if B * KVH >= CARD_SMS:
        assert n == 1
    else:
        assert B * KVH * n <= 2 * CARD_SMS + B * KVH
        if S >= 2 * CARD_SMS * KEY_TILE:
            assert B * KVH * n >= CARD_SMS
    if (B, KVH, S) == (8, 2, 1024):    # qwen2-0.5b's serve shape
        assert (sk, n) == (64, 16)


# ---------------------------------------------------------------------------
# ssd_chunk and the SSD op's gradient
# ---------------------------------------------------------------------------

def _ssd_inputs(B, Q, nh, hp, ds, seed):
    """tests/test_kernels.py:149-154's distributions, made with numpy."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, Q, nh, hp).astype(np.float32)
    b = rs.randn(B, Q, ds).astype(np.float32)
    c = rs.randn(B, Q, ds).astype(np.float32)
    dt = (np.logaddexp(rs.randn(B, Q, nh), 0.0) * 0.1).astype(np.float32)
    a_log = rs.uniform(0.0, 2.0, size=(nh,)).astype(np.float32)
    return x, b, c, dt, a_log


def _ssd_close(got, want, dtype):
    """tests/test_kernels.py:155-162: y at the kernel tolerance, the
    states at 3e-2 (bf16) / 3e-5 (f32), the decay at 1e-5."""
    (y, st, dec), (wy, wst, wdec) = got, want
    close(y, wy, dtype)
    tol = 3e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), atol=tol, rtol=tol)
    np.testing.assert_allclose(dec.numpy(), np.asarray(wdec), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("B,Q,nh,hp,ds", [
    (1, 64, 8, 32, 32),
    (2, 128, 16, 64, 64),
    (1, 256, 8, 64, 128),    # mamba2-1.3b-like chunk
    (2, 100, 4, 32, 64),     # Q not a multiple of the kernel's 64-row tile
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dt_f32", [False, True])
def test_ssd_chunk_plain_matches_pallas(B, Q, nh, hp, ds, dtype, dt_f32):
    """dt in x's dtype (as tests/test_kernels.py feeds it) and in f32 (as
    the model feeds it, after an f32 softplus)."""
    arrays = _ssd_inputs(B, Q, nh, hp, ds, seed=B * Q + nh)
    xj, xt = both(arrays[0], dtype)
    bj, bt = both(arrays[1], dtype)
    cj, ct = both(arrays[2], dtype)
    dtj, dtt = both(arrays[3], "float32" if dt_f32 else dtype)
    alj, alt = both(arrays[4], "float32")
    want = jax_ssd_chunk(xj, bj, cj, dtj, alj, block_h=max(nh // 2, 1),
                         interpret=True)
    got = ops.ssd_chunk(xt, bt, ct, dtt, alt)
    assert got[0].dtype == xt.dtype and got[0].shape == (B, Q, nh, hp)
    assert got[1].dtype == torch.float32 and got[1].shape == (B, nh, hp, ds)
    assert got[2].dtype == torch.float32 and got[2].shape == (B, nh)
    _ssd_close(got, want, dtype)


@pytest.mark.parametrize("B,Q,nh,hp,ds", [
    (1, 64, 8, 32, 32),
    (2, 128, 16, 64, 64),
    (1, 256, 8, 64, 128),    # mamba2-1.3b-like chunk
    (2, 100, 4, 32, 64),
])
def test_ssd_states_without_low_part_match_pallas(B, Q, nh, hp, ds):
    """The bf16 kernel's state takes the decayed x as one bf16 operand
    (no low part): that rounding, emulated in plain PyTorch, still holds
    the states to the Pallas kernel (interpret mode) at
    tests/test_kernels.py's bf16 tolerance of the states, 3e-2."""
    arrays = _ssd_inputs(B, Q, nh, hp, ds, seed=B * Q + nh + 1)
    xj, xt = both(arrays[0], "bfloat16")
    bj, bt = both(arrays[1], "bfloat16")
    cj, _ = both(arrays[2], "bfloat16")
    dtj, dtt = both(arrays[3], "float32")
    alj, alt = both(arrays[4], "float32")
    _, want, _ = jax_ssd_chunk(xj, bj, cj, dtj, alj, block_h=max(nh // 2, 1),
                               interpret=True)
    got = ssd_states_bf16_plain(xt, bt, dtt, alt)
    assert got.dtype == torch.float32 and got.shape == (B, nh, hp, ds)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-2,
                               rtol=3e-2)


# every shape of tests/test_torch_gpu.py::test_ssd_chunk_kernel_matches_plain
SSD_GPU_SHAPES = [(32, 256, 64, 64, 128), (1, 64, 8, 32, 32),
                  (2, 128, 16, 64, 64), (1, 256, 8, 64, 128),
                  (2, 1000, 8, 64, 128), (3, 37, 5, 16, 16),
                  (1, 300, 2, 128, 256)]


@pytest.mark.parametrize("B,Q,nh,hp,ds", SSD_GPU_SHAPES)
def test_ssd_head_block_rule(B, Q, nh, hp, ds):
    """The heads a y CTA shares its S tiles over: from the shapes alone,
    between 1 and the kernel's 8, at most nh (odd nh too: the last block
    is ragged), and halved only while the y CTAs number fewer than two a
    SM; the mamba2-1.3b training shape gets the TPU kernel's 8 heads and
    fills the card's 132 SMs."""
    hb = ssd_head_block(B, Q, nh)
    assert hb == ssd_head_block(B, Q, nh)
    assert 1 <= hb <= min(MAX_HEAD_BLOCK, nh)
    n_y, n_state = ssd_grid(B, Q, nh, hp, ds)
    assert n_y == B * -(-Q // 64) * -(-nh // hb)
    assert n_state == B * nh * -(-hp // 64) * -(-ds // 128)
    if hb < min(MAX_HEAD_BLOCK, nh):
        assert B * -(-Q // 64) * -(-nh // (2 * hb)) < 2 * 132
    if (B, Q, nh) == (32, 256, 64):
        assert hb == 8 and n_y >= 132 and n_y + n_state >= 2 * 132


@pytest.mark.parametrize("D,dtype,path", [
    (896, torch.bfloat16, "rows"), (960, torch.bfloat16, "rows"),
    (2048, torch.bfloat16, "rows"), (4096, torch.bfloat16, "rows"),
    (4104, torch.bfloat16, "cta"), (4100, torch.bfloat16, "cta"),
    (100, torch.bfloat16, "cta"), (16384, torch.bfloat16, "cta"),
    (896, torch.float32, "rows"), (960, torch.float32, "rows"),
    (2048, torch.float32, "rows"), (2052, torch.float32, "cta"),
    (4096, torch.float32, "cta"), (100, torch.float32, "rows"),
    (101, torch.float32, "cta"),
])
def test_rmsnorm_fwd_path_rule(D, dtype, path):
    """The forward kernel's path, from D and the dtype alone: the rows path
    (a warp a row, the row in registers) up to 256 bytes a lane of whole
    16-byte chunks (bf16 D <= 4096, f32 D <= 2048), the CTA path past that
    boundary and for a row that is not whole 16-byte chunks."""
    assert rmsnorm_fwd_path(D, dtype) == path


@pytest.mark.parametrize("N", [1, 16, 17, 100, 256, 1000])
def test_prefix_sum_is_jnp_cumsum_bit_for_bit(N):
    """ssd_chunk's prefix sum adds in the order XLA's CPU backend gives
    jnp.cumsum (the JAX oracle's and the Pallas kernel's prefix sum)."""
    rs = np.random.RandomState(N)
    a = (-np.logaddexp(rs.randn(2, N, 5), 0.0) * 0.7).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(a), axis=1))
    np.testing.assert_array_equal(prefix_sum(torch.from_numpy(a)).numpy(),
                                  want)


def test_ssd_chunk_op_grad_matches_jax():
    """The backward recomputes through the oracle, as the JAX custom VJP
    does (repro.kernels.ops.ssd_chunk): the vector-Jacobian product of
    random cotangents, for every input, within 1e-4 in f32."""
    arrays = _ssd_inputs(2, 64, 4, 16, 16, seed=11)
    rs = np.random.RandomState(12)
    cot = (rs.randn(2, 64, 4, 16).astype(np.float32),
           rs.randn(2, 4, 16, 16).astype(np.float32),
           rs.randn(2, 4).astype(np.float32))
    _, vjp = jax.vjp(lambda *a: jax_ops.ssd_chunk(*a, True),
                     *map(jnp.asarray, arrays))
    want = vjp(tuple(map(jnp.asarray, cot)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrays]
    outs = ops.ssd_chunk(*leaves)
    got = torch.autograd.grad(outs, leaves, tuple(map(torch.from_numpy, cot)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)


def test_ssd_chunk_under_no_grad_records_nothing():
    x = torch.randn(1, 8, 2, 16, requires_grad=True)
    b = torch.randn(1, 8, 16)
    with torch.no_grad():
        y, st, dec = ops.ssd_chunk(x, b, b, torch.rand(1, 8, 2),
                                   torch.zeros(2))
    assert y.grad_fn is None and st.grad_fn is None and dec.grad_fn is None


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
    # the logit cap is in the kernel now: a capped call refuses CPU
    # tensors as the uncapped one does, and a negative cap is refused
    with pytest.raises(ValueError, match="flash_decode.*CUDA"):
        flash_decode(q, k, k, lengths, logit_cap=30.0)
    with pytest.raises(ValueError, match="logit_cap"):
        flash_decode(q, k, k, lengths, logit_cap=-1.0)
    with pytest.raises(ValueError, match="rmsnorm_bwd"):
        rmsnorm_bwd(x, torch.ones(64), x)
    q4 = torch.randn(1, 8, 2, 16)
    with pytest.raises(ValueError, match="flash_attention"):
        flash_attention(q4, q4, q4)
    bc = torch.randn(1, 8, 16)
    with pytest.raises(ValueError, match="ssd_chunk"):
        ssd_chunk(q4, bc, bc, torch.rand(1, 8, 2), torch.zeros(2))


def test_ops_dispatch_non_cpu_tensor_to_the_kernel(monkeypatch):
    """A tensor that is not on the CPU never takes the plain version.  A
    meta tensor (the dry run's) takes the kernels' meta branch: outputs
    of the kernel's shapes on meta, and neither the plain version nor the
    CUDA wrapper (which refuses a meta tensor, below) is called."""
    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached a plain version or a "
                             "CUDA wrapper")
    for name in ("flash_decode_plain", "flash_attention_plain",
                 "rmsnorm_fwd_plain", "rmsnorm_bwd_plain", "ssd_chunk_plain",
                 "_fd_kernel", "_fa_kernel", "_rms_fwd_kernel",
                 "_rms_bwd_kernel", "_ssd_kernel"):
        monkeypatch.setattr(ops, name, refuse)
    x = torch.empty(8, 64, device="meta", requires_grad=True)
    y = ops.rmsnorm(x, torch.empty(64, device="meta"))
    assert y.device.type == "meta" and y.shape == x.shape
    y.sum().backward()
    assert x.grad.device.type == "meta" and x.grad.shape == x.shape
    q = torch.empty(2, 4, 16, device="meta")
    k = torch.empty(2, 8, 2, 16, device="meta")
    out = ops.flash_decode(q, k, k, torch.empty(2, dtype=torch.int32,
                                                device="meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    q4 = torch.empty(1, 8, 2, 16, device="meta")
    assert ops.flash_attention(q4, q4, q4).shape == q4.shape
    bc = torch.empty(1, 8, 16, device="meta")
    y, st, dec = ops.ssd_chunk(q4, bc, bc, torch.empty(1, 8, 2, device="meta"),
                               torch.empty(2, device="meta"))
    assert (y.shape, st.shape, dec.shape) == ((1, 8, 2, 16), (1, 2, 16, 16),
                                              (1, 2))
    monkeypatch.undo()
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    with pytest.raises(ValueError, match="CUDA"):
        rmsnorm_fwd(torch.empty(8, 64, device="meta"),
                    torch.empty(64, device="meta"))


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

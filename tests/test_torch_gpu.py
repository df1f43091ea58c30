"""The CUDA kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: they need an NVIDIA card and ``nvcc``, and skip with a
reason elsewhere.  On a machine with the card:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py imports JAX, and this file needs
none.)
"""
import dataclasses
import warnings

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


@pytest.mark.parametrize("N,D", [
    (1, 896), (8, 896), (13, 960), (2048, 896), (5, 100), (3, 16384),
    # mamba2-1.3b's width and twice it, at the train path's N and at an N
    # the rows path's 8 rows a CTA do not divide; 2048 and 4096 are the
    # rows path's widest rows in f32 and bf16, 2052 and 4104 the next D
    # up (the CTA path)
    *[(N, D) for D in (2048, 4096, 2052, 4104) for N in (8192, 8189)],
])
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
    (64, 256, 16, 4, 64),      # B*KVH alone fills the card: one split
    (2, 300, 16, 1, 128),      # G=16, hd=128
    (8, 1024, 16, 2, 128),     # qwen2.5-3b serve shape (G=8, hd=128)
    (1, 40000, 8, 1, 64),      # splits of three key tiles each
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_kernel_matches_plain(cuda, B, S, H, KVH, hd, dtype):
    """Random lengths, and in front of them S, 1, a split boundary, one
    past it and 0 (no valid key: zeros)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.decode_attention import (decode_split_keys,
                                                      flash_decode,
                                                      flash_decode_plain)
    q = torch.randn(B, H, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=cuda, device="cuda",
                            dtype=torch.int32)
    sk = decode_split_keys(B, KVH, S)
    edges = [S, 1, min(sk, S), min(sk + 1, S), 0][:B]
    lengths[:len(edges)] = torch.tensor(edges, dtype=torch.int32)
    before = _lib.launches["flash_decode"]
    got = flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    assert _lib.launches["flash_decode"] == before + 1
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


@pytest.mark.parametrize("N,D", [
    (1, 960), (8, 896), (33, 960), (8192, 960), (5, 100), (70, 16384),
    # the mamba2-1.3b paths, and N that 32-row CTAs do not divide
    (8192, 2048), (8, 2048), (8191, 960), (8191, 2048),
    # the rows path's wider groups (4 and 8 warps a row, chunks masked)
    # up to its widest row, 8192 in bf16, and the next D up (general path)
    (100, 4096), (100, 4104), (40, 8192), (40, 8200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_bwd_kernel_matches_plain(cuda, N, D, dtype):
    from repro_torch.kernels import _lib
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
    x = torch.randn(N, D, generator=cuda, device="cuda").to(dtype)
    g = torch.randn(N, D, generator=cuda, device="cuda").to(dtype)
    s = torch.randn(D, generator=cuda, device="cuda") + 1.0
    before = _lib.launches["rmsnorm_bwd"]
    dx, part = rmsnorm_bwd(x, s, g, 1e-5)
    torch.cuda.synchronize()
    assert _lib.launches["rmsnorm_bwd"] == before + 1
    want_dx, want_part = rmsnorm_bwd_plain(x, s, g, 1e-5)
    assert part.shape == want_part.shape and part.dtype == torch.float32
    torch.testing.assert_close(dx, want_dx, **TOLS[dtype])
    torch.testing.assert_close(part.sum(0), want_part.sum(0), atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd", [
    (2, 1024, 1024, 15, 5, 64),    # smollm-360m heads (G=3)
    (1, 256, 512, 6, 3, 64),       # GQA, Sk > Sq
    (2, 128, 128, 8, 2, 128),      # hd=128
    (2, 1024, 1024, 16, 2, 128),   # qwen2.5-3b heads (G=8, hd=128)
    (1, 384, 384, 3, 1, 64),       # MQA, odd head count
    (1, 1000, 1000, 6, 3, 64),     # ragged: not a multiple of the tiles
    (2, 37, 101, 4, 2, 32),        # ragged, Sk > Sq, hd=32
    (1, 5, 5, 2, 1, 16),           # shorter than one tile
    (4, 256, 256, 32, 8, 64),      # 512 CTAs: more than two a SM
    *[(1, 77, 133, 4, 2, hd) for hd in range(16, 129, 16)],  # every hd
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, KVH, hd,
                                              causal, dtype):
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q = torch.randn(B, Sq, H, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, Sk, KVH, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, Sk, KVH, hd, generator=cuda, device="cuda").to(dtype)
    before = _lib.launches["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _lib.launches["flash_attention"] == before + 1
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, causal=causal), **TOLS[dtype])


def test_flash_attention_takes_unaligned_bf16_views(cuda):
    """The bf16 kernel copies 16-byte chunks; a view that starts off a
    16-byte boundary is copied first and gives the same output."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    base = torch.randn(2 * 64 * 4 * 32 + 1, generator=cuda,
                       device="cuda").to(torch.bfloat16)
    q = base[1:].view(2, 64, 4, 32)              # 2 bytes past the start
    assert q.data_ptr() % 16 != 0
    k = torch.randn(2, 64, 2, 32, generator=cuda,
                    device="cuda").to(torch.bfloat16)
    got = flash_attention(q, k, k, causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, flash_attention_plain(q, k, k),
                               **TOLS[torch.bfloat16])


@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd", [
    (2, 1024, 1024, 48, 8, 128),   # grok-1 heads (G=6, hd=128)
    (1, 77, 133, 4, 2, 64),        # ragged, Sk > Sq
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capped_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, KVH,
                                                     hd, causal, dtype):
    """grok-1's logit cap of 30 on scores scaled up so that it bites;
    cap 0 gives the uncapped kernel's bits."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q = (4 * torch.randn(B, Sq, H, hd, generator=cuda, device="cuda")).to(dtype)
    k = (4 * torch.randn(B, Sk, KVH, hd, generator=cuda,
                         device="cuda")).to(dtype)
    v = torch.randn(B, Sk, KVH, hd, generator=cuda, device="cuda").to(dtype)
    got = flash_attention(q, k, v, causal=causal, logit_cap=30.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, causal=causal, logit_cap=30.0),
        **TOLS[dtype])
    assert torch.equal(flash_attention(q, k, v, causal=causal, logit_cap=0.0),
                       flash_attention(q, k, v, causal=causal))


@pytest.mark.parametrize("B,S,H,KVH,hd", [
    (8, 1024, 48, 8, 128),     # grok-1 serve shape (G=6, hd=128)
    (3, 37, 15, 5, 64),        # odd S
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_capped_flash_decode_kernel_matches_plain(cuda, B, S, H, KVH, hd,
                                                  dtype):
    from repro_torch.kernels.decode_attention import (flash_decode,
                                                      flash_decode_plain)
    q = (4 * torch.randn(B, H, hd, generator=cuda, device="cuda")).to(dtype)
    k = (4 * torch.randn(B, S, KVH, hd, generator=cuda,
                         device="cuda")).to(dtype)
    v = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    lengths = torch.randint(1, S + 1, (B,), generator=cuda, device="cuda",
                            dtype=torch.int32)
    got = flash_decode(q, k, v, lengths, logit_cap=30.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_decode_plain(q, k, v, lengths, logit_cap=30.0),
        **TOLS[dtype])
    assert torch.equal(flash_decode(q, k, v, lengths, logit_cap=0.0),
                       flash_decode(q, k, v, lengths))


def test_moe_layer_on_the_card_expert_parallel_equals_moe_apply(cuda):
    """granite's MoE layer at reduced widths on the card, bf16: the
    expert-parallel path on 4 ranks (user all-to-all and native) equals
    moe_apply bit for bit."""
    from repro_torch.collectives.nonblocking import UserCollectives
    from repro_torch.configs import get_config
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    cfg = get_config("granite-moe-3b-a800m").with_overrides(d_model=256)
    p = layers.init_tree(layers.moe_spec(cfg), cuda)
    x = torch.randn(8, 256, 256, generator=cuda, device="cuda").to(
        torch.bfloat16)                        # 4 groups of 512 tokens
    mesh = make_mesh((4,), ("model",), "cuda")
    coll = UserCollectives(ProgressEngine())
    try:
        y, aux = layers.moe_apply(p, x, cfg)
        yn, auxn = layers.moe_apply_expert_parallel(p, x, cfg, mesh)
        yu, auxu = layers.moe_apply_expert_parallel(p, x, cfg, mesh,
                                                    coll=coll)
        torch.cuda.synchronize()
    finally:
        coll.close()
    assert torch.equal(y, yn) and torch.equal(yn, yu)
    assert torch.equal(aux, auxn) and torch.equal(auxn, auxu)


def test_training_ops_gradients_on_the_card(cuda):
    """ops.rmsnorm and ops.flash_attention backward on the card (kernels)
    against the CPU (plain versions), in f32."""
    from repro_torch.kernels import _lib, ops
    x = torch.randn(2, 64, 96, generator=cuda, device="cuda")
    s = torch.randn(96, generator=cuda, device="cuda") + 1.0
    q = torch.randn(2, 100, 6, 32, generator=cuda, device="cuda")
    k = torch.randn(2, 100, 2, 32, generator=cuda, device="cuda")
    v = torch.randn(2, 100, 2, 32, generator=cuda, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (x, s, q, k, v)]
        xl, sl, ql, kl, vl = leaves
        y = ops.rmsnorm(xl, sl, 1e-5)
        o = ops.flash_attention(ql, kl, vl, causal=True)
        ((y ** 2).sum() + (o ** 3).sum()).backward()
        grads[dev] = [t.grad.cpu() for t in leaves]
    assert _lib.launches["rmsnorm_bwd"] > 0
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def test_rmsnorm_bwd_kernel_takes_an_unaligned_scale(cuda):
    """A scale that starts off a 16-byte boundary sends a D the rows path
    would take to the general path's scalar loads."""
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd, rmsnorm_bwd_plain
    x = torch.randn(64, 960, generator=cuda, device="cuda")
    g = torch.randn(64, 960, generator=cuda, device="cuda")
    s = (torch.randn(961, generator=cuda, device="cuda") + 1.0)[1:]
    assert s.data_ptr() % 16 != 0
    dx, part = rmsnorm_bwd(x, s, g, 1e-5)
    want_dx, want_part = rmsnorm_bwd_plain(x, s, g, 1e-5)
    torch.testing.assert_close(dx, want_dx, **TOLS[torch.float32])
    torch.testing.assert_close(part.sum(0), want_part.sum(0), atol=1e-3,
                               rtol=1e-3)


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm_bwd
    x = torch.randn(8, 64, device="cuda")
    with pytest.raises(ValueError, match="g must be"):
        rmsnorm_bwd(x, torch.ones(64, device="cuda"), x.bfloat16())
    q = torch.randn(1, 8, 2, 24, device="cuda")
    with pytest.raises(ValueError, match="hd=24"):
        flash_attention(q, q, q)
    q = torch.randn(1, 8, 2, 64, device="cuda")
    k = torch.randn(1, 4, 2, 64, device="cuda")
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, k, k, causal=True)


def test_attention_kernels_do_not_synchronise(cuda):
    """Neither wrapper waits for the card: lengths stay on it, scratch is
    torch.empty, and nothing is read back."""
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(8, 14, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.randn(8, 1024, 2, 64, device="cuda", dtype=torch.bfloat16)
    lengths = torch.randint(1, 1025, (8,), device="cuda", dtype=torch.int32)
    qa = torch.randn(2, 256, 6, 64, device="cuda", dtype=torch.bfloat16)
    ka = torch.randn(2, 256, 2, 64, device="cuda", dtype=torch.bfloat16)
    flash_decode(q, kv, kv, lengths)          # builds and loads the library
    flash_attention(qa, ka, ka)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flash_decode(q, kv, kv, lengths)
        flash_attention(qa, ka, ka)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _ssd_inputs(gen, B, Q, nh, hp, ds, dtype, dt_dtype):
    """tests/test_kernels.py:149-154's distributions, on the card."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")
    x, b, c = randn(B, Q, nh, hp), randn(B, Q, ds), randn(B, Q, ds)
    dt = torch.nn.functional.softplus(randn(B, Q, nh)) * 0.1
    a_log = torch.rand(nh, generator=gen, device="cuda") * 2.0
    return (x.to(dtype), b.to(dtype), c.to(dtype), dt.to(dt_dtype), a_log)


@pytest.mark.parametrize("B,Q,nh,hp,ds", [
    (32, 256, 64, 64, 128),    # mamba2-1.3b training: B*nc = 8*1024/256
    (1, 64, 8, 32, 32),        # tests/test_kernels.py:136-139
    (2, 128, 16, 64, 64),
    (1, 256, 8, 64, 128),
    (2, 1000, 8, 64, 128),     # ragged one-chunk sequence: Q = S
    (3, 37, 5, 16, 16),        # shorter than one tile, odd head count
    (1, 300, 2, 128, 256),     # the largest hp and ds, three prefix levels
])
@pytest.mark.parametrize("dtype,dt_f32", [(torch.float32, True),
                                          (torch.bfloat16, False),
                                          (torch.bfloat16, True)])
def test_ssd_chunk_kernel_matches_plain(cuda, B, Q, nh, hp, ds, dtype,
                                        dt_f32):
    """dt in x's dtype (as tests/test_kernels.py feeds it) and in f32 (as
    the model feeds it); the limits of tests/test_kernels.py:155-162."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
    args = _ssd_inputs(cuda, B, Q, nh, hp, ds, dtype,
                       torch.float32 if dt_f32 else dtype)
    before = _lib.launches["ssd_chunk"]
    y, st, dec = ssd_chunk(*args)
    torch.cuda.synchronize()
    assert _lib.launches["ssd_chunk"] == before + 1
    wy, wst, wdec = ssd_chunk_plain(*args)
    assert y.dtype == dtype and st.dtype == dec.dtype == torch.float32
    torch.testing.assert_close(y, wy, **TOLS[dtype])
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(st, wst, atol=tol, rtol=tol)
    torch.testing.assert_close(dec, wdec, atol=1e-5, rtol=1e-5)


def test_ssd_chunk_op_backward_on_the_card(cuda):
    """ops.ssd_chunk forward (kernel) and backward (through the oracle) on
    the card against the CPU (plain version), in f32, over two chunks'
    worth of rows."""
    from repro_torch.kernels import ops
    args = _ssd_inputs(cuda, 2, 100, 4, 32, 32, torch.float32, torch.float32)
    cot = [torch.randn(s, generator=cuda, device="cuda")
           for s in ((2, 100, 4, 32), (2, 4, 32, 32), (2, 4))]
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in args]
        outs = ops.ssd_chunk(*leaves)
        grads[dev] = [g.cpu() for g in torch.autograd.grad(
            outs, leaves, [c.to(dev) for c in cot])]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)


def test_ssd_chunk_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.ssd_scan import ssd_chunk
    x, b, c, dt, a_log = _ssd_inputs(cuda, 1, 8, 2, 16, 16, torch.float32,
                                     torch.float32)
    with pytest.raises(ValueError, match="hp=24"):
        ssd_chunk(torch.zeros(1, 8, 2, 24, device="cuda"), b, c, dt, a_log)
    with pytest.raises(ValueError, match="dt dtype"):
        ssd_chunk(x, b, c, dt.half(), a_log)
    with pytest.raises(ValueError, match="a_log dtype"):
        ssd_chunk(x, b, c, dt, a_log.double())


# ---------------------------------------------------------------------------
# the user-space collectives on the card
# ---------------------------------------------------------------------------

def _collective(coll, op, alg, x, mesh, chunks, batch, persistent):
    import warnings
    kw = dict(chunks=chunks, round_batch=batch)
    if op != "alltoall":
        kw["algorithm"] = alg
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")           # n = 3: ring fallbacks
        if persistent:
            h = getattr(coll, op + "_init")(x, mesh, "x", **kw)
            out = h.start(x).wait(timeout=120)
            h.close()
            return out
        return getattr(coll, "i" + op)(x, mesh, "x", **kw).wait(timeout=120)


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_collectives_on_the_card_equal_their_cpu_run(cuda, n):
    """Every op × algorithm, chunks 1 and 4, round batch 1 and auto,
    one-shot and persistent: the card's result equals the CPU run's bit
    for bit, in int32, f32 and bf16."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    coll = NB.UserCollectives(ProgressEngine())
    host = NB.UserCollectives(ProgressEngine())
    mesh, cmesh = make_mesh((n,), ("x",), "cuda"), make_mesh((n,), ("x",),
                                                             "cpu")
    cases = [("allreduce", a, (n * 2, 3, 100)) for a in NB.S.ALGORITHMS]
    cases += [(op, a, shape) for op, shape in
              (("reduce_scatter", (n * 2, 2, n * 16)),
               ("allgather", (n * 2, 2, 24)))
              for a in ("ring", "halving_doubling")]
    cases.append(("alltoall", "bruck", (n * n, 24)))
    gen = torch.Generator().manual_seed(n)
    for op, alg, shape in cases:
        for dt in (torch.int32, torch.float32, torch.bfloat16):
            xc = torch.randint(-8, 8, shape, generator=gen, dtype=dt) \
                if dt == torch.int32 else torch.randn(shape,
                                                      generator=gen).to(dt)
            for chunks in (1, 4):
                for batch in (1, None):
                    for persistent in (False, True):
                        got = _collective(coll, op, alg, xc.cuda(), mesh,
                                          chunks, batch, persistent)
                        want = _collective(host, op, alg, xc, cmesh, chunks,
                                           batch, persistent)
                        assert got.is_cuda and torch.equal(got.cpu(), want), \
                            (op, alg, dt, chunks, batch, persistent)
    coll.close()
    host.close()
    assert coll.failed == 0


def test_persistent_restart_allocates_nothing_on_the_card(cuda):
    """A persistent allreduce owns its carries: after its first start,
    restarts leave ``torch.cuda.memory_allocated`` where it was (the
    result of the last start held)."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    coll = NB.UserCollectives(ProgressEngine())
    mesh = make_mesh((4,), ("x",), "cuda")
    x = torch.randint(-8, 8, (8, 1 << 16), device="cuda", dtype=torch.int32)
    want = x.unflatten(0, (4, 2)).sum(0, dtype=torch.int32).repeat(4, 1)
    h = coll.allreduce_init(x, mesh, "x", chunks=4, round_batch=1)
    mem = []
    for _ in range(10):
        out = h.start(x).wait(timeout=60)
        mem.append(torch.cuda.memory_allocated())
        assert torch.equal(out, want)
    assert len(set(mem)) == 1, mem
    coll.close()


# ---------------------------------------------------------------------------
# parallel training on the card: FSDP handles, 1F1B streams, the watchdog
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_reducer_on_the_card_equals_its_cpu_run(cuda, n):
    """The ``FsdpReducer``'s persistent reduce-scatter and the chained
    all-gather off a compute future on card payloads: int32 bit for bit
    against the plain sum, f32 bit for bit against the same schedule on
    the CPU."""
    from repro_torch.collectives import CollectiveSpec, FsdpReducer
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    spec = CollectiveSpec(backend="user", chunks=4)
    reds = {dev: FsdpReducer(make_mesh((n, 1), ("data", "model"), dev),
                             "data", engine=ProgressEngine(), spec=spec)
            for dev in ("cuda", "cpu")}
    gen = torch.Generator().manual_seed(n)
    gi = torch.randint(-100, 100, (n, 64 * n), generator=gen,
                       dtype=torch.int32)
    gf = torch.randn((n, 64 * n), generator=gen)
    out = {dev: r.ireduce_scatter([gi.to(dev), gf.to(dev)]).wait(timeout=60)
           for dev, r in reds.items()}
    assert torch.equal(out["cuda"][0].cpu(), gi.sum(0).view(n, -1))
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
    for dev, r in reds.items():
        shards = [t.clone() for t in out[dev]]
        full = r.igather(shards, after=[r.future(s) for s in shards]) \
            .wait(timeout=60)
        assert torch.equal(full[0].cpu(),
                           shards[0].reshape(1, -1).expand(n, -1).cpu())
        out[dev] = full
        r.close()
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])


def test_1f1b_on_stage_streams_equals_sequential(cuda):
    """1F1B at S = 4, M = 8 on four stage CUDA streams: loss and
    gradients bit for bit against the same cells run one microbatch at a
    time on the default stream; the forward equal to ``gpipe``'s."""
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.distributed import pipeline as pl
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_mesh
    S, M, mb = 4, 8, 4
    g = torch.Generator(device="cuda").manual_seed(0)
    params = {"w1": torch.randn((S, 16, 32), generator=g, device="cuda"),
              "w2": torch.randn((S, 32, 16), generator=g, device="cuda")}
    xs = torch.randn((M, mb, 16), generator=g, device="cuda")
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    mesh = make_mesh((S,), ("stage",), "cuda")
    sched = pl.PipelineSchedule(launch.pipe_stage_fn, mesh, "stage", S,
                                loss_fn=launch.pipe_loss_fn, engine=eng,
                                executor=ex)
    loss, grads = sched.step(params, xs, xs, timeout=120)
    ys = sched.apply(params, xs, timeout=120)
    stage = [{k: v[s] for k, v in params.items()} for s in range(S)]
    acc = [[torch.zeros_like(stage[s][k]) for k in ("w1", "w2")]
           for s in range(S)]
    scale = torch.tensor(1.0 / M, device="cuda")
    total = None
    for m in range(M):
        x, stash = xs[m], []
        for s in range(S - 1):
            stash.append(x)
            x = sched._fwd(stage[s], x)
        lm, dx, acc[S - 1] = sched._last_bwd(stage[S - 1], x, xs[m], scale,
                                             acc[S - 1])
        total = lm if total is None else total + lm
        for s in range(S - 2, -1, -1):
            dx, acc[s] = sched._bwd(stage[s], stash[s], dx, acc[s])
    assert torch.equal(loss, total * scale)
    for i, k in enumerate(("w1", "w2")):
        assert torch.equal(grads[k], torch.stack([a[i] for a in acc]))
    assert torch.equal(ys, pl.gpipe(launch.pipe_stage_fn, mesh, "stage",
                                    S)(params, xs))
    assert len({id(c) for c in sched.cuda_streams}) == S
    sched.close()
    ex.shutdown(drain=True, timeout=60)


def test_fsdp_launcher_on_the_card_matches_native(cuda, tmp_path):
    """``launch.train --devices 4 --fsdp`` at the tiny scale on the card:
    the user backend's losses within 1e-3 of the native backend's."""
    from repro_torch.launch import train as launch
    losses = {}
    for backend in ("native", "user"):
        args = launch.build_parser().parse_args([
            "--device", "cuda", "--scale", "tiny", "--steps", "4",
            "--global-batch", "8", "--seq", "32", "--devices", "4", "--fsdp",
            "--collective-backend", backend,
            "--ckpt-dir", str(tmp_path / backend)])
        losses[backend] = [m["loss"] for m in
                           launch.run(args, log_every=1).log]
    assert len(losses["user"]) == 4
    assert max(abs(a - b) for a, b in zip(losses["user"],
                                           losses["native"])) < 1e-3


def _serve_tokens_on_the_card(backend, n, workers=0, epoch=None, kill=None):
    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    from repro_torch.serve.engine import GenRequest, ServeEngine
    import numpy as np
    cfg = make_config("qwen2-0.5b", "tiny")
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, workers).start() if workers else None
    srv = ServeEngine(cfg, params, eng, batch_slots=4, max_seq=64,
                      executor=ex, epoch=epoch,
                      mesh=make_mesh((n,), ("model",), "cuda"),
                      collective_spec=CollectiveSpec(backend=backend,
                                                     chunks=2))
    rs = np.random.RandomState(0)
    reqs = [GenRequest(f"r{i}", rs.randint(1, 500, size=rs.randint(2, 12))
                       .astype(np.int32), max_new_tokens=6)
            for i in range(6)]
    for r in reqs:
        srv.submit(r)
    if kill is not None:
        while sum(len(r.out_tokens) for r in reqs) < 5:
            eng.progress()
        epoch.invalidate(survivors=kill, reason="chaos")
    srv.run_until_idle(timeout=120)
    lat = srv.latency_snapshot()
    starts = srv._ag_handle.starts if srv._ag_handle is not None else None
    out = [list(r.out_tokens) for r in reqs], starts, srv.steps, srv.remeshes
    srv.close(timeout=60)
    if ex is not None:
        ex.shutdown(drain=True, timeout=60)
    assert lat.completed == 6 and lat.failed == 0
    return out


def test_sharded_serve_on_the_card_user_equals_native(cuda):
    """Vocab-sharded serving on 4 model ranks of the card at the tiny
    scale: the user backend's persistent all-gather (caller-driven and
    executor-driven) serves the native gather's streams bit for bit, one
    start a step; an epoch invalidated mid-decode remeshes once onto 2
    ranks and serves the same streams."""
    from repro_torch.collectives.nonblocking import MembershipEpoch
    native, none, _, _ = _serve_tokens_on_the_card("native", 4)
    user, starts, steps, _ = _serve_tokens_on_the_card("user", 4)
    driven, _, _, _ = _serve_tokens_on_the_card("user", 4, workers=2)
    assert none is None and user == native == driven
    assert starts == steps > 0
    chaos, _, _, remeshes = _serve_tokens_on_the_card(
        "user", 4, epoch=MembershipEpoch(4), kill=2)
    assert remeshes == 1 and chaos == native


def test_lane_round_trip_on_the_card(cuda):
    """A decoding lane checkpointed off the card after 10 tokens and
    restored into a fresh pool with a shifted block layout decodes on bit
    for bit as the uninterrupted lane."""
    import numpy as np
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    from repro_torch.serve.kvcache import PagedKVCache, to_device
    cfg = make_config("qwen2-0.5b", "tiny")
    params = registry.cast_params(cfg, registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0)))
    rs = np.random.RandomState(1)
    toks = [np.full((2, 1), rs.randint(1, 500), np.int32) for _ in range(14)]

    def feed(pool, lane, start, count):
        fed = np.array([i == lane for i in range(2)])
        for t in range(start, start + count):
            assert pool.ensure(lane, t)
            out, pool.cache = registry.decode_step_paged(
                params, cfg, pool.cache, to_device(toks[t], pool.device),
                to_device(np.full((2,), t, np.int32), pool.device),
                pool.block_tables(), to_device(fed, pool.device))
            pool.slots[lane].pos = t + 1
        return out[lane]

    # the lane keeps its index (row 1 of the batch); its blocks move
    pool = PagedKVCache(cfg, 2, 64, block_size=4, device="cuda")
    pool.assign("pad", seq_len=1)
    lane = pool.assign("req", seq_len=1).index
    feed(pool, lane, 0, 10)
    ckpt = pool.checkpoint_lane(lane)
    pool2 = PagedKVCache(cfg, 2, 64, block_size=4, device="cuda")
    pool2.assign("other", seq_len=9)
    assert pool2.assign("req", seq_len=11).index == lane
    pool2.restore_lane(pool2.cache, lane, ckpt)
    assert not torch.equal(pool2.block_tables()[lane, :3],
                           pool.block_tables()[lane, :3])
    assert torch.equal(feed(pool2, lane, 10, 4), feed(pool, lane, 10, 4))


# ---------------------------------------------------------------------------
# the last three families' shapes: G = 1, non-causal Sq != Sk with
# Sk = 1500, flash_decode over 1500 keys, ssd_chunk with d_state 64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Sq,Sk,H,KVH,hd,causal", [
    (2, 1024, 1024, 32, 32, 64, True),   # zamba2's shared site (G = 1)
    (2, 1500, 1500, 6, 6, 64, False),    # whisper's encoder
    (2, 1024, 1500, 6, 6, 64, False),    # whisper's cross-attention
    (2, 37, 1500, 6, 6, 64, False),      # a ragged query block against it
    (1, 1024, 1024, 6, 6, 64, True),     # whisper's decoder self-attention
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_the_families_shapes(cuda, B, Sq, Sk, H, KVH, hd,
                                                causal, dtype):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q = torch.randn(B, Sq, H, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, Sk, KVH, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, Sk, KVH, hd, generator=cuda, device="cuda").to(dtype)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got, flash_attention_plain(q, k, v, causal=causal), **TOLS[dtype])


@pytest.mark.parametrize("B,S,H,KVH,hd,full", [
    (8, 1024, 32, 32, 64, False),        # zamba2's sites (G = 1)
    (8, 1500, 6, 6, 64, True),           # whisper's cross K/V, every frame
    (8, 1500, 6, 6, 64, False),
    (8, 448, 6, 6, 64, False),           # whisper's self K/V
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_families_shapes(cuda, B, S, H, KVH, hd, full,
                                             dtype):
    from repro_torch.kernels.decode_attention import (flash_decode,
                                                      flash_decode_plain)
    q = torch.randn(B, H, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    lengths = (torch.full((B,), S, dtype=torch.int32, device="cuda") if full
               else torch.randint(1, S + 1, (B,), generator=cuda,
                                  device="cuda", dtype=torch.int32))
    got = flash_decode(q, k, v, lengths)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, flash_decode_plain(q, k, v, lengths),
                               **TOLS[dtype])


@pytest.mark.parametrize("dtype,dt_f32", [(torch.float32, True),
                                          (torch.bfloat16, True)])
def test_ssd_chunk_at_zamba2s_train_shape(cuda, dtype, dt_f32):
    """x [32, 256, 64, 64], b/c [32, 256, 64]: mamba2's shape with
    zamba2's d_state of 64."""
    from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_plain
    args = _ssd_inputs(cuda, 32, 256, 64, 64, 64, dtype,
                       torch.float32 if dt_f32 else dtype)
    y, st, dec = ssd_chunk(*args)
    torch.cuda.synchronize()
    wy, wst, wdec = ssd_chunk_plain(*args)
    torch.testing.assert_close(y, wy, **TOLS[dtype])
    tol = 3e-2 if dtype == torch.bfloat16 else 3e-5
    torch.testing.assert_close(st, wst, atol=tol, rtol=tol)
    torch.testing.assert_close(dec, wdec, atol=1e-5, rtol=1e-5)


def test_zamba2_decode_step_on_the_card_matches_the_cpu(cuda):
    """One f32 paged decode step of zamba2 at full width, one group of 2
    layers and a tail of 1, LoRA b nonzero: the card's kernels against
    the CPU's plain versions, logits within 1e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.models.layers import tree_map
    cfg = get_config("zamba2-1.2b").with_overrides(
        num_layers=3, shared_attn_every=2, dtype="float32")
    params = registry.init_params(cfg, cuda)
    for key, leaf in params["site_lora"].items():
        if key.endswith("_b"):
            leaf.normal_(0.0, 0.02, generator=cuda)
    cpu = tree_map(lambda t: t.cpu(), params)
    B, nb, bs = 4, 4, 16
    tables = (1 + torch.arange(B * nb, dtype=torch.int32)).reshape(B, nb)
    toks = torch.randint(0, cfg.vocab_size, (B, 1), dtype=torch.int32)
    pos = torch.tensor([0, 5, 17, 40], dtype=torch.int32)
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu)):
        pool = registry.init_paged_cache(cfg, B, 1 + B * nb, bs, dev)
        with torch.no_grad():
            out[dev], _ = registry.decode_step_paged(
                p, cfg, pool, toks.to(dev), pos.to(dev), tables.to(dev))
    torch.testing.assert_close(out["cuda"].cpu(), out["cpu"], atol=1e-3,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# the assigned shapes' kernels: decode_32k at batch 128, long_500k's
# 524288 keys at G = 1 (9 splits of 58304 keys), prefill_32k's attention
# ---------------------------------------------------------------------------

# An output element there averages v over 32768 or 524288 keys, so its
# rms is ~sqrt(e / keys) (~0.009, ~0.002): below the bf16 atol of TOLS,
# which zeros would pass.  A bf16 output is held to SCALED_ATOL times its
# own sequence's rms (and the rtol of TOLS); zeros and the output over
# half the keys (a combine or key loop that dropped half of its splits or
# tiles) must fail that limit.
SCALED_ATOL = 0.1


def _off_scaled_limit(got, want, dtype):
    """Where ``got`` is off ``want`` beyond the limit of its dtype at the
    assigned shapes."""
    w = want.float()
    if dtype == torch.bfloat16:
        dims = tuple(range(1, w.dim()))
        atol = SCALED_ATOL * w.pow(2).mean(dim=dims, keepdim=True).sqrt()
    else:
        atol = TOLS[dtype]["atol"]
    return (got.float() - w).abs() > atol + TOLS[dtype]["rtol"] * w.abs()


def _assert_close_at_scale(got, want, dtype, wrong=()):
    off = _off_scaled_limit(got, want, dtype)
    assert torch.isfinite(got.float()).all()
    assert not off.any(), (
        f"{int(off.sum())} of {off.numel()} elements off; max abs err "
        f"{float((got.float() - want.float()).abs().max()):.3e}")
    for out in wrong:
        assert _off_scaled_limit(out, want, dtype).any()


@pytest.mark.parametrize("B,S,H,KVH,hd", [
    (128, 32768, 14, 2, 64),             # qwen2-0.5b decode_32k
    (1, 524288, 32, 32, 64),             # zamba2-1.2b long_500k
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_at_the_assigned_shapes(cuda, B, S, H, KVH, hd, dtype):
    """Every lane at its cache's last position (the cells' decode), then
    random lengths: the split combine over many keys a split."""
    from repro_torch.kernels.decode_attention import (decode_split_keys,
                                                      decode_splits,
                                                      flash_decode,
                                                      flash_decode_plain)
    q = torch.randn(B, H, hd, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(B, S, KVH, hd, generator=cuda, device="cuda").to(dtype)
    splits = decode_splits(B, KVH, S)
    if B * KVH < 132:
        assert splits > 1
    # the first half of the splits (half the keys where there is one)
    kept = (splits // 2) * decode_split_keys(B, KVH, S) if splits > 1 \
        else S // 2
    full = torch.full((B,), S, dtype=torch.int32, device="cuda")
    for lengths in (full, torch.randint(1, S + 1, (B,), generator=cuda,
                                        device="cuda", dtype=torch.int32)):
        got = flash_decode(q, k, v, lengths)
        torch.cuda.synchronize()
        want = flash_decode_plain(q, k, v, lengths)
        wrong = (torch.zeros_like(want),
                 flash_decode_plain(q, k, v, lengths.clamp(max=kept))) \
            if lengths is full else ()
        _assert_close_at_scale(got, want, dtype, wrong)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_32768_queries_on_its_last_rows(cuda, dtype):
    """qwen2-0.5b prefill_32k's attention, q [1, 32768, 14, 64] against
    k/v [1, 32768, 2, 64], causal: the plain version's 60 GB of scores do
    not fit, and under the bottom-right mask the kernel's last 1024 query
    rows are the plain version on q[:, -1024:] against every key."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    S, tail = 32768, 1024
    q = torch.randn(1, S, 14, 64, generator=cuda, device="cuda").to(dtype)
    k = torch.randn(1, S, 2, 64, generator=cuda, device="cuda").to(dtype)
    v = torch.randn(1, S, 2, 64, generator=cuda, device="cuda").to(dtype)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    want = flash_attention_plain(q[:, -tail:].contiguous(), k, v,
                                 causal=True)
    # zeros, and the rows over the first half of the keys
    half = flash_attention_plain(q[:, -tail:].contiguous(),
                                 k[:, :S // 2].contiguous(),
                                 v[:, :S // 2].contiguous(), causal=True)
    _assert_close_at_scale(got[:, -tail:], want, dtype,
                           (torch.zeros_like(want), half))
    # the first rows against the plain version on the keys they can see
    torch.testing.assert_close(
        got[:, :tail], flash_attention_plain(q[:, :tail].contiguous(),
                                             k[:, :tail].contiguous(),
                                             v[:, :tail].contiguous(),
                                             causal=True), **TOLS[dtype])


# ---------------------------------------------------------------------------
# a mesh with one device per rank: collectives as copies between devices
# ---------------------------------------------------------------------------

def _rank_devices(n: int, distinct: bool) -> list:
    """n devices: distinct cards (skips, with the reason, when the machine
    has fewer), or ``cuda:0`` listed n times."""
    if not distinct:
        return ["cuda:0"] * n
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, this machine has "
                    f"{torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(n)]


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
@pytest.mark.parametrize("n", [2, 4])
def test_per_device_collectives_equal_the_stacked_form(cuda, n, distinct):
    """Every op × algorithm, chunks 1 and 4, round batch 1 and auto,
    one-shot and persistent, int32, f32 and bf16: the per-device form's
    result equals the rank-stacked run on ``cuda:0`` bit for bit, each
    shard on its rank's device."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    devices = _rank_devices(n, distinct)
    coll = NB.UserCollectives(ProgressEngine())
    smesh = make_mesh((n,), ("x",), "cuda:0")
    dmesh = make_mesh((n,), ("x",), devices=devices)
    cases = [("allreduce", a, (n * 2, 3, 100)) for a in NB.S.ALGORITHMS]
    cases += [(op, a, shape) for op, shape in
              (("reduce_scatter", (n * 2, 2, n * 16)),
               ("allgather", (n * 2, 2, 24)))
              for a in ("ring", "halving_doubling")]
    cases.append(("alltoall", "bruck", (n * n, 24)))
    gen = torch.Generator().manual_seed(10 + n)
    for op, alg, shape in cases:
        for dt in (torch.int32, torch.float32, torch.bfloat16):
            xc = torch.randint(-8, 8, shape, generator=gen, dtype=dt) \
                if dt == torch.int32 else torch.randn(shape,
                                                      generator=gen).to(dt)
            x = xc.to("cuda:0")
            xs = RankShards.from_stacked(x, dmesh)
            for chunks in (1, 4):
                for batch in (1, None):
                    for persistent in (False, True):
                        want = _collective(coll, op, alg, x, smesh, chunks,
                                           batch, persistent)
                        got = _collective(coll, op, alg, xs, dmesh, chunks,
                                          batch, persistent)
                        assert isinstance(got, RankShards)
                        assert [str(d) for d in got.devices] == devices
                        assert torch.equal(got.to_stacked("cuda:0"), want), \
                            (op, alg, dt, chunks, batch, persistent)
    coll.close()
    assert coll.failed == 0


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
def test_per_device_restart_allocates_nothing_on_any_device(cuda,
                                                            distinct):
    """A persistent per-device allreduce restarted 10 times: after its
    first start, ``memory_allocated`` of every device stays put."""
    from repro_torch.collectives import nonblocking as NB
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    devices = _rank_devices(4, distinct)
    mesh = make_mesh((4,), ("x",), devices=devices)
    coll = NB.UserCollectives(ProgressEngine())
    x = torch.randint(-8, 8, (8, 1 << 16), device="cuda:0",
                      dtype=torch.int32)
    want = x.unflatten(0, (4, 2)).sum(0, dtype=torch.int32)
    xs = RankShards.from_stacked(x, mesh)
    h = coll.allreduce_init(xs, mesh, "x", chunks=4, round_batch=1)
    cards = sorted({torch.device(d) for d in devices}, key=str)
    mem = []
    for _ in range(10):
        out = h.start(xs).wait(timeout=60)
        mem.append(tuple(torch.cuda.memory_allocated(d) for d in cards))
        # (no loop variable: it would keep the last shard of this result
        # alive through the next start)
        assert all(torch.equal(s.to("cuda:0"), want) for s in out.shards)
    assert len(set(mem)) == 1, mem
    coll.close()


def test_torch_future_polls_an_event_on_each_device(cuda):
    """``torch_future`` over a tree on two cards records one event on each
    card's current stream and completes only when both have; the poll
    never synchronizes."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.core.futures import cuda_devices, torch_future
    devices = _rank_devices(2, True)
    a = torch.randn(4096, 4096, device=devices[0])
    b = torch.randn(4096, 4096, device=devices[1])
    for _ in range(20):                  # keep both cards busy a while
        a = a @ a / 64
        with torch.cuda.device(devices[1]):
            b = b @ b / 64
    tree = {"x": RankShards([a[:1], b[:1]])}
    assert [str(d) for d in cuda_devices(tree)] == devices
    eng = ProgressEngine()
    req = torch_future(eng, tree)
    assert eng.wait(req, timeout=60) is tree


# ---------------------------------------------------------------------------
# FSDP and sharded serving with a device per rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
def test_per_device_fsdp_reducer_equals_its_cpu_run(cuda, distinct):
    """The ``FsdpReducer``'s persistent reduce-scatter and chained
    all-gather of ``RankShards`` on 4 ranks' cards (two buckets, int32 and
    f32, each started twice) against the same on ``["cpu"] * 4``, bit
    for bit, each result shard on its rank's device."""
    from repro_torch.collectives import CollectiveSpec, FsdpReducer
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    devices = _rank_devices(4, distinct)
    gen = torch.Generator().manual_seed(26)
    grads = [torch.randint(-99, 99, (4, 64), generator=gen,
                           dtype=torch.int32),
             torch.randn(4, 4096, generator=gen)]
    shards = [torch.randint(-99, 99, (4, 16), generator=gen,
                            dtype=torch.int32),
              torch.randn(4, 1024, generator=gen)]
    out = {}
    for name, devs in (("cpu", ["cpu"] * 4), ("cuda", devices)):
        mesh = make_mesh((4, 1), ("data", "model"), devices=devs)
        red = FsdpReducer(mesh, "data", engine=ProgressEngine(),
                          spec=CollectiveSpec(backend="user", chunks=2))
        runs = []
        for _ in range(2):
            rs = red.ireduce_scatter([RankShards.from_stacked(g, mesh)
                                      for g in grads]).wait(timeout=60)
            ag = red.igather([RankShards.from_stacked(s, mesh)
                              for s in shards],
                             after=[red.future(RankShards.from_stacked(
                                 s, mesh)) for s in shards]).wait(timeout=60)
            for x in rs + ag:
                assert [str(d) for d in x.devices] == [str(torch.device(d))
                                                       for d in devs]
            runs.append([x.to_stacked("cpu") for x in rs + ag])
        red.close()
        out[name] = runs
    for a, b in zip(out["cpu"], out["cuda"]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _tiny_serve(arch: str = "qwen2-0.5b"):
    from repro_torch.launch.serve import make_config
    from repro_torch.models import registry
    cfg = make_config(arch, "tiny").with_overrides(dtype="float32")
    params = registry.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    return cfg, params


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
@pytest.mark.parametrize("n", [2, 4])
def test_per_device_sharded_serving_user_native_stacked(cuda, n, distinct):
    """f32 tiny qwen2-0.5b on n model ranks with a card a rank (or
    ``cuda:0`` repeated): the user and native gathers serve the same
    streams, bit for bit, and those of the rank-stacked engine on
    ``cuda:0``; one gather start a step."""
    import numpy as np

    from repro_torch.collectives.nonblocking import CollectiveSpec
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import GenRequest, ServeEngine
    devices = _rank_devices(n, distinct)
    cfg, params = _tiny_serve()
    rs = np.random.RandomState(0)
    ps = [rs.randint(1, cfg.vocab_size - 1, size=rs.randint(2, 12))
          .astype(np.int32) for _ in range(6)]
    runs = {}
    for name, backend, mesh in (
            ("stacked", "user", make_mesh((n,), ("model",), "cuda:0")),
            ("user", "user", make_mesh((n,), ("model",), devices=devices)),
            ("native", "native",
             make_mesh((n,), ("model",), devices=devices))):
        srv = ServeEngine(cfg, params, ProgressEngine(), batch_slots=4,
                          max_seq=32, mesh=mesh,
                          collective_spec=CollectiveSpec(backend=backend,
                                                         chunks=2))
        reqs = [GenRequest(f"r{i}", p, max_new_tokens=6)
                for i, p in enumerate(ps)]
        for r in reqs:
            srv.submit(r)
        srv.run_until_idle(timeout=300)
        if backend == "user":
            assert srv._ag_handle.starts == srv.steps > 0
        assert srv._rows_checked
        srv.close(timeout=60)
        runs[name] = [list(r.out_tokens) for r in reqs]
    assert runs["user"] == runs["native"] == runs["stacked"]


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
def test_restore_lane_into_each_cards_replica(cuda, distinct):
    """A lane snapshot of a one-card pool restored into a pool with a
    replica on each of 4 ranks' cards: every replica's lane equals the
    source lane (its snapshot from each replica, bit for bit)."""
    import numpy as np

    from repro_torch.collectives.rank_shards import tree_shard
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import registry
    from repro_torch.serve.kvcache import PagedKVCache, to_device
    devices = _rank_devices(4, distinct)
    cfg, params = _tiny_serve()
    src = PagedKVCache(cfg, 2, 32, block_size=4, device="cuda:0")
    lane = src.assign("req", seq_len=1)
    rs = np.random.RandomState(3)
    for t in range(6):
        assert src.ensure(lane.index, t)
        _, src.cache = registry.decode_step_paged(
            params, cfg, src.cache,
            to_device(rs.randint(1, cfg.vocab_size, (2, 1)).astype(np.int32),
                      src.device),
            to_device(np.full((2,), t, np.int32), src.device),
            src.block_tables(), to_device(np.array([True, False]),
                                          src.device))
        src.slots[lane.index].pos = t + 1
    ckpt = src.checkpoint_lane(lane.index)
    mesh = make_mesh((4,), ("model",), devices=devices)
    pool = PagedKVCache(cfg, 2, 32, block_size=4, mesh=mesh)
    pool.assign("other", seq_len=9)
    lane2 = pool.assign("req", seq_len=7)
    pool.restore_lane(pool.cache, lane2.index, ckpt)
    for r in range(4):
        one = PagedKVCache(cfg, 2, 32, block_size=4, device=devices[r])
        one.cache = tree_shard(pool.cache, r)
        one.assign("other", seq_len=9)
        one.assign("req", seq_len=7)
        one.slots[lane2.index].pos = 6
        got = one.checkpoint_lane(lane2.index)
        for part in ("blocks", "state"):
            assert got[part].keys() == ckpt[part].keys()
            for k in ckpt[part]:
                np.testing.assert_array_equal(got[part][k], ckpt[part][k])


# ---------------------------------------------------------------------------
# 1F1B with a stage per card, expert parallelism with each rank's experts
# on its card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
def test_1f1b_stage_per_card_equals_the_stacked_run(cuda, distinct):
    """The run of ``test_1f1b_on_stage_streams_equals_sequential`` (S = 4,
    M = 8) with stage s on its own card: the loss and gradients of two
    steps bit for bit against the stacked schedule on ``cuda:0``, each
    gradient block on its stage's card; ``apply`` equal to the stacked
    forward and to the per-card ``gpipe``."""
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.core import ProgressEngine, ProgressExecutor
    from repro_torch.distributed import pipeline as pl
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_mesh
    S, M, mb = 4, 8, 4
    devices = _rank_devices(S, distinct)
    g = torch.Generator(device="cuda").manual_seed(0)
    params = {"w1": torch.randn((S, 16, 32), generator=g, device="cuda"),
              "w2": torch.randn((S, 32, 16), generator=g, device="cuda")}
    xs = torch.randn((M, mb, 16), generator=g, device="cuda")
    eng = ProgressEngine()
    ex = ProgressExecutor(eng, num_workers=2).start()
    eng.attach_executor(ex)
    smesh = make_mesh((S,), ("stage",), "cuda:0")
    dmesh = make_mesh((S,), ("stage",), devices=devices)
    blocks = {k: RankShards.from_stacked(v, dmesh) for k, v in params.items()}
    kw = dict(loss_fn=launch.pipe_loss_fn, engine=eng, executor=ex)
    stacked = pl.PipelineSchedule(launch.pipe_stage_fn, smesh, "stage", S,
                                  name="s", **kw)
    per = pl.PipelineSchedule(launch.pipe_stage_fn, dmesh, "stage", S,
                              name="d", **kw)
    for _ in range(2):
        loss, grads = stacked.step(params, xs, xs, timeout=120)
        dloss, dgrads = per.step(blocks, xs, xs, timeout=120)
        assert str(dloss.device) == devices[-1]
        assert torch.equal(dloss.to("cuda:0"), loss)
        for k in params:
            assert [str(d) for d in dgrads[k].devices] == devices
            assert torch.equal(dgrads[k].to_stacked("cuda:0"), grads[k])
    ys = per.apply(blocks, xs, timeout=120)
    assert torch.equal(ys.to("cuda:0"), stacked.apply(params, xs,
                                                      timeout=120))
    gp = pl.gpipe(launch.pipe_stage_fn, dmesh, "stage", S)(blocks, xs)
    assert torch.equal(ys, gp)
    assert [c.device for c in per.cuda_streams] == [torch.device(d)
                                                    for d in devices]
    # every row a hop carried left its card when the cards are distinct
    st = per.stats()
    assert st["hop_rows"] == S * sum(st["hop_starts"].values()) > 0
    assert st["hop_rows_between_devices"] == (st["hop_rows"] if distinct
                                              else 0)
    per.close()
    stacked.close()
    ex.shutdown(drain=True, timeout=60)


def _exact_moe(cfg, B, S, gen):
    """Integer-valued tokens and weights on which the MoE layer's every
    product and sum is exact in f32 (``tests/test_torch_moe.py``'s
    ``exact_moe_inputs``): two one-hot experts a token against a router of
    200 on the diagonal, gate weights 0 or 20."""
    D, E, F_ = cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_d_ff
    x = torch.randint(0, 3, (B, S, D), generator=gen).float()
    hot = torch.rand(B, S, E, generator=gen).argsort(-1)[..., :2]
    x[..., :E] = torch.zeros(B, S, E).scatter(-1, hot, 1.0)
    router = torch.zeros(D, E)
    router[torch.arange(E), torch.arange(E)] = 200.0
    p = {"router": router,
         "wi_gate": torch.randint(0, 2, (E, D, F_), generator=gen) * 20.0,
         "wi_up": torch.randint(-1, 2, (E, D, F_), generator=gen).float(),
         "wo": torch.randint(-1, 2, (E, F_, D), generator=gen).float()}
    return p, x


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
def test_per_device_expert_parallel_equals_the_stacked_layer(cuda, distinct):
    """granite's MoE layer at reduced widths (40 experts, 4 groups of 512
    tokens; d 64 and expert width 32 for the exact inputs) on 4 ranks with each rank's groups and experts on its card:
    user = native bit for bit; on integer-valued f32 inputs y and aux bit
    for bit against the stacked ``moe_apply_expert_parallel`` on
    ``cuda:0``; on random bf16 inputs within the bf16 tolerance."""
    from repro_torch.collectives.nonblocking import UserCollectives
    from repro_torch.collectives.rank_shards import RankShards, replicate
    from repro_torch.configs import get_config
    from repro_torch.core import ProgressEngine
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers
    devices = _rank_devices(4, distinct)
    smesh = make_mesh((4,), ("model",), "cuda:0")
    dmesh = make_mesh((4,), ("model",), devices=devices)
    gen = torch.Generator().manual_seed(13)
    base = get_config("granite-moe-3b-a800m")
    # d 64 and expert width 32: every partial sum below 2^24 by design
    cfg32 = base.with_overrides(d_model=64, dtype="float32", moe=dataclasses
                                .replace(base.moe, expert_d_ff=32))
    exact = _exact_moe(cfg32, 8, 256, gen)
    cfg16 = get_config("granite-moe-3b-a800m").with_overrides(d_model=256)
    p16 = layers.init_tree(layers.moe_spec(cfg16), cuda)
    x16 = torch.randn(8, 256, 256, generator=cuda, device="cuda").to(
        torch.bfloat16)
    coll = UserCollectives(ProgressEngine())
    try:
        for cfg, (p, x) in ((cfg32, exact), (cfg16, (p16, x16))):
            p = {k: v.to("cuda:0") for k, v in p.items()}
            x = x.to("cuda:0")
            y, aux = layers.moe_apply_expert_parallel(p, x, cfg, smesh)
            pd = {k: replicate(v, devices) if k == "router"
                  else RankShards.from_stacked(v, dmesh)
                  for k, v in p.items()}
            xd = RankShards.from_stacked(x, dmesh)
            yn, auxn = layers.moe_apply_expert_parallel(pd, xd, cfg, dmesh)
            yu, auxu = layers.moe_apply_expert_parallel(pd, xd, cfg, dmesh,
                                                        coll=coll)
            assert [str(d) for d in yn.devices] == devices
            yn, yu = yn.to_stacked("cuda:0"), yu.to_stacked("cuda:0")
            assert torch.equal(yn, yu) and torch.equal(auxn, auxu)
            if x.dtype == torch.float32:
                assert torch.equal(yn, y) and torch.equal(auxn.cpu(),
                                                          aux.cpu())
            else:
                torch.testing.assert_close(yn, y, **TOLS[torch.bfloat16])
                torch.testing.assert_close(auxn.cpu(), aux.cpu(),
                                           rtol=1e-6, atol=0)
    finally:
        coll.close()


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_device_ring_equals_the_stacked_ring(cuda, dtype, cap, distinct):
    """The ring with rank r's blocks on ``devices[r]`` (4 ranks, causal
    GQA at smollm-360m's heads) against the stacked ring on cuda:0: the
    output and dq/dk/dv bit for bit, the per-device run under
    ``set_sync_debug_mode("error")``."""
    import importlib

    from repro_torch import sharding
    from repro_torch.launch.mesh import make_mesh
    RA = importlib.import_module("repro_torch.collectives.ring_attention")
    devices = _rank_devices(4, distinct)
    q, k, v, do = (torch.randn(*s, generator=cuda, device="cuda").to(dtype)
                   for s in ((2, 256, 15, 64), (2, 256, 5, 64),
                             (2, 256, 5, 64), (2, 256, 15, 64)))
    got = {}
    for name, mesh in (("stacked", make_mesh((1, 4), ("data", "model"),
                                             "cuda:0")),
                       ("devices", make_mesh((1, 4), ("data", "model"),
                                             devices=devices))):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        if name == "devices":
            torch.cuda.set_sync_debug_mode("error")
        try:
            with sharding.set_mesh(mesh):
                o = RA.ring_attention(*leaves, causal=True, logit_cap=cap)
            got[name] = [o, *torch.autograd.grad(o, leaves, do)]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got["stacked"], got["devices"]):
        assert a.device == b.device and torch.equal(a, b)


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
def test_per_device_moe_block_equals_the_tp_block(cuda, distinct):
    """The MoE block on 4 ranks over F = 2048 with rank r's F-slices on
    ``devices[r]`` against the stacked tensor-parallel block on cuda:0,
    f32 with TF32 off: ``y`` and every gradient bit for bit, each slice's
    gradient on its rank's card."""
    from repro_torch import sharding
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    devices = _rank_devices(4, distinct)
    g, t, E, C, d, F_ = 2, 256, 8, 80, 256, 2048
    xg = torch.randn(g, t, d, generator=cuda, device="cuda")
    pick = torch.randint(0, E * C, (g, t), generator=cuda, device="cuda")
    disp = torch.zeros(g, t, E * C, device="cuda").scatter_(
        2, pick[..., None], 1.0).view(g, t, E, C)
    comb = disp * torch.rand(g, t, 1, 1, generator=cuda, device="cuda")
    ws = [torch.randn(*s, generator=cuda, device="cuda") / 16
          for s in ((E, d, F_), (E, d, F_), (E, F_, d))]
    dy = torch.randn(g, t, d, generator=cuda, device="cuda")
    dmesh = make_mesh((1, 4), ("data", "model"), devices=devices)
    got = {}
    for name, mesh in (("stacked", make_mesh((1, 4), ("data", "model"),
                                             "cuda:0")), ("devices", dmesh)):
        leaves = [x.clone().requires_grad_(i != 1)
                  for i, x in enumerate((xg, disp, comb))]
        if name == "stacked":
            w = [x.clone().requires_grad_() for x in ws]
            wrt = w
        else:
            w = [RankShards.from_stacked(x, dmesh, dim=dim)
                 for x, dim in zip(ws, (2, 2, 1))]
            wrt = [s.requires_grad_() for x in w for s in x.shards]
        with sharding.set_mesh(mesh), L.training_mode():
            y = L._moe_expert_block(*leaves, *w)
        grads = torch.autograd.grad(y, [leaves[0], leaves[2], *wrt], dy)
        if name == "devices":
            assert [str(x.device) for x in grads[2:6]] == devices
            grads = list(grads[:2]) + [
                torch.cat([x.to("cuda:0") for x in grads[2 + 4 * k:
                                                          6 + 4 * k]],
                          dim=(2, 2, 1)[k]) for k in range(3)]
        got[name] = [y, *grads]
    for a, b in zip(got["stacked"], got["devices"]):
        assert torch.equal(a, b)


def test_launcher_model_axis_rank_devices_equals_the_stacked_run(cuda,
                                                                 tmp_path):
    """``launch.train --mesh 1x4 --rank-devices cuda:0 x4`` (smollm-360m
    at its tiny scale, "ring", 3 steps on the card) against the stacked
    ``--mesh 1x4`` run: every step's loss bit for bit."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    losses = {}
    for name, extra in (("stacked", []),
                        ("devices", ["--rank-devices",
                                     "cuda:0,cuda:0,cuda:0,cuda:0"])):
        args = launch.build_parser().parse_args(
            ["--scale", "tiny", "--steps", "3", "--global-batch", "8",
             "--seq", "64", "--mesh", "1x4", "--ckpt-dir",
             str(tmp_path / name)] + extra)
        cfg = make_config(args.arch, args.scale).with_overrides(
            attention_impl="ring")
        losses[name] = [m["loss"] for m in launch.run(
            args, config=cfg, log_every=1).log]
    assert len(losses["devices"]) == 3
    assert losses["devices"] == losses["stacked"]


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_launcher_fsdp_on_a_model_axis_equals_the_stacked_run(
        cuda, tmp_path, mesh, distinct):
    """``launch.train --mesh DxM --fsdp --collective-backend user
    --rank-devices ...`` (smollm-360m at its tiny scale, 3 steps on the
    card): every step's loss and grad norm bit for bit the stacked
    ``--mesh DxM --fsdp`` run's, the leaders' blocks its shards, and
    every copy of a block and of its moments its leader's."""
    from repro_torch.launch import train as launch
    D, M = (int(v) for v in mesh.split("x"))
    devices = _rank_devices(D * M, distinct)
    runs = {}
    for name, extra in (("stacked", []),
                        ("devices", ["--rank-devices", ",".join(devices)])):
        args = launch.build_parser().parse_args(
            ["--scale", "tiny", "--steps", "3", "--global-batch", "8",
             "--seq", "64", "--mesh", mesh, "--fsdp",
             "--collective-backend", "user", "--ckpt-dir",
             str(tmp_path / name)] + extra)
        runs[name] = launch.run(args, log_every=1)
    a, b = runs["stacked"], runs["devices"]
    for key in ("loss", "grad_norm"):
        assert [m[key] for m in b.log] == [m[key] for m in a.log]
    assert len(b.log) == 3
    tr = b.trainer
    for s, t in zip(tr.params, a.trainer.params):
        assert s.copies == M and torch.equal(s.to_stacked("cuda:0"), t)
    for leaf in [*tr.params, *tr.opt_state.mu, *tr.opt_state.nu]:
        for i, t in enumerate(leaf.shards):
            assert torch.equal(t.to("cuda:0"),
                               leaf.shards[i % len(leaf.blocks)].to("cuda:0"))


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_launcher_model_axis_microbatches_equal_the_stacked_run(
        cuda, tmp_path, mesh):
    """``launch.train --mesh DxM --microbatches 2 --rank-devices cuda:0
    x4`` (smollm-360m at its tiny scale, "ring", 3 steps on the card)
    against the stacked ``--mesh DxM --microbatches 2`` run: every step's
    loss bit for bit with one data row, within 1e-5 with two."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    losses = {}
    for name, extra in (("stacked", []),
                        ("devices", ["--rank-devices",
                                     "cuda:0,cuda:0,cuda:0,cuda:0"])):
        args = launch.build_parser().parse_args(
            ["--scale", "tiny", "--steps", "3", "--global-batch", "8",
             "--seq", "64", "--mesh", mesh, "--microbatches", "2",
             "--ckpt-dir", str(tmp_path / name)] + extra)
        cfg = make_config(args.arch, args.scale).with_overrides(
            attention_impl="ring", dtype="float32")
        losses[name] = [m["loss"] for m in launch.run(
            args, config=cfg, log_every=1).log]
    assert len(losses["devices"]) == 3
    if mesh.startswith("1x"):
        assert losses["devices"] == losses["stacked"]
    else:
        for a, b in zip(losses["devices"], losses["stacked"]):
            assert abs(a - b) <= 1e-5 * abs(b)


# PyTorch's warning when a gradient reaches a leaf's AccumulateGrad from a
# node on another stream (``set_warn_on_accumulate_grad_stream_mismatch``)
STREAM_MISMATCH = ".*AccumulateGrad node's stream does not match"


@pytest.mark.parametrize("n", [2, 4])
def test_per_device_moe_block_backward_has_no_stream_mismatch(cuda, n):
    """The MoE block with rank r's F-slices on card r of n distinct cards,
    forward and backward with PyTorch's stream-mismatch warning made an
    error: each slice's gradient reaches its AccumulateGrad from a node
    on its own card's stream."""
    from repro_torch import sharding
    from repro_torch.collectives.rank_shards import RankShards
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    devices = _rank_devices(n, True)
    g, t, E, C, d, F_ = 2, 128, 4, 64, 128, 512 * n
    xg = torch.randn(g, t, d, generator=cuda, device="cuda",
                     requires_grad=True)
    pick = torch.randint(0, E * C, (g, t), generator=cuda, device="cuda")
    disp = torch.zeros(g, t, E * C, device="cuda").scatter_(
        2, pick[..., None], 1.0).view(g, t, E, C)
    comb = (disp * torch.rand(g, t, 1, 1, generator=cuda,
                              device="cuda")).requires_grad_()
    mesh = make_mesh((1, n), ("data", "model"), devices=devices)
    w = [RankShards.from_stacked(
        torch.randn(*s, generator=cuda, device="cuda") / 16, mesh, dim=dim)
         for s, dim in (((E, d, F_), 2), ((E, d, F_), 2), ((E, F_, d), 1))]
    wrt = [s.requires_grad_() for x in w for s in x.shards]
    torch.autograd.graph.set_warn_on_accumulate_grad_stream_mismatch(True)
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=STREAM_MISMATCH)
        with sharding.set_mesh(mesh), L.training_mode():
            y = L._moe_expert_block(xg, disp, comb, *w)
        grads = torch.autograd.grad(y.sum(), [xg, comb, *wrt])
        torch.cuda.synchronize()
    assert [str(x.device) for x in grads[2:2 + n]] == devices


@pytest.mark.parametrize("distinct", [False, True],
                         ids=["cuda0-repeated", "distinct-cards"])
def test_launcher_moe_group_across_rows_on_the_card(cuda, tmp_path,
                                                    distinct):
    """``launch.train --mesh 2x2 --rank-devices`` with tiny grok-1 (experts
    2048 wide: F-slices on the model ranks) on 4 x 16 tokens, one MoE
    group split between the data rows, 3 steps in f32 on the card(s),
    with PyTorch's stream-mismatch warning made an error: the rows run in
    lockstep and every step's loss holds the stacked ``--mesh 2x2``
    run's within 1e-5."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.serve import make_config
    devices = _rank_devices(4, distinct)
    losses = {}
    torch.autograd.graph.set_warn_on_accumulate_grad_stream_mismatch(True)
    for name, extra in (("stacked", []),
                        ("devices", ["--rank-devices", ",".join(devices)])):
        args = launch.build_parser().parse_args(
            ["--arch", "grok-1-314b", "--scale", "tiny", "--steps", "3",
             "--global-batch", "4", "--seq", "16", "--mesh", "2x2",
             "--ckpt-dir", str(tmp_path / name)] + extra)
        cfg = make_config(args.arch, args.scale)
        cfg = cfg.with_overrides(dtype="float32", attention_impl="ring",
                                 d_ff=4096, moe=dataclasses.replace(
                                     cfg.moe, expert_d_ff=2048))
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=STREAM_MISMATCH)
            losses[name] = [m["loss"] for m in launch.run(
                args, config=cfg, log_every=1).log]
    assert len(losses["devices"]) == 3
    for a, b in zip(losses["devices"], losses["stacked"]):
        assert abs(a - b) <= 1e-5 * abs(b)

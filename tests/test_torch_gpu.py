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

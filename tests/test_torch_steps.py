"""The port's ``launch/steps.py`` against the JAX package's on the CPU:
each cell's step function on the same bridged weights and numpy-made
inputs, over a 1x1 host mesh (JAX's ``build_cell(...).step_fn`` jitted
under that mesh), in f32, at the reduced configs of
``tests/test_dryrun_small.py``.

Tolerances (f32, stated before the comparison): logits, decode caches
and losses within 1e-4 absolute and relative (``TOL``, the other parity
files'); after the AdamW step the first moment mu = 0.1·g (the clipped
gradient) within 1e-4 of each leaf's largest entry, and the parameters
within 2·lr·1.01: an Adam step moves an entry by at most ~lr, and for
entries whose gradient is near 0 the two libraries' roundings may give
it either sign.  The bf16 case (``cast_params_bf16``) holds its loss
within 2e-2 relative: the libraries round bf16 at other places."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import get_config as jax_get_config
from repro.configs.shapes import ShapeSpec as JaxShapeSpec
from repro.launch.mesh import make_mesh as jax_make_mesh
from repro.launch.steps import build_cell as jax_build_cell
from repro.models import registry as jax_registry
from repro.serve import quantization as jax_qz
from repro.train import optimizer as jax_opt
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_cell
from repro_torch.models import bridge

TOL = dict(atol=1e-4, rtol=1e-4)
LR = 3e-4                       # AdamWConfig's default
B, S = 4, 64


def reduced(arch: str, **extra) -> dict:
    """The reduced config of ``tests/test_dryrun_small.py``."""
    cfg = jax_get_config(arch)
    kw = dict(num_layers=2, d_model=64, d_ff=128, vocab_size=256,
              remat_policy="full", dtype="float32")
    if cfg.num_heads:
        kw.update(num_heads=4, num_kv_heads=2, head_dim=16)
    if cfg.shared_attn_every:
        kw.update(num_layers=4, shared_attn_every=2, shared_attn_lora_rank=4)
    if cfg.is_encoder_decoder:
        kw.update(num_encoder_layers=2, encoder_frames=16,
                  max_position_embeddings=256)
    kw.update(extra)
    return kw


def configs(arch: str, **extra):
    kw = reduced(arch, **extra)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jover, tover = dict(kw), dict(kw)
    if jcfg.moe:
        jover["moe"] = jcfg.moe.__class__(num_experts=4, top_k=2,
                                          expert_d_ff=64, group_size=64)
        tover["moe"] = tcfg.moe.__class__(num_experts=4, top_k=2,
                                          expert_d_ff=64, group_size=64)
    if jcfg.ssm:
        jover["ssm"] = jcfg.ssm.__class__(d_state=16, expand=2, head_dim=16,
                                          chunk_size=16)
        tover["ssm"] = tcfg.ssm.__class__(d_state=16, expand=2, head_dim=16,
                                          chunk_size=16)
    return jcfg.with_overrides(**jover), tcfg.with_overrides(**tover)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree) -> dict:
    """{path: numpy} of a port tree (NamedTuple nodes as fields)."""
    out = {}

    def walk(t, path):
        if hasattr(t, "_fields"):
            for f in t._fields:
                walk(getattr(t, f), path + (f,))
        elif isinstance(t, dict):
            for k in t:
                walk(t[k], path + (k,))
        else:
            out["/".join(path)] = np.asarray(t.detach().float().numpy()
                                             if isinstance(t, torch.Tensor)
                                             else t)
    walk(tree, ())
    return out


def jflat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in p): np.asarray(v, np.float32)
            for p, v in leaves}


def batch_np(jcell, kind: str, vocab: int, seed: int = 3) -> dict:
    rs = np.random.RandomState(seed)
    out = {}
    for k, spec in jcell.abstract_args[-1].items():
        if k == "pos":
            out[k] = rs.randint(S // 2, S, size=spec.shape).astype(np.int32)
        elif np.issubdtype(spec.dtype, np.integer):
            out[k] = rs.randint(0, vocab, size=spec.shape).astype(np.int32)
        else:
            out[k] = rs.randn(*spec.shape).astype(np.float32)
    return out


def run_both(arch, kind, **kw):
    """(JAX outputs, port outputs, bridged inputs) of one cell's step."""
    bf16 = kw.pop("bf16", False)
    jcfg, tcfg = configs(arch, **({"dtype": "bfloat16"} if bf16 else {}))
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    jcell = jax_build_cell(jcfg, JaxShapeSpec("t", S, B, kind), jmesh, **kw)
    tcell = build_cell(tcfg, ShapeSpec("t", S, B, kind),
                       make_mesh((1, 1), ("data", "model"), "cpu"), **kw)
    jparams = jax_registry.init_params(jcfg, jax.random.PRNGKey(0))
    if kw.get("int8_weights"):
        jparams = jax_qz.quantize_tree(jparams)
    pnp = np_tree(jparams)
    batch = batch_np(jcell, kind, jcfg.vocab_size)
    jbatch = {k: jnp.asarray(v).astype(jcell.abstract_args[-1][k].dtype)
              for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).to(tcell.abstract_args[-1][k].dtype)
              for k, v in batch.items()}
    args_j, args_t = [jparams], [bridge.params_from_numpy(pnp, "cpu")]
    if kind == "train":
        jstate = jax_opt.init(jparams)
        args_j.append(jstate)
        args_t.append(bridge.opt_state_from_numpy(np_tree(jstate), "cpu"))
    elif kind == "decode":
        rs = np.random.RandomState(5)
        cache = jax.tree.map(
            lambda s: (rs.randn(*s.shape) * 0.5).astype(s.dtype),
            jcell.abstract_args[1])
        args_j.append(jax.tree.map(jnp.asarray, cache))
        args_t.append(bridge.cache_from_numpy(cache, "cpu"))
    args_j.append(jbatch)
    args_t.append(tbatch)
    with compat.set_mesh(jmesh):
        jout = jax.jit(jcell.step_fn)(*args_j)
    tout = tcell.step_fn(*args_t)
    return jout, tout, tcell


def check_train(jout, tout, *, bf16=False):
    (jp, js, jm), (tp, ts, tm) = jout, tout
    if bf16:
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-2)
        return
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    jmu, tmu = jflat(js.mu), flat(ts.mu)
    assert jmu.keys() == tmu.keys()
    for k in jmu:
        lim = 1e-4 * max(float(np.abs(jmu[k]).max()), 1e-12)
        np.testing.assert_allclose(tmu[k], jmu[k], atol=lim, rtol=0,
                                   err_msg=k)
    jpf, tpf = jflat(jp), flat(tp)
    for k in jpf:
        np.testing.assert_allclose(tpf[k], jpf[k], atol=2 * LR * 1.01,
                                   rtol=0, err_msg=k)
    assert int(ts.step) == int(js.step) == 1


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "mamba2-1.3b"])
def test_train_cell_matches_jax(arch):
    jout, tout, _ = run_both(arch, "train")
    check_train(jout, tout)


def test_train_cell_microbatches_and_bf16_cast():
    """smollm with ``microbatches=2, cast_params_bf16=True``: in f32 (the
    cast a no-op, the accumulation held as above) and in bf16 (the cast
    real; the loss within 2e-2)."""
    kw = dict(microbatches=2, cast_params_bf16=True)
    jout, tout, _ = run_both("smollm-360m", "train", **kw)
    check_train(jout, tout)
    jout, tout, _ = run_both("smollm-360m", "train", bf16=True, **kw)
    check_train(jout, tout, bf16=True)


def test_prefill_cell_matches_jax():
    jout, tout, _ = run_both("qwen2-0.5b", "prefill")
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("arch,kw", [
    ("zamba2-1.2b", {}), ("whisper-tiny", {}),
    ("qwen2-0.5b", {"int8_weights": True}),
    ("qwen2-0.5b", {"decode_weight_stationary": True})],
    ids=["zamba2", "whisper", "qwen2-int8", "qwen2-ws"])
def test_decode_cell_matches_jax(arch, kw):
    (jl, jc), (tl, tc), cell = run_both(arch, "decode", **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jcf, tcf = jflat(jc), flat(tc)
    assert jcf.keys() == tcf.keys()
    for k in jcf:
        np.testing.assert_allclose(tcf[k], jcf[k], err_msg=k, **TOL)
    if kw.get("decode_weight_stationary"):
        # the rules replicate the decode batch: its spec names no axis
        assert cell.in_shardings[2]["tokens"] == ()


def test_cell_placements_match_jax_on_a_4x2_mesh():
    """The placements a cell records are JAX's spec tuples: resolved on a
    (data 4, model 2) mesh without any device (the port's mesh object
    only names its axes), for the params, the AdamW state and the batch
    of a train cell and the int8 weights and cache of a decode cell."""
    from jax.sharding import AbstractMesh
    from repro.sharding import merged_rules, axis_rules, spec_tree
    jcfg, tcfg = configs("qwen2-0.5b")
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    for kind, kw in (("train", {}), ("decode", {"int8_weights": True})):
        cell = build_cell(tcfg, ShapeSpec("t", S, 8, kind), mesh, **kw)
        amesh = AbstractMesh((4, 2), ("data", "model"))
        with axis_rules(merged_rules(jcfg.sharding_overrides)):
            pshape = jax_registry.param_shapes(jcfg)
            paxes = jax_registry.param_axes(jcfg)
            if kw:
                want = spec_tree(jax_qz.quantized_axes(paxes, pshape),
                                 jax_qz.quantized_shapes(pshape), amesh)
            else:
                want = spec_tree(paxes, pshape, amesh)
        got = cell.in_shardings[0]
        wl = jax.tree_util.tree_flatten_with_path(
            want, is_leaf=lambda x: type(x).__name__ == "PartitionSpec")[0]
        for path, spec in wl:
            keys = [str(getattr(k, "key", getattr(k, "name", k))) for k in path]
            node = got
            for key in keys:
                node = getattr(node, key) if hasattr(node, "_fields") \
                    else node[key]
            assert tuple(node) == tuple(spec), (kind, keys, node, spec)

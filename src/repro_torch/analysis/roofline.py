"""Three-term roofline of one cell from the dry run's counts, on the H100
(the JAX package's ``analysis/roofline.py``, whose constants are a TPU
v5e's):

    compute term    = Σ_dtype counted FLOPs / peak FLOP/s of that dtype
    memory term     = analytical bytes / HBM bytes/s
    collective term = collective bytes / link bytes/s

per device.  The counts come from ``analysis/opcount.py`` (one data
rank's step on meta tensors: the model axis replicates in the port) and
the collective plans of the cell's mesh; the constants from
``launch.mesh.H100_SXM``.  ``analytical_bytes`` is the JAX package's
traffic model, arithmetic for arithmetic; the counted bytes (every aten
op's operands and results: the eager program's traffic, one kernel per
op) stay beside it as an upper bound, as JAX keeps its parsed bytes.
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import H100_SXM, link_bytes_per_s, peak_flops


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device counted quantities
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_type: dict
    # terms (seconds)
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    # usefulness
    model_flops: float
    counted_flops_global: float
    useful_ratio: float
    # memory fit
    bytes_in_use_per_device: float | None = None
    # XLA's ``dynamic_while`` (a loop whose trip count the HLO does not
    # give, so its counts are a lower bound) has no counterpart: the meta
    # step runs every loop.  What the meta step cannot see is data: a
    # decode lane's length.  True when the kernels' work took every lane
    # at its cache's full length (an upper bound for shorter lanes).
    lengths_assumed_full: bool = False
    # the counted bytes over the HBM rate: the eager program's traffic,
    # one kernel per aten op, an upper bound beside the analytical model
    memory_s_counted_upper: float = 0.0
    bytes_analytical: float = 0.0

    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self, hw: dict = H100_SXM) -> float:
        """Fraction of the roofline bound that is useful compute, at the
        card's bf16 peak."""
        useful_compute_s = self.model_flops / (self.chips
                                               * hw["peak_flops_bf16"])
        return useful_compute_s / max(self.bound_s(), 1e-30)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["dominant"] = self.dominant
        d["bound_s"] = self.bound_s()
        d["roofline_fraction"] = self.roofline_fraction()
        return d


def analytical_bytes(cfg, shape, chips: int, mesh_shape: dict,
                     weight_bytes: float = 2.0) -> float:
    """Per-device HBM traffic model for one step (fused assumptions; the
    JAX package's, unchanged).

    Counts: parameter streams (fwd read + bwd read + grad write + optimizer
    read-modify-write of two f32 moments + f32 master params), layer-
    boundary activations (write fwd, read bwd, plus one remat re-read),
    flash-attention q/k/v/o traffic, logits, and KV-cache traffic for
    decode.  Elementwise temporaries are assumed fused.
    """
    from repro_torch.models import registry
    B, S = shape.global_batch, shape.seq_len
    D = cfg.d_model
    n_params = registry.param_count(cfg)
    dp = 1
    for ax in ("pod", "data"):
        dp *= mesh_shape.get(ax, 1)
    tp = mesh_shape.get("model", 1)
    params_local = n_params / chips  # FSDP+TP shards params over all chips
    b_loc = max(B / dp, 1)
    act_layers = cfg.num_layers + cfg.num_encoder_layers

    if shape.kind == "train":
        # params: bf16 fwd+bwd reads (2x2B) + grad f32 w (4) + master f32
        # r/w (8) + two moments f32 r/w (16) = 32 B/param
        t = params_local * 32.0
        # layer-boundary activations: fwd write + bwd read + remat re-read
        t += act_layers * b_loc * S * D * 2 * 3
        # flash attention q/k/v/o streams (fwd + bwd ~2x)
        if cfg.num_heads:
            hd = cfg.resolved_head_dim()
            att = (cfg.num_layers if cfg.family != "hybrid"
                   else cfg.num_layers // max(cfg.shared_attn_every, 1))
            att += cfg.num_encoder_layers
            heads_w = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
            t += 3 * att * b_loc * S * heads_w * 2
        # logits + loss (f32) fwd+bwd
        t += 3 * b_loc * S * (cfg.vocab_size / tp) * 4
        # MoE dispatched tokens
        if cfg.moe is not None:
            t += 3 * cfg.num_layers * b_loc * S * cfg.moe.top_k * D * 2
        return t
    if shape.kind == "prefill":
        t = params_local * 2.0   # bf16 weight read
        t += act_layers * b_loc * S * D * 2 * 1
        if cfg.num_heads:
            hd = cfg.resolved_head_dim()
            heads_w = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd
            t += act_layers * b_loc * S * heads_w * 2
        t += b_loc * S * (cfg.vocab_size / tp) * 4
        if cfg.moe is not None:
            t += cfg.num_layers * b_loc * S * cfg.moe.top_k * D * 2
        return t
    # decode: weights once (bf16=2B, int8=1B) + cache read/write
    t = params_local * weight_bytes
    if cfg.num_heads:
        hd = cfg.resolved_head_dim()
        att = (cfg.num_layers if cfg.family != "hybrid"
               else cfg.num_layers // max(cfg.shared_attn_every, 1))
        att += cfg.num_encoder_layers
        kv_b = 1 if getattr(cfg, "kv_cache_dtype", "bf16") == "int8" else 2
        cache = att * B * S * cfg.num_kv_heads * hd * kv_b * 2  # k+v read
        t += cache / chips
    if cfg.ssm is not None:
        from repro_torch.models import mamba as M
        d_inner, nh, hp, ds = M.dims(cfg)
        t += cfg.num_layers * B * nh * hp * ds * 4 * 2 / chips
    t += max(B / dp, 1) * (cfg.vocab_size / tp) * 4
    return t


def from_counts(counts: dict, *, arch: str, shape: str, mesh_name: str,
                chips: int, model_flops: float,
                bytes_in_use: float | None = None,
                cfg=None, shape_spec=None, mesh_shape: dict | None = None,
                weight_bytes: float = 2.0, coll_by_type: dict | None = None,
                hw: dict = H100_SXM) -> Roofline:
    """The roofline of one device from ``opcount.count``'s dict (one data
    rank's step) and the per-device collective bytes by type."""
    flops_dev = counts["flops"]
    bytes_dev = counts["bytes"]
    coll_by_type = dict(coll_by_type or {})
    coll_dev = float(sum(coll_by_type.values()))
    compute_s = sum(f / peak_flops(dt, hw)
                    for dt, f in counts["flops_by_dtype"].items())
    memory_s_upper = bytes_dev / hw["hbm_bytes_per_s"]
    if cfg is not None and shape_spec is not None:
        bytes_an = analytical_bytes(cfg, shape_spec, chips, mesh_shape or {},
                                    weight_bytes=weight_bytes)
    else:
        bytes_an = bytes_dev
    memory_s = bytes_an / hw["hbm_bytes_per_s"]
    collective_s = coll_dev / link_bytes_per_s(chips, hw)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    flops_global = flops_dev * chips
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=flops_dev, bytes_per_device=bytes_dev,
        coll_bytes_per_device=coll_dev, coll_by_type=coll_by_type,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        counted_flops_global=flops_global,
        useful_ratio=model_flops / max(flops_global, 1e-30),
        bytes_in_use_per_device=bytes_in_use,
        lengths_assumed_full=bool(counts["kernels"].get("flash_decode")),
        memory_s_counted_upper=memory_s_upper,
        bytes_analytical=bytes_an,
    )

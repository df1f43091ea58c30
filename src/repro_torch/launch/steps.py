"""Step builders shared by the dry run, the trainer and the server (the
JAX package's ``launch/steps.py``).

``build_cell`` returns, for one (arch × shape × mesh) cell, the step
function, its arguments as ``meta`` tensors (no storage) and their
placements.  There is no ``lower()``: the dry run runs the step on the
``meta`` arguments under a counter (``analysis/opcount.py``), and
``Cell.materialize`` makes real arguments on a device for a run.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec, input_specs
from repro_torch.models import registry
from repro_torch.models.layers import (torch_dtype, tree_from_leaves,
                                       tree_leaves, tree_map)
from repro_torch.train import optimizer as opt

BATCH_AXES = {
    "tokens": ("batch", "act_seq"),
    "labels": ("batch", "act_seq"),
    "encoder_embeds": ("batch", "frames", "act_embed"),
    "vision_embeds": ("batch", "frames", "act_embed"),
    "pos": ("batch",),
}


@dataclasses.dataclass
class Cell:
    """One cell: ``step_fn(*args)`` with ``args`` shaped as
    ``abstract_args`` (``meta`` tensors: params — or int8 weights —,
    then the optimizer state for train or the slot cache for decode, then
    the batch of ``input_specs``); ``in_shardings``/``out_shardings`` are
    the matching trees of resolved spec tuples (``sharding.spec_tree``),
    None where JAX leaves a placement to the compiler."""
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: Any
    step_fn: Callable
    abstract_args: tuple
    in_shardings: tuple
    out_shardings: Any
    int8_weights: bool = False

    def materialize(self, device, generator: torch.Generator) -> tuple:
        """Real arguments on ``device``, drawn from ``generator`` (on that
        device): the params from ``registry.init_params`` (quantized for
        int8 weights), the AdamW state from ``optimizer.init``, the slot
        cache filled leaf by leaf in place (floats from a unit normal,
        integers in [-127, 127]: no second copy of a leaf is made), the
        tokens and labels uniform over the vocabulary, the embeddings
        from a unit normal, and every decode lane at the cache's last
        position (``pos = seq_len - 1``), so each call reads the whole
        cache."""
        device = torch.device(device)
        params = registry.init_params(self.cfg, generator)
        if self.int8_weights:
            from repro_torch.serve.quantization import quantize_tree
            params = quantize_tree(params)
        batch = {}
        for k, spec in self.abstract_args[-1].items():
            if k == "pos":
                batch[k] = torch.full(spec.shape, self.shape.seq_len - 1,
                                      dtype=spec.dtype, device=device)
            elif spec.dtype.is_floating_point:
                batch[k] = torch.randn(spec.shape, generator=generator,
                                       device=device).to(spec.dtype)
            else:
                batch[k] = torch.randint(0, self.cfg.vocab_size, spec.shape,
                                         generator=generator, device=device,
                                         dtype=spec.dtype)
        if self.shape.kind == "train":
            return params, opt.init(params), batch
        if self.shape.kind == "prefill":
            return params, batch
        cache = tree_map(lambda s: fill_(torch.empty(
            s.shape, dtype=s.dtype, device=device), generator),
            self.abstract_args[1])
        return params, cache, batch


def fill_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` in place from ``generator``: a unit normal for a float
    tensor, integers in [-127, 127] otherwise."""
    if t.is_floating_point():
        return t.normal_(generator=generator)
    return t.random_(-127, 128, generator=generator)


def batch_shardings(batch_specs, mesh) -> dict:
    return {k: sharding.resolve_spec(BATCH_AXES[k], v.shape, mesh)
            for k, v in batch_specs.items()}


def compute_params(cfg, cast_params_bf16: bool):
    """``params -> params`` the model reads: with ``cast_params_bf16`` the
    f32 masters cast to the compute dtype (1-D leaves such as norm scales
    stay f32), else the masters themselves."""
    cdt = torch_dtype(cfg.dtype)

    def model_params(params):
        if not cast_params_bf16:
            return params
        return tree_map(lambda p: p.to(cdt)
                        if p.dtype == torch.float32 and p.dim() > 1 else p,
                        params)

    return model_params


def train_step_fn(cfg, ocfg, *, microbatches: int = 1,
                  cast_params_bf16: bool = False, rules=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: loss and gradients of ``registry.loss_fn`` (summed over
    ``microbatches`` slices of the batch, then averaged), then one AdamW
    step IN PLACE on ``params`` and the moments.  With
    ``cast_params_bf16`` the f32 master params are cast to the compute
    dtype before the model reads them (norm scales and other 1-D leaves
    stay f32) and the gradients land on the f32 masters.  Metrics are
    0-d tensors on the device: {"nll", "aux", "loss", "grad_norm", "lr"}.
    ``rules`` (a rule table; by default the config's merged rules) is
    entered around the step."""
    model_params = compute_params(cfg, cast_params_bf16)
    rules = rules or sharding.merged_rules(cfg.sharding_overrides)

    def train_step(params, opt_state, batch):
        with sharding.axis_rules(rules):
            paths, leaves = zip(*tree_leaves(params))
            for t in leaves:
                t.requires_grad_(True)
            if microbatches > 1:
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + tuple(v.shape[1:]))
                      for k, v in batch.items()}
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                grads = None
                for i in range(microbatches):
                    l, _ = registry.loss_fn(model_params(params), cfg,
                                            {k: v[i] for k, v in mb.items()})
                    g = torch.autograd.grad(l, leaves)
                    loss = loss + l.detach()
                    grads = [x.float() for x in g] if grads is None else \
                        [a + x.float() for a, x in zip(grads, g)]
                inv = 1.0 / microbatches
                loss = loss * inv
                grads = [x * inv for x in grads]
                metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
            else:
                loss, metrics = registry.loss_fn(model_params(params), cfg,
                                                 batch)
                grads = [x.float()
                         for x in torch.autograd.grad(loss, leaves)]
            params, opt_state, om = opt.apply(
                ocfg, opt_state, params, tree_from_leaves(zip(paths, grads)))
            metrics = dict(metrics, loss=loss, **om)
            return params, opt_state, {k: v.detach()
                                       for k, v in metrics.items()}

    return train_step


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               opt_cfg: opt.AdamWConfig | None = None,
               *, microbatches: int = 1,
               cast_params_bf16: bool = False,
               decode_weight_stationary: bool = False,
               int8_weights: bool = False,
               rules_overrides: dict | None = None) -> Cell:
    """Build one (arch × shape × mesh) cell.  Each ``shape.kind`` has one
    step function: train — ``train_step_fn``; prefill —
    ``registry.forward`` to the logits under ``torch.no_grad()``; decode —
    ``registry.decode_step`` on the slot cache (written in place) under
    ``torch.no_grad()``, or ``registry.decode_step_q`` on int8 weights.

    Knobs (all off by default, as in JAX):

    * microbatches      — gradient accumulation over that many slices of
                          the batch;
    * cast_params_bf16  — the f32 master params cast to the compute dtype
                          before the model reads them;
    * int8_weights      — decode only: large weight matrices as
                          per-channel int8 + f32 scales
                          (``serve.quantization``);
    * decode_weight_stationary and rules_overrides change only the rule
      table (``sharding.merged_rules``): the former replicates the decode
      batch and the activation heads, as JAX's does; the latter's entries
      win.  On the port's mesh every rank lives on one device as a slice
      of the leading dim (``launch/mesh.py``), so a rule moves no tensor:
      it changes the placements the cell records and that ``shard_hint``
      checks inside the step.
    """
    rules = sharding.merged_rules(cfg.sharding_overrides)
    if decode_weight_stationary and shape.kind == "decode":
        rules.update({
            "batch": ((),),          # activations replicated over data
            "act_heads": ((),), "act_kv_heads": ((),),
        })
    if rules_overrides:
        rules.update(rules_overrides)   # explicit --rules wins
    with sharding.axis_rules(rules):
        p_shapes = registry.param_shapes(cfg)
        p_axes = registry.param_axes(cfg)
        p_shard = sharding.spec_tree(p_axes, p_shapes, mesh)
        b_specs = input_specs(cfg, shape)
        b_shard = batch_shardings(b_specs, mesh)

        if shape.kind == "train":
            ocfg = opt_cfg or opt.AdamWConfig()
            o_shapes = opt.init(p_shapes)
            o_shard = opt.AdamWState(step=(), mu=p_shard, nu=p_shard)
            step = train_step_fn(cfg, ocfg, microbatches=microbatches,
                                 cast_params_bf16=cast_params_bf16,
                                 rules=rules)
            return Cell(cfg, shape, mesh, step,
                        (p_shapes, o_shapes, b_specs),
                        (p_shard, o_shard, b_shard),
                        (p_shard, o_shard, None))

        if shape.kind == "prefill":
            def prefill_step(params, batch):
                with sharding.axis_rules(rules), torch.no_grad():
                    logits, _ = registry.forward(params, cfg, batch)
                    return logits

            return Cell(cfg, shape, mesh, prefill_step, (p_shapes, b_specs),
                        (p_shard, b_shard), None)

        if shape.kind == "decode":
            c_shapes = registry.cache_shapes(cfg, shape.global_batch,
                                             shape.seq_len)
            c_axes = registry.cache_axes(cfg, shape.global_batch,
                                         shape.seq_len)
            c_shard = sharding.spec_tree(c_axes, c_shapes, mesh)
            if int8_weights:
                from repro_torch.serve import quantization as QZ
                qp_shapes = QZ.quantized_shapes(p_shapes)
                qp_shard = sharding.spec_tree(
                    QZ.quantized_axes(p_axes, p_shapes), qp_shapes, mesh)

                def serve_step_q(qparams, cache, batch):
                    with sharding.axis_rules(rules), torch.no_grad():
                        return registry.decode_step_q(
                            qparams, cfg, cache, batch["tokens"],
                            batch["pos"])

                return Cell(cfg, shape, mesh, serve_step_q,
                            (qp_shapes, c_shapes, b_specs),
                            (qp_shard, c_shard, b_shard), (None, c_shard),
                            int8_weights=True)

            def serve_step(params, cache, batch):
                with sharding.axis_rules(rules), torch.no_grad():
                    return registry.decode_step(
                        params, cfg, cache, batch["tokens"], batch["pos"])

            return Cell(cfg, shape, mesh, serve_step,
                        (p_shapes, c_shapes, b_specs),
                        (p_shard, c_shard, b_shard), (None, c_shard))

    raise ValueError(shape.kind)

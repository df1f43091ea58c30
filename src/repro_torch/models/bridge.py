"""Carry parameter, cache and optimizer-state trees across from the JAX
package.

The JAX package keeps its parameters as nested dicts of arrays with the
stacked ``layers`` axis; the port keeps the same tree of tensors.  The
trees cross as numpy (``jax.tree.map(np.asarray, params)`` on the JAX
side), so the port never imports JAX.  ``params_on_model_axis`` places
such a tree (or the port's own) on a (data, model) mesh with a device per
rank, as the train launcher's model axis holds it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.layers import expert_width_dims, tree_from_leaves, \
    tree_leaves, tree_map


def _tensor(a, device) -> torch.Tensor:
    # a copy: the port writes its pool in place, and np.asarray of a JAX
    # array is a read-only view of JAX's own buffer
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":          # ml_dtypes' bf16: same bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _leaf(a, device):
    # the JAX package's QuantizedTensor after jax.tree.map(np.asarray, ...)
    # is still a (q, scale) named tuple: it becomes the port's
    if getattr(a, "_fields", None) == ("q", "scale"):
        from repro_torch.serve.quantization import QuantizedTensor
        return QuantizedTensor(_tensor(a.q, device), _tensor(a.scale, device))
    return _tensor(a, device)


def params_from_numpy(tree, device=None) -> dict:
    """Nested dict of numpy arrays -> the same dict of tensors on
    ``device`` (default ``cuda``).  Padded heads and an untied
    ``lm_head`` are leaves like any other; int8 weights
    (``quantize_tree``'s (q, scale) pairs) become the port's
    ``QuantizedTensor``."""
    dev = resolve_device(device)
    return tree_map(lambda a: _leaf(a, dev), tree)


def cache_from_numpy(tree, device=None) -> dict:
    """A slot cache or paged pool ({"k", "v"}, and with int8 K/V also
    {"k_scale", "v_scale"}; or the ssm family's state) from numpy, as
    ``params_from_numpy``."""
    return params_from_numpy(tree, device)


def opt_state_from_numpy(state, device=None):
    """An AdamW state (step, mu, nu) from numpy — the JAX package's
    ``AdamWState`` after ``jax.tree.map(np.asarray, ...)``, or any triple
    in that order — as the port's ``train.optimizer.AdamWState`` on
    ``device`` (default ``cuda``); the step is an int32 scalar tensor and
    the moments f32."""
    from repro_torch.train.optimizer import AdamWState
    step, mu, nu = state
    dev = resolve_device(device)
    moments = lambda tree: tree_map(  # noqa: E731
        lambda a: _tensor(a, dev).float(), tree)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        mu=moments(mu), nu=moments(nu))


def params_on_model_axis(tree, cfg, mesh) -> dict:
    """A parameter tree (tensors, or numpy arrays as ``params_from_numpy``
    takes them) placed on a ``(data, model)`` mesh of D x M ranks with a
    device per rank, rank (d, m) on ``mesh.devices[d*M + m]``: the leaves
    the model axis splits along the expert width
    (``layers.expert_width_dims``: the MoE block's ``wi_gate``, ``wi_up``
    and ``wo`` when it takes its tensor-parallel block) as F-slices, rank
    (d, m) holding slice m (``RankShards`` blocks split on F, a copy per
    data row), and every other leaf as a replica on each row's leader,
    rank (d, 0)."""
    from repro_torch.collectives.rank_shards import RankShards, replicate
    D, M = dict(mesh.shape)["data"], dict(mesh.shape)["model"]
    dims = expert_width_dims(cfg, M)
    leaders = mesh.devices[::M]

    def place(path, leaf):
        t = leaf if isinstance(leaf, torch.Tensor) else _tensor(leaf, "cpu")
        if path in dims:
            return RankShards.from_stacked(t, mesh, copies=D, dim=dims[path])
        return replicate(t, leaders)

    return tree_from_leaves((path, place(path, leaf))
                            for path, leaf in tree_leaves(tree))

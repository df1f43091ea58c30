"""Loss functions (the plain path of the JAX package's ``train/losses.py``;
``chunked_vocab_xent`` is not ported yet)."""
from __future__ import annotations

import torch


def plain_xent(logits, labels):
    """logits [B,S,V] f32; labels [B,S] -> mean nll."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)

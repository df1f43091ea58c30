"""Loss functions, including the vocab-chunked cross entropy (the JAX
package's ``train/losses.py``).

The plain LM loss materializes f32 logits [B, S, V] (for qwen2's 152k
vocab at 8 × 1024 tokens that is 5 GB, and its gradient as much again).
``chunked_vocab_xent`` walks the vocabulary in blocks with a running
(max, sum-exp, gold-logit) triple — the online softmax applied to the
unembedding — so the largest intermediate is [B, S, chunk]; its backward
recomputes each block's logits, one extra unembedding product for
1/n_chunks of the activations.
"""
from __future__ import annotations

import torch


def plain_xent(logits, labels):
    """logits [B,S,V] f32; labels [B,S] -> mean nll."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(lse - gold)


def _vchunks(table, chunk, transpose_table):
    V = table.shape[-1] if transpose_table else table.shape[0]
    chunk = min(chunk, V)
    n = (V + chunk - 1) // chunk
    return V, chunk, n


def _table_chunk(table, start, chunk, V, transpose_table):
    """Rows (columns when transposed) ``start:start+chunk`` of the table,
    the last chunk padded with zeros to ``chunk``: the JAX package pads
    the whole table to n·chunk, which gives this chunk."""
    end = min(start + chunk, V)
    t = table[:, start:end] if transpose_table else table[start:end]
    if end - start < chunk:
        pad = chunk - (end - start)
        t = torch.nn.functional.pad(
            t, (0, pad) if transpose_table else (0, 0, 0, pad))
    return t


def _logits_chunk(x, t, transpose_table):
    """[B,S,chunk] f32: the product in x's dtype, then cast (in bf16 the
    logits round to bf16 first, as the JAX ``einsum(...).astype(f32)``)."""
    t = t.to(x.dtype)
    return torch.matmul(x, t if transpose_table else t.t()).float()


class _ChunkedVocabXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, labels, chunk, transpose_table):
        V, chunk, n = _vchunks(table, chunk, transpose_table)
        B, S, _ = x.shape
        m = torch.full((B, S), -torch.inf, dtype=torch.float32,
                       device=x.device)
        s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
        gold = torch.zeros((B, S), dtype=torch.float32, device=x.device)
        for i in range(n):
            start = i * chunk
            lg = _logits_chunk(x, _table_chunk(table, start, chunk, V,
                                               transpose_table),
                               transpose_table)
            # mask the padded rows of the final chunk
            vids = start + torch.arange(chunk, device=x.device)
            lg = torch.where(vids < V, lg, -torch.inf)
            m_new = torch.maximum(m, lg.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.sum(
                torch.exp(lg - m_new[..., None]), dim=-1)
            in_chunk = (labels >= start) & (labels < start + chunk)
            idx = torch.clamp(labels - start, 0, chunk - 1).long()
            g = torch.gather(lg, -1, idx[..., None])[..., 0]
            gold = torch.where(in_chunk, g, gold)
            m = m_new
        lse = m + torch.log(s)
        ctx.save_for_backward(x, table, labels, lse)
        ctx.chunk, ctx.transpose_table = chunk, transpose_table
        return torch.mean(lse - gold)

    @staticmethod
    def backward(ctx, dnll):
        x, table, labels, lse = ctx.saved_tensors
        tr = ctx.transpose_table
        V, chunk, n = _vchunks(table, ctx.chunk, tr)
        B, S, _ = x.shape
        scale = dnll / (B * S)
        xf = x.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dt = torch.zeros(table.shape, dtype=torch.float32, device=x.device)
        for i in range(n):
            start = i * chunk
            t = _table_chunk(table, start, chunk, V, tr)
            lg = _logits_chunk(x, t, tr)
            vids = start + torch.arange(chunk, device=x.device)
            p = torch.exp(lg - lse[..., None])
            p = torch.where(vids < V, p, 0.0)
            onehot = (labels[..., None] == vids).float()
            dlg = (p - onehot) * scale                        # [B,S,chunk]
            tf = t.float()
            end = min(start + chunk, V)
            if tr:
                dx = dx + torch.einsum("bsv,dv->bsd", dlg, tf)
                dt[:, start:end] = torch.einsum(
                    "bsd,bsv->dv", xf, dlg)[:, :end - start]
            else:
                dx = dx + torch.einsum("bsv,vd->bsd", dlg, tf)
                dt[start:end] = torch.einsum(
                    "bsv,bsd->vd", dlg, xf)[:end - start]
        return dx.to(x.dtype), dt.to(table.dtype), None, None, None


def chunked_vocab_xent(x, table, labels, chunk: int = 8192,
                       transpose_table: bool = False):
    """mean nll of softmax(x @ table) without materializing full logits.

    x: [B,S,D] (final hidden states, any float dtype);
    table: [V,D] (tied embeddings) or [D,V] if transpose_table;
    labels: [B,S] int.  The backward adds the chunks' ``dx`` in chunk
    order and writes each block of ``dtable`` once, as the JAX
    ``custom_vjp`` does."""
    return _ChunkedVocabXent.apply(x, table, labels, chunk, transpose_table)

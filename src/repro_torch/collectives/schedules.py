"""User-level collective algorithms as explicit point-to-point schedules,
in the rank-stacked form (the port of the JAX package's
``collectives/schedules.py``).

The JAX package writes each algorithm as ``ppermute`` steps inside
``shard_map``: every device runs the same program on its own shard and
``jax.lax.axis_index`` tells it which rank it is.  The port runs all the
ranks of an axis in one process on one device: a payload ``v`` is
``[n, *local]``, rank ``r``'s shard in row ``r``.  So

* ``axis_index`` is the rank vector ``torch.arange(n)``;
* ``ppermute(v, axis, perm)`` is ``out[dst] = v[src]`` over the leading
  dim: ``ring_shift`` for a ring hop, ``xor_exchange`` for XOR partners
  (the only permutations the schedules use);
* the per-rank chunk reads and writes (``_take_chunk``/``_set_chunk``)
  are gathers and scatters with one index per rank (``take_block``/
  ``put_block``).

Each rank's adds come in the JAX order (own + received, round by round):
nothing sums over the rank dimension in one call, so a schedule gives
the JAX schedule's result bit for bit.

On a mesh with one device per rank the payload is a ``RankShards``
(``rank_shards``): shard ``r`` is row ``r`` of the stacked carry, on rank
``r``'s device.  Every primitive below has a per-shard branch, chosen by
the payload's type: a hop is ``dst.copy_(src, non_blocking=True)`` into
the receiving rank's buffer on its device, a rank's block index is a
host ``int`` (the device index tables are not used), and each rank adds
own + received with the same ops in the same order, so the two forms
give the same bits in every dtype.  The schedules are written once over
both: shape-only steps go through ``rank_shards.local``.

Implemented schedules (every one ``[n, *local] -> [n, *local']``):
``recursive_doubling_allreduce`` (the paper's Listing 1.8),
``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_allreduce``,
``bidirectional_ring_allreduce``, ``recursive_halving_doubling_allreduce``
and its two phases alone, and ``bruck_alltoall``.
"""
from __future__ import annotations

import threading
import warnings

import torch
import torch.nn.functional as F

from repro_torch.collectives.rank_shards import RankShards, global_view, \
    local, ranks_view


def ring_perm(n: int, *, reverse: bool = False) -> list:
    """The permutation of one ring hop over ``n`` ranks: forward is
    ``[(i, (i+1) % n)]`` (each rank sends to its successor)."""
    d = -1 if reverse else 1
    return [(i, (i + d) % n) for i in range(n)]


# ---------------------------------------------------------------------------
# Primitives (rank-stacked tensors, or RankShards: one shard per rank)
# ---------------------------------------------------------------------------

def _empty_like(v):
    return local(torch.empty_like, v)


def add(a, b, out=None):
    """``a + b`` for every rank (own + received), into ``out`` when
    given."""
    if isinstance(a, RankShards):
        outs = out.shards if out is not None else (None,) * len(a)
        return RankShards(torch.add(x, y, out=o)
                          for x, y, o in zip(a.shards, b.shards, outs))
    return torch.add(a, b, out=out)


def ring_shift(v, d: int, out=None):
    """One ring hop of ``d``: ``out[(i + d) % n] = v[i]``."""
    if isinstance(v, RankShards):
        n = len(v)
        if out is None:
            out = _empty_like(v)
        for i in range(n):
            out.shards[(i + d) % n].copy_(v.shards[i], non_blocking=True)
        return out
    n = v.shape[0]
    d %= n
    if out is None:
        out = torch.empty_like(v)
    if d == 0:
        return out.copy_(v)
    out[d:].copy_(v[:n - d])
    out[:d].copy_(v[n - d:])
    return out


def xor_exchange(v, mask: int, out=None):
    """The XOR-partner exchange: ``out[i] = v[i ^ mask]``."""
    if isinstance(v, RankShards):
        if out is None:
            out = _empty_like(v)
        for i, o in enumerate(out.shards):
            o.copy_(v.shards[i ^ mask], non_blocking=True)
        return out
    n = v.shape[0]
    if out is None:
        out = torch.empty_like(v)
    src = v.unflatten(0, (n // (2 * mask), 2, mask))
    dst = out.unflatten(0, (n // (2 * mask), 2, mask))
    dst[:, 0].copy_(src[:, 1])
    dst[:, 1].copy_(src[:, 0])
    return out


_tables: dict = {}
_tables_lock = threading.Lock()


def _cached_table(kind, n: int, device, build):
    """Small per-rank index tables, made on the device by the stream that
    uses them (so no copy from the host, and no other stream can read one
    before it is written) and kept for reuse."""
    device = torch.device(device)
    sid = torch.cuda.current_stream(device).cuda_stream \
        if device.type == "cuda" else None
    key = (kind, n, device, sid)
    table = _tables.get(key)
    if table is None:
        table = build(torch.arange(n, device=device))
        with _tables_lock:
            table = _tables.setdefault(key, table)
    return table


def rank_offsets(n: int, device) -> torch.Tensor:
    """``T[c, r] = (r + c) % n``: row ``c`` is each rank's block index at
    offset ``c`` from its own rank (``(axis_index + c) % n``)."""
    return _cached_table("offsets", n, device,
                         lambda a: (a[None, :] + a[:, None]) % n)


def rank_back(n: int, device) -> torch.Tensor:
    """``U[r, k] = (r - k) % n`` (Bruck's inverse rotation)."""
    return _cached_table("back", n, device,
                         lambda a: (a[:, None] - a[None, :]) % n)


def bruck_mask(n: int, step: int, device) -> torch.Tensor:
    """Bruck round ``step``: which block slots move (bit ``step`` set)."""
    return _cached_table(("bruck", step), n, device,
                         lambda a: ((a // step) % 2 == 1))


def rank_row(n: int, c: int, like):
    """Row ``c`` of ``rank_offsets`` for ``like``'s form: each rank's block
    index ``(r + c) % n``, as a device row for a stacked payload and as
    host ints for a ``RankShards``."""
    if isinstance(like, RankShards):
        return tuple((r + c) % n for r in range(n))
    return rank_offsets(n, like.device)[c]


def _block_index(chunks: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    n = chunks.shape[0]
    return pos.view((n,) + (1,) * (chunks.dim() - 1)).expand(
        chunks.shape[:-2] + (1, chunks.shape[-1]))


def take_block(chunks, pos, out=None):
    """chunks ``[n, ..., nb, m]``, pos ``[n]`` -> ``[n, ..., m]``: rank r
    reads its block ``pos[r]`` (only the m-wide block, one gather)."""
    if isinstance(chunks, RankShards):
        parts = [c.select(-2, p) for c, p in zip(chunks.shards, pos)]
        if out is None:
            return RankShards(p.clone(memory_format=torch.contiguous_format)
                              for p in parts)
        for o, p in zip(out.shards, parts):
            o.copy_(p)
        return out
    idx = _block_index(chunks, pos)
    if out is None:
        return torch.gather(chunks, -2, idx).squeeze(-2)
    torch.gather(chunks, -2, idx, out=out.unsqueeze(-2))
    return out


def put_block(out, cur, pos):
    """out ``[n, ..., nb, m]`` <- cur ``[n, ..., m]`` at block ``pos[r]``
    of each rank r (in place)."""
    if isinstance(out, RankShards):
        for o, c, p in zip(out.shards, cur.shards, pos):
            o.select(-2, p).copy_(c)
        return out
    return out.scatter_(-2, _block_index(out, pos), cur.unsqueeze(-2))


def halve(cur, mask: int, out=None):
    """One recursive-halving round: each rank keeps the half its rank bit
    ``mask`` selects (hi when set), ships the other half to its XOR
    partner and adds what it receives: ``mine + recv``."""
    h = cur.shape[-1] // 2
    if out is None:
        out = local(lambda t: t.new_empty(t.shape[:-1] + (h,)), cur)
    if isinstance(cur, RankShards):
        for r, o in enumerate(out.shards):
            sl = slice(h, 2 * h) if r & mask else slice(0, h)
            o.copy_(cur.shards[r ^ mask][..., sl], non_blocking=True)
            torch.add(cur.shards[r][..., sl], o, out=o)
        return out
    n = cur.shape[0]
    v = cur.unflatten(0, (n // (2 * mask), 2, mask))
    o = out.unflatten(0, (n // (2 * mask), 2, mask))
    torch.add(v[:, 0, ..., :h], v[:, 1, ..., :h], out=o[:, 0])
    torch.add(v[:, 1, ..., h:], v[:, 0, ..., h:], out=o[:, 1])
    return out


def double(cur, mask: int, out=None):
    """One recursive-doubling round: exchange with the XOR partner and
    concatenate in rank-bit order (both partners end with [lo | hi])."""
    w = cur.shape[-1]
    if out is None:
        out = local(lambda t: t.new_empty(t.shape[:-1] + (2 * w,)), cur)
    if isinstance(cur, RankShards):
        for r, o in enumerate(out.shards):
            mine, theirs = (slice(w, 2 * w), slice(0, w)) if r & mask \
                else (slice(0, w), slice(w, 2 * w))
            o[..., mine].copy_(cur.shards[r])
            o[..., theirs].copy_(cur.shards[r ^ mask], non_blocking=True)
        return out
    n = cur.shape[0]
    v = cur.unflatten(0, (n // (2 * mask), 2, mask))
    o = out.unflatten(0, (n // (2 * mask), 2, mask))
    o[..., :w].copy_(v[:, :1])
    o[..., w:].copy_(v[:, 1:])
    return out


def rotate_blocks(x, out=None):
    """Bruck's first step: ``y[r, k] = x[r, (r + k) % n]`` over the local
    block dim (dim 1 of the stacked carry)."""
    n = x.shape[0]
    if isinstance(x, RankShards):
        if out is None:
            out = _empty_like(x)
        for r, (t, o) in enumerate(zip(x.shards, out.shards)):
            o[:, :n - r].copy_(t[:, r:])
            o[:, n - r:].copy_(t[:, :r])
        return out
    idx = rank_offsets(n, x.device)
    idx = idx.view(idx.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 1, idx, out=out)


def unrotate_blocks(x):
    """Bruck's last step: ``y[r, k] = x[r, (r - k) % n]``."""
    n = x.shape[0]
    if isinstance(x, RankShards):
        out = _empty_like(x)
        for r, (t, o) in enumerate(zip(x.shards, out.shards)):
            o[:, :r + 1].copy_(t[:, :r + 1].flip(1))
            o[:, r + 1:].copy_(t[:, r + 1:].flip(1))
        return out
    idx = rank_back(n, x.device)
    return torch.gather(x, 1, idx.view(
        idx.shape + (1,) * (x.dim() - 2)).expand(x.shape))


def bruck_select(x, moved, step: int, out=None):
    """Bruck round ``step``: the block slots with bit ``step`` set take
    ``moved``'s, the others keep ``x``'s; a fresh result, or ``x`` itself
    updated in place when ``out`` is ``x``."""
    n = x.shape[0]
    if isinstance(x, RankShards):
        if out is None:
            out = local(torch.clone, x)
        for m, o in zip(moved.shards, out.shards):
            for a in range(step, n, 2 * step):
                o[:, a:a + step].copy_(m[:, a:a + step])
        return out
    sel = bruck_mask(n, step, x.device).view((1, n) + (1,) * (x.dim() - 2))
    return torch.where(sel, moved, x, out=out)


def _check_pow2(n: int, what: str) -> None:
    if n & (n - 1):
        raise ValueError(f"{what} requires power-of-two size, got {n}")


# ---------------------------------------------------------------------------
# Recursive doubling (paper Listing 1.8)
# ---------------------------------------------------------------------------

def recursive_doubling_allreduce(x):
    """The paper's user-level allreduce: XOR-partner exchange, log2 P
    rounds.  Requires a power-of-two rank count (as the paper asserts)."""
    n = x.shape[0]
    _check_pow2(n, "recursive doubling")
    mask = 1
    while mask < n:
        x = add(x, xor_exchange(x, mask))
        mask <<= 1
    return x


# ---------------------------------------------------------------------------
# Ring schedules
# ---------------------------------------------------------------------------

def _pad_last(x, n: int):
    D = x.shape[-1]
    if D % n:
        return local(lambda t: F.pad(t, (0, n - D % n)), x), D
    return x, D


def ring_reduce_scatter(x, *, reverse: bool = False):
    """P-1 neighbour steps; rank r ends with its reduced [..., D/P]
    block (where ``ring_all_gather`` expects it)."""
    n = x.shape[0]
    if n == 1:
        return x
    D = x.shape[-1]
    assert D % n == 0, (D, n)
    chunks = local(lambda t: t.reshape(t.shape[:-1] + (n, D // n)), x)
    d = -1 if reverse else 1
    acc = take_block(chunks, rank_row(n, -d % n, x))
    for step in range(1, n):
        acc = add(ring_shift(acc, d),
                  take_block(chunks, rank_row(n, (-d * (1 + step)) % n, x)))
    return acc


def ring_all_gather(x, *, reverse: bool = False):
    """All-gather each rank's [..., d] -> [..., P*d] in P-1 ring steps."""
    n = x.shape[0]
    if n == 1:
        return x
    d = -1 if reverse else 1
    out = local(lambda t: t.new_zeros(t.shape[:-1] + (n, t.shape[-1])), x)
    cur = x
    for step in range(n):
        put_block(out, cur, rank_row(n, (-d * step) % n, x))
        if step != n - 1:
            cur = ring_shift(cur, d)
    return local(lambda t: t.reshape(t.shape[:-2] + (n * t.shape[-1],)),
                 out)


def ring_allreduce(x, *, reverse: bool = False):
    """reduce-scatter + all-gather: the bandwidth-optimal allreduce."""
    n = x.shape[0]
    if n == 1:
        return x
    xp, D = _pad_last(x, n)
    full = ring_all_gather(ring_reduce_scatter(xp, reverse=reverse),
                           reverse=reverse)
    return local(lambda t: t[..., :D], full)


def bidirectional_ring_allreduce(x):
    """Opposing rings over the two halves of the vector."""
    if x.shape[0] == 1:
        return x
    half = x.shape[-1] // 2
    lo = ring_allreduce(local(lambda t: t[..., :half], x), reverse=False)
    hi = ring_allreduce(local(lambda t: t[..., half:], x), reverse=True)
    return local(lambda a, b: torch.cat([a, b], dim=-1), lo, hi)


# ---------------------------------------------------------------------------
# Recursive halving/doubling
# ---------------------------------------------------------------------------

def recursive_halving_reduce_scatter(x):
    """Reduce-scatter by recursive halving: log2 P rounds, rank r ends
    with its own contiguous block (as ``ring_reduce_scatter``)."""
    n = x.shape[0]
    _check_pow2(n, "recursive halving")
    if n == 1:
        return x
    assert x.shape[-1] % n == 0, (x.shape[-1], n)
    mask = n >> 1
    while mask >= 1:
        x = halve(x, mask)
        mask >>= 1
    return x


def recursive_doubling_all_gather(x):
    """All-gather by recursive doubling, in native rank order."""
    n = x.shape[0]
    _check_pow2(n, "recursive doubling")
    mask = 1
    while mask < n:
        x = double(x, mask)
        mask <<= 1
    return x


def recursive_halving_doubling_allreduce(x):
    """Ring traffic (2·(P-1)/P·bytes) in 2·log2 P steps."""
    n = x.shape[0]
    _check_pow2(n, "halving/doubling")
    if n == 1:
        return x
    xp, D = _pad_last(x, n)
    out = recursive_doubling_all_gather(recursive_halving_reduce_scatter(xp))
    return local(lambda t: t[..., :D], out)


# ---------------------------------------------------------------------------
# Bruck all-to-all (MoE dispatch)
# ---------------------------------------------------------------------------

def bruck_alltoall(x):
    """All-to-all over each rank's leading block dim in ceil(log2 P)
    rounds: x ``[P, P, ...]``; ``y[i, j] = x[j, i]`` (MPI_Alltoall)."""
    n = x.shape[0]
    if n == 1:
        return x
    x = rotate_blocks(x)
    step = 1
    while step < n:
        x = bruck_select(x, ring_shift(x, step), step)
        step <<= 1
    return unrotate_blocks(x)


# ---------------------------------------------------------------------------
# The algorithm table and its eager validation
# ---------------------------------------------------------------------------

ALGORITHMS = {
    "ring": ring_allreduce,
    "bidir": bidirectional_ring_allreduce,
    "recursive_doubling": recursive_doubling_allreduce,
    "halving_doubling": recursive_halving_doubling_allreduce,
}

# algorithms whose XOR-partner exchange only works for power-of-two sizes
POW2_ONLY = frozenset({"recursive_doubling", "halving_doubling"})


def resolve_algorithm(algorithm: str, axis_size: int, *,
                      fallback: str = "ring") -> str:
    """Eager validation of (algorithm, axis size): unknown names raise;
    power-of-two-only algorithms on another size fall back to
    ``fallback`` with a warning."""
    if algorithm not in ALGORITHMS:
        raise ValueError(f"unknown allreduce algorithm {algorithm!r}; "
                         f"options: {sorted(ALGORITHMS)}")
    if algorithm in POW2_ONLY and axis_size & (axis_size - 1):
        warnings.warn(
            f"{algorithm} allreduce requires a power-of-two axis size, "
            f"got {axis_size}; falling back to {fallback!r}",
            RuntimeWarning, stacklevel=3)
        return fallback
    return algorithm


# rs/ag decompose only for the algorithms that contain such a phase
RS_AG_ALGORITHMS = frozenset({"ring", "halving_doubling"})


def resolve_rs_ag_algorithm(algorithm: str, axis_size: int, *,
                            op: str = "reduce_scatter") -> str:
    """As ``resolve_algorithm``, and names with no rs/ag phase
    (``bidir``, ``recursive_doubling``) fall back to ring with a
    warning."""
    algorithm = resolve_algorithm(algorithm, axis_size)
    if algorithm not in RS_AG_ALGORITHMS:
        warnings.warn(
            f"{algorithm} has no {op} decomposition (options: "
            f"{sorted(RS_AG_ALGORITHMS)}); falling back to 'ring'",
            RuntimeWarning, stacklevel=3)
        return "ring"
    return algorithm


# ---------------------------------------------------------------------------
# Round batching (persistent schedules; see collectives/nonblocking.py)
# ---------------------------------------------------------------------------

ROUND_BATCH_SMALL_BYTES = 4 << 20        # <= 4 MiB: fuse everything
ROUND_BATCH_LARGE_BYTES = 64 << 20       # <= 64 MiB: two dispatches


def fuse_rounds(fns):
    """Compose consecutive round bodies into one dispatch: plain
    sequential composition (extra arguments, such as a round's workspace,
    pass to every body), so the fused rounds run the same ops in the
    same order as the unfused ones."""
    fns = tuple(fns)
    if not fns:
        raise ValueError("fuse_rounds on empty round list")
    if len(fns) == 1:
        return fns[0]

    def fused(carry, *args):
        for fn in fns:
            carry = fn(carry, *args)
        return carry

    return fused


def auto_round_batch(payload_bytes: int, num_rounds: int) -> int:
    """The round-batch factor from the payload size: small payloads
    collapse to 1–2 dispatches per chunk, large ones keep per-round
    dispatch so chunks pipeline."""
    if num_rounds <= 1:
        return 1
    if payload_bytes <= ROUND_BATCH_SMALL_BYTES:
        return num_rounds
    if payload_bytes <= ROUND_BATCH_LARGE_BYTES:
        return -(-num_rounds // 2)
    return 1


def allreduce_under_shard_map(x, mesh, axis: str, algorithm: str = "ring"):
    """Allreduce ``x`` (its leading dim sharded over ``axis``; a tensor,
    or a ``RankShards`` on a mesh with a device per rank) with a user
    schedule; the output is sharded the same way — comparable with a
    plain sum.  Power-of-two-only algorithms fall back to ring with a
    warning on other sizes."""
    n = dict(mesh.shape)[axis]
    algorithm = resolve_algorithm(algorithm, n)
    return global_view(ALGORITHMS[algorithm](ranks_view(x, n)))

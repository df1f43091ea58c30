"""User-level collectives (paper §4.7) — the port's import surface, as
the JAX package's ``repro.collectives`` (without the FSDP classes yet).

* ``CollectiveSpec`` — the frozen config record (backend, algorithm,
  chunks, round_batch) every surface takes: ``TrainLoopConfig``,
  ``UserCollectiveStep``, the train launcher, every factory below.
* one-shot nonblocking ops: ``iallreduce`` / ``ireduce_scatter`` /
  ``iallgather`` / ``ialltoall`` ``(x, mesh, axis, *, spec=None, ...)``.
* persistent handle factories: ``allreduce_init`` /
  ``reduce_scatter_init`` / ``allgather_init`` / ``alltoall_init`` and
  the p2p family ``channel_init`` / ``send_init`` / ``recv_init``, all
  ``(like, mesh, axis, *, spec=None, epoch=None, stream=None,
  engine=None, ...)``.
* overlap machinery: ``EngineGradReducer`` (replicated gradients) and
  the ZeRO-sharded ``FsdpReducer`` / ``FsdpLayout``.
* ``ring_attention`` — context parallelism: the sequence split over the
  model axis of the current mesh, key/value blocks circulating on a ring
  (importable from here; not in ``__all__``, which is the JAX package's).

Meshes come from ``repro_torch.launch.mesh``: every rank of an axis lives
on the mesh's one device and a payload is rank-stacked on its leading
dim, or each rank lives on a device of its own and a payload is a
``RankShards`` (``rank_shards``; importable from here, not in
``__all__``).  ``schedules`` is re-exported as ``S``.
"""
from repro_torch.collectives import schedules as S
from repro_torch.collectives.nonblocking import (
    CollectiveRequest,
    CollectiveSpec,
    MembershipEpoch,
    MembershipError,
    PersistentCollective,
    UserCollectives,
    allgather_init,
    allreduce_init,
    alltoall_init,
    default_collectives,
    iallgather,
    iallreduce,
    ialltoall,
    ireduce_scatter,
    reduce_scatter_init,
    spec_from_legacy,
)
from repro_torch.collectives.overlap import (
    EngineGradReducer,
    FsdpGather,
    FsdpLayout,
    FsdpReducer,
    FsdpReduction,
)
from repro_torch.collectives.p2p import (
    P2P,
    P2PChannel,
    PersistentRecv,
    PersistentSend,
    channel_init,
    default_p2p,
    recv_init,
    send_init,
)
# importable from here, but kept out of ``__all__``, which mirrors the
# JAX package's surface (it exports no ring)
from repro_torch.collectives.rank_shards import RankShards  # noqa: F401
from repro_torch.collectives.ring_attention import ring_attention  # noqa: F401

__all__ = [
    "S",
    "CollectiveRequest", "CollectiveSpec", "MembershipEpoch",
    "MembershipError", "PersistentCollective", "UserCollectives",
    "spec_from_legacy", "default_collectives",
    "iallreduce", "ireduce_scatter", "iallgather", "ialltoall",
    "allreduce_init", "reduce_scatter_init", "allgather_init",
    "alltoall_init",
    "EngineGradReducer",
    "FsdpGather", "FsdpLayout", "FsdpReducer", "FsdpReduction",
    "P2P", "P2PChannel", "PersistentRecv", "PersistentSend",
    "default_p2p", "channel_init", "send_init", "recv_init",
]

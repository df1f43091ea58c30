"""The paper's progress extensions, as a Python/PyTorch runtime layer.

Stdlib copies of the JAX package's ``core`` modules (same public names and
semantics), plus ``torch_future``, which polls a CUDA event."""
from repro_torch.core.engine import (
    DONE,
    NOPROGRESS,
    PENDING,
    AsyncThing,
    ProgressEngine,
    Stream,
    Subsystem,
    global_engine,
    reset_global_engine,
)
from repro_torch.core.request import (
    CancelledError,
    CompletionCounter,
    GeneralizedRequest,
    PollRequest,
    Request,
    request_of,
)
from repro_torch.core.executor import ProgressExecutor
from repro_torch.core.task_class import TaskGraph, TaskQueue
from repro_torch.core.events import CompletionWatcher, EventQueue
from repro_torch.core.futures import chain, io_future, torch_future
from repro_torch.core.continuations import (
    DEFERRED,
    INLINE,
    Continuation,
    ContinuationQueue,
)
from repro_torch.core import stats
from repro_torch.core import debug
from repro_torch.core.debug import (
    HANDLES,
    LOCK_GRAPH,
    HandleTracker,
    LifecycleError,
    LockOrderError,
    LockOrderGraph,
    OrderedLock,
    debug_enabled,
    set_debug,
)

__all__ = [
    "DONE", "NOPROGRESS", "PENDING",
    "AsyncThing", "ProgressEngine", "Stream", "Subsystem",
    "global_engine", "reset_global_engine",
    "CancelledError", "CompletionCounter", "GeneralizedRequest",
    "PollRequest", "Request", "request_of",
    "ProgressExecutor",
    "TaskGraph", "TaskQueue",
    "CompletionWatcher", "EventQueue",
    "INLINE", "DEFERRED", "Continuation", "ContinuationQueue",
    "chain", "io_future", "torch_future",
    "stats",
    "debug", "debug_enabled", "set_debug",
    "OrderedLock", "LockOrderError", "LockOrderGraph", "LOCK_GRAPH",
    "HandleTracker", "LifecycleError", "HANDLES",
]

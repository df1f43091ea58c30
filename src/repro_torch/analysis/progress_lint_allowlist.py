"""Deliberate exceptions to the progress-safety lint over the port
(``src/repro_torch``), as plain data.

The lint itself is the JAX package's (``repro.analysis.progress_lint``),
run by ``tests/test_torch_lint.py``: its ``apply_allowlist`` matches an
entry by rule, path suffix and enclosing symbol (``qual``; ``"*"``
matches any), and every entry carries a written ``why``.  The port's
entries excuse the same ``done()``-guarded harvests as the JAX package's
own allowlist, at the port's paths.
"""

ALLOWLIST = (
    {"rule": "PL001", "path": "repro_torch/core/futures.py", "qual": "poll",
     "why": "fut.result() runs strictly after fut.done() returned True "
            "(io_future/chain polls), so it returns immediately — it only "
            "harvests a completed concurrent.futures result, it never "
            "parks the progress thread"},
    {"rule": "PL001", "path": "repro_torch/data/pipeline.py",
     "qual": "PrefetchPipeline._poll",
     "why": "same done()-guarded harvest: the subsystem poll checks "
            "fut.done() and bails with NOPROGRESS otherwise; result() on "
            "a done future is a non-blocking fetch of the filled batch"},
)

"""Analysis of the port: the dry run's counts (``opcount``), the H100
roofline (``roofline``), the report of the dry run's records (``report``)
and the progress-safety lint (``progress_lint``, with its allowlist)."""

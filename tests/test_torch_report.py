"""The port's report (``analysis/report.py``) against the JAX package's:
the same text for the same records — the port's own dry-run records
(ok, skipped and failed cells) and records shaped as the JAX dry run
writes them — and its command line over a records file."""
import json

import pytest

from repro.analysis import report as jax_report
from repro_torch.analysis import report
from repro_torch.launch import dryrun


@pytest.fixture(scope="module")
def rows():
    recs = [dryrun.run_cell("qwen2-0.5b", "decode_32k", mesh)
            for mesh in ("1x1", "16x16", "2x16x16")]
    recs.append(dryrun.run_cell("qwen2-0.5b", "long_500k", "16x16"))
    recs.append(dryrun.run_cell("zamba2-1.2b", "long_500k", "1x1"))
    recs.append({"arch": "c", "shape": "train_4k", "mesh": "16x16",
                 "status": "error", "error": "boom"})
    # a record as the JAX dry run writes it
    recs.append({
        "arch": "a", "shape": "train_4k", "mesh": "16x16", "status": "ok",
        "compile_s": 1.0, "memory": {"bytes_in_use_per_device": 1e9},
        "roofline": {"dominant": "compute", "compute_s": 0.5,
                     "memory_s": 0.1, "collective_s": 0.2,
                     "roofline_fraction": 0.5, "useful_ratio": 0.6,
                     "flops_per_device": 1e12,
                     "coll_by_type": {"all-reduce": 1e9}}})
    return recs


@pytest.mark.parametrize("b", [1.5e12, 2.5e9, 3.2e6, 900, None])
def test_fmt_bytes_as_jax(b):
    assert report.fmt_bytes(b) == jax_report.fmt_bytes(b)


@pytest.mark.parametrize("s", [2.5, 0.0032, 5e-6, 0.0])
def test_fmt_s_as_jax(s):
    assert report.fmt_s(s) == jax_report.fmt_s(s)


def test_tables_equal_the_jax_report(rows):
    for mesh in ("1x1", "16x16", "2x16x16"):
        assert report.roofline_table(rows, mesh) == \
            jax_report.roofline_table(rows, mesh)
    assert report.dryrun_table(rows) == jax_report.dryrun_table(rows)
    table = report.dryrun_table(rows)
    assert "SKIP" in table and "ERROR" in table
    assert "| qwen2-0.5b | decode_32k | **memory**" in \
        report.roofline_table(rows, "1x1")


def test_command_line_renders_every_mesh(rows, tmp_path, capsys):
    path = tmp_path / "dry.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    report.main([str(path)])
    out = capsys.readouterr().out
    for title in report.MESH_TITLES.values():
        assert f"### {title}" in out
    assert out.index("One card") < out.index("Single-pod")
    report.main([str(path), "dryrun"])
    assert "| zamba2-1.2b | long_500k | 1x1 | ok" in capsys.readouterr().out

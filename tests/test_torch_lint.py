"""The progress-safety lint (``repro.analysis.progress_lint``) over the
port, ``src/repro_torch``, under the port's own allowlist
(``repro_torch.analysis.progress_lint_allowlist``): no finding outside
it, and no entry that excuses nothing."""
from pathlib import Path

import pytest

from repro.analysis import progress_lint as PL
from repro_torch.analysis.progress_lint_allowlist import ALLOWLIST

SRC = Path(__file__).resolve().parents[1] / "src"


def port_findings():
    files = PL.collect_paths(str(SRC / "repro_torch"))
    modules = [m for m in (PL.parse_module(p, str(SRC)) for p in files)
               if m is not None]
    assert len(modules) >= 40
    findings = PL.lint_modules(modules)
    PL.apply_allowlist(findings, list(ALLOWLIST))
    return findings


def test_port_is_clean_under_its_allowlist():
    flagged = [f for f in port_findings() if not f.allowed]
    assert flagged == [], PL.format_findings(flagged)


@pytest.mark.parametrize("entry", ALLOWLIST, ids=lambda e: e["path"])
def test_allowlist_entry_is_justified_and_used(entry):
    assert entry["rule"] in PL.RULES
    assert all(entry.get(k) for k in ("rule", "path", "qual", "why")), entry
    assert entry["path"].startswith("repro_torch/")
    used = [f for f in port_findings()
            if f.allowed and f.path.endswith(entry["path"])
            and f.qual == entry["qual"]]
    assert used, f"{entry['path']}:{entry['qual']} excuses no finding"

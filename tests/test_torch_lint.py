"""The port's own progress-safety lint
(``repro_torch.analysis.progress_lint``, a stdlib copy of the JAX
package's) over the port, ``src/repro_torch``, under the port's
allowlist (``repro_torch.analysis.progress_lint_allowlist``): no finding
outside it, and no entry that excuses nothing; both lints give the same
findings over the JAX tree and over the fixtures of
``tests/test_progress_lint.py``; and a CUDA ``synchronize()`` in a
continuation is flagged."""
import ast
import importlib.util
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.analysis import progress_lint as PL
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


def jax_lint():
    """The JAX package's lint, loaded by file path (it needs only the
    standard library)."""
    path = SRC / "repro" / "analysis" / "progress_lint.py"
    name = "_jax_progress_lint"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod          # its dataclasses look it up
        spec.loader.exec_module(mod)
    return sys.modules[name]


def keys(findings) -> list:
    return sorted((f.rule, f.path, f.qual) for f in findings)


def lint_fixtures() -> list[str]:
    """Every source string ``tests/test_progress_lint.py`` lints."""
    tree = ast.parse((Path(__file__).parent
                      / "test_progress_lint.py").read_text())
    return [textwrap.dedent(node.args[0].value)
            for node in ast.walk(tree)
            if isinstance(node, ast.Call) and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
            and getattr(node.func, "id", getattr(node.func, "attr", ""))
            in ("lint", "lint_source")]


def test_both_lints_give_the_same_findings():
    JPL = jax_lint()
    files = PL.collect_paths(str(SRC / "repro"))
    ours = PL.lint_modules([m for m in (PL.parse_module(p, str(SRC))
                                        for p in files) if m is not None])
    theirs = JPL.lint_modules([m for m in (JPL.parse_module(p, str(SRC))
                                           for p in files) if m is not None])
    assert keys(ours) == keys(theirs) and ours
    fixtures = lint_fixtures()
    assert len(fixtures) >= 14
    flagged = 0
    for src in fixtures:
        want = keys(JPL.lint_source(src))
        assert keys(PL.lint_source(src)) == want, src
        flagged += bool(want)
    assert flagged >= 9


@pytest.mark.parametrize("call", ["torch.cuda.synchronize()",
                                  "self.done_event.synchronize()",
                                  "self.stream.synchronize()",
                                  "self.loss.item()"])
def test_a_blocking_cuda_call_in_a_continuation_is_flagged(call):
    findings = PL.lint_source(textwrap.dedent(f"""
        import torch

        class Step:
            def _on_done(self, req):
                {call}

            def run(self, q, req):
                q.attach(req, self._on_done)
    """))
    assert [f.rule for f in findings] == ["PL001"]
    assert findings[0].qual == "Step._on_done"
    assert call.split(".")[-1].rstrip("()") in findings[0].message

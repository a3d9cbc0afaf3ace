"""The repo's contract lints, held over the port (``horovod_tpu_torch``).

The ``tools/check_*.py`` lints read the JAX package only; this file keeps
its own copy of their rules for the port:

* every ``HVD_``/``HOROVOD_`` knob that ``horovod_tpu_torch/utils/env.py``
  declares is named in ``docs/`` or ``README.md``;
* the fault sites the port fires by literal name are in
  ``fault_injection.KNOWN_SITES``, and every registered site is named in
  ``docs/`` or ``README.md``;
* the metric names the port records by literal name are in
  ``telemetry.registry.KNOWN_METRICS``, and every registered metric (and
  every anomaly rule of ``telemetry.aggregate.ALERT_RULES``) is named in
  ``docs/`` or ``README.md``.

Names match as whole words (a dotted site as a whole dotted name), as in
the JAX package's lints.
"""

import ast
import re
from pathlib import Path

import pytest

from horovod_tpu_torch.common import fault_injection
from horovod_tpu_torch.telemetry import aggregate
from horovod_tpu_torch.telemetry import registry

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "horovod_tpu_torch"


def _documented() -> str:
    return "\n".join(p.read_text(encoding="utf-8") for p in
                     sorted((REPO / "docs").glob("*.md"))
                     + [REPO / "README.md"])


def _word(name: str, text: str) -> bool:
    return re.search(rf"(?<![\w.]){re.escape(name)}(?![\w.])",
                     text) is not None


def declared_knobs():
    tree = ast.parse((PORT / "utils" / "env.py").read_text(encoding="utf-8"))
    return sorted({node.value.value for node in tree.body
                   if isinstance(node, ast.Assign)
                   and isinstance(node.value, ast.Constant)
                   and isinstance(node.value.value, str)
                   and node.value.value.startswith(("HVD_", "HOROVOD_"))})


def literal_calls(hooks, skip=()):
    """``{name: [file, ...]}``: every string literal passed first to one
    of ``hooks`` (a function or method name) in the port."""
    out = {}
    for py in sorted(PORT.rglob("*.py")):
        if py in skip:
            continue
        for node in ast.walk(ast.parse(py.read_text(encoding="utf-8"))):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            name = fn.id if isinstance(fn, ast.Name) else \
                fn.attr if isinstance(fn, ast.Attribute) else None
            first = node.args[0]
            if name in hooks and isinstance(first, ast.Constant) and \
                    isinstance(first.value, str):
                out.setdefault(first.value, []).append(
                    str(py.relative_to(REPO)))
    return out


def test_every_env_knob_is_documented():
    knobs = declared_knobs()
    assert len(knobs) > 50
    text = _documented()
    assert [k for k in knobs if not _word(k, text)] == []


def test_fired_fault_sites_are_registered():
    fired = literal_calls(("fire", "should_corrupt"))
    assert fired
    known = fault_injection.known_sites()
    assert {s: f for s, f in fired.items() if s not in known} == {}


def test_registered_fault_sites_are_documented():
    text = _documented()
    assert [s for s in sorted(fault_injection.known_sites())
            if not _word(s, text)] == []


def test_recorded_metrics_are_registered():
    used = literal_calls(("inc_counter", "set_gauge", "observe"),
                         skip=(PORT / "telemetry" / "registry.py",))
    assert used
    known = registry.known_metrics()
    assert {m: f for m, f in used.items() if m not in known} == {}


@pytest.mark.parametrize("names", ["metrics", "alert_rules"])
def test_registered_metrics_and_alert_rules_are_documented(names):
    text = _documented()
    registered = sorted(registry.known_metrics()) if names == "metrics" \
        else sorted(aggregate.ALERT_RULES)
    assert registered
    assert [m for m in registered if not _word(m, text)] == []

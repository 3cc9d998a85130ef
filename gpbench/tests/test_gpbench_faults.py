"""The comparison sees a broken program: each fault a cell can have
(``gpbench/faults.py``) is planted under a tiny run on the CPU, and
``correct`` comes out false. The look for a card is skipped (the test-only
hooks run on the CPU); everything else of a run is driven as the command
drives it."""

import pytest

from gpbench.faults import FAULTS

from .tiny import run_tiny


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run_tiny(cell)
    assert not result["correct"], result["checks"]

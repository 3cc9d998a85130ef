"""The control: the plain reference computed in TF32, the precision below
the configurations' float32 (on the CPU, TF32 is emulated by rounding the
operands of every matmul), put in the program's place. At the size a test
run holds, it fails the limits of the n = 50,000 cells outright; the limits
of the n = 100,000 cells were set from the control's readings on the card
at their own size (PERF.md), and here it still reads two orders of
magnitude past the program."""

import pytest
import torch

from gpbench import check, harness
from gpbench.reference import gp as ref

from .tiny import run_tiny


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-10, 1.0 + 2**-23])
    assert ref.round_tf32(x).tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0 - 2**-9, 1.0]


@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_manifest()["workloads"]])
def test_the_control_is_caught(cell):
    result = run_tiny(cell, control=True, n=2000)
    program = {k: v["value"] for k, v in result["checks"].items() if k.endswith("_gap")}
    control = result["control"]
    assert result["correct"]
    assert control["var_gap"] > 100 * program["var_gap"]
    if cell.startswith("gp50k"):
        limits = harness.Cell(cell).limits
        ok, _ = check.compare(control, {k: v for k, v in limits.items() if k in control})
        assert not ok, control

"""The comparison that decides ``correct``.

Each loop hands over what the measured window produced (``outputs``): the
program's answers (``outputs.program``: posterior means and variances) and
a way to work the same answers out again with the plain reference
(``outputs.reference(tf32)``, ``gpbench/reference/``), from the inputs and
the hyperparameters the program's fit returned. The numbers
compared are the gaps between the two:

- ``mean_gap``, ``var_gap``: the widest absolute gap of a posterior mean or
  latent variance over every answer compared;

and, where the loop judges a fit (``outputs.extra()``), ``fit_gain``: the
reference's log marginal likelihood per point at the fitted hyperparameters
less that at the fit's start, on a subset drawn from the seed.

Which of them a cell compares, and their limits, is the cell's
``gpbench/limits/<cell>.json``. The control is the reference computed in
TF32 put in the program's place: ``control_readings`` gives its gaps to the
float32 reference.
"""

from __future__ import annotations

import math

import torch


def gaps(candidate: dict, truth: dict) -> dict:
    out = {}
    for key in ("mean", "var"):
        diff = torch.abs(candidate[key].double().cpu() - truth[key].double().cpu())
        out[f"{key}_gap"] = float(torch.max(diff)) if diff.numel() else 0.0
        if bool(torch.isnan(diff).any()):
            out[f"{key}_gap"] = math.nan
    return out


def readings(outputs) -> dict:
    """The numbers compared for the program's answers; the float32
    reference's answers are kept on ``outputs.truth`` for the control."""
    outputs.truth = outputs.reference(tf32=False)
    return {**gaps(outputs.program, outputs.truth), **outputs.extra()}


def control_readings(outputs) -> dict:
    """The same numbers for the control: the reference in TF32."""
    return gaps(outputs.reference(tf32=True), outputs.truth)


def compare(values: dict, limits: dict, failed: int = 0) -> tuple[bool, dict]:
    """``correct`` and each number the cell's limits name, beside its limit.
    A limit is ``{"max": x}`` (the number may not exceed it) or
    ``{"min": x}``; a number missing or NaN, or any failed answer, is not
    correct."""
    checks, ok = {}, failed == 0
    for name, limit in limits.items():
        value = values.get(name, math.nan)
        entry = {"value": value}
        if "max" in limit:
            entry["limit"] = limit["max"]
            ok = ok and value <= limit["max"]
        else:
            entry["limit"] = limit["min"]
            entry["at_least"] = True
            ok = ok and value >= limit["min"]
        ok = ok and not math.isnan(value)
        checks[name] = entry
    checks["failed"] = {"value": failed, "limit": 0}
    return ok, checks


def check_lines(checks: dict) -> list:
    lines = []
    for name, entry in checks.items():
        sense = ">=" if entry.get("at_least") else "<="
        lines.append(f"check {name} {entry['value']!r} {sense} {entry['limit']!r}")
    return lines

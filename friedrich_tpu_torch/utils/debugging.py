"""Numerical-debugging helpers.

Counterpart of ``friedrich_tpu/utils/debugging.py``: NaN trapping and the
order-stable checksum the tests use to assert that two paths computed the
same values.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from ..config import default_dtype

#: Whether the innermost :func:`debug_nans` scope traps.
_TRAPPING = [False]


class _NanTrap(TorchDispatchMode):
    """Raises :class:`FloatingPointError` at the first operation whose
    floating-point output holds a NaN, while :data:`_TRAPPING` is set."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _TRAPPING[0]:
            for t in tree_leaves(out):
                if (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
                        and bool(torch.isnan(t).any())):
                    raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True) -> Iterator[None]:
    """Trap NaN production for the scope: the counterpart of
    ``jax_debug_nans``, a dispatch mode that checks every operation's output
    and raises :class:`FloatingPointError` at the first NaN (forward and
    backward alike, which ``torch.autograd.detect_anomaly`` does not).
    ``enable=False`` turns an enclosing scope's trap off. The previous
    setting, and the dispatch-mode stack, are restored on exit."""
    prev = _TRAPPING[0]
    _TRAPPING[0] = bool(enable)
    try:
        if enable and not prev:
            with _NanTrap():
                yield
        else:
            yield
    finally:
        _TRAPPING[0] = prev


def _leaves(tree):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree) for leaf in _leaves(getattr(tree, f.name))]
    return tree_leaves(tree)


def checksum(tree) -> float:
    """Order-stable scalar digest of a tree (dicts, lists, tuples,
    dataclasses) of tensors, arrays and numbers: the sum of the absolute
    values of its numeric leaves, accumulated in the default dtype — for
    asserting that two paths computed identical values."""
    dtype = default_dtype()
    total = torch.zeros((), dtype=dtype)
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            arr = leaf.detach().cpu()
        elif isinstance(leaf, (np.ndarray, np.generic, int, float)) and not isinstance(leaf, bool):
            arr = torch.as_tensor(np.asarray(leaf))
        else:
            continue
        if arr.dtype == torch.bool or arr.is_complex():
            continue
        total = total + torch.sum(torch.abs(arr.to(dtype)))
    return float(total)

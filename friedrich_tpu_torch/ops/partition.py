"""Block-size selection for the strip loops."""

from __future__ import annotations


def pick_block(extent: int, target: int) -> int:
    """Largest divisor of ``extent`` that is <= ``target``.

    Degrades toward 1 for pathological (e.g. prime) extents — correctness
    is preserved, efficiency callers should pad such sizes up front.
    """
    b = min(target, extent)
    while extent % b:
        b -= 1
    return b

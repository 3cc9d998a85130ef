"""Block-size selection for the strip loops, and the streamed factor's
panel widths."""

from __future__ import annotations

#: Panel-width target of the streamed factorization when none is given,
#: snapped to a divisor of the capacity by :func:`pick_block`: of the
#: targets 1024, 2048, 4096 and 8192 in the sweeps of ``chip_smoke.py``
#: phases 5b and 5c with the tensor-core panel-strip kernel on an NVIDIA
#: H100 80GB HBM3 at 700 W, the fastest at capacity 100,512 (4.981, 4.507,
#: 4.718, 5.139 s) and within the spread of the fastest at 50,512 (0.738,
#: 0.709, 0.724, 0.805 s; PERF.md).
DEFAULT_PANEL_TARGET = 2048


def pick_block(extent: int, target: int) -> int:
    """Largest divisor of ``extent`` that is <= ``target``.

    Degrades toward 1 for pathological (e.g. prime) extents — correctness
    is preserved, efficiency callers should pad such sizes up front.
    """
    b = min(target, extent)
    while extent % b:
        b -= 1
    return b


def panel_widths(cap: int, block=None) -> tuple[int, ...]:
    """The widths of the streamed factorization's panels, left to right.

    ``block`` is a width, snapped to a divisor of ``cap`` by
    :func:`pick_block`, or a schedule: a tuple or list of positive widths
    summing to ``cap`` (``friedrich_tpu/ops/streamed.py:433-446``). ``None``
    takes :data:`DEFAULT_PANEL_TARGET`; where ``cap`` has no divisor within
    half of it, the panels are that width with a narrower last one, which
    the panel-strip kernel takes as it takes any width.
    """
    if isinstance(block, (tuple, list)):
        widths = tuple(int(w) for w in block)
        if any(w <= 0 for w in widths) or sum(widths) != cap:
            raise ValueError(
                f"panel width schedule must be positive and sum to the "
                f"capacity {cap}, got {widths}"
            )
        return widths
    if block is not None:
        if int(block) <= 0:
            raise ValueError(f"panel width must be positive, got {block}")
        b = pick_block(cap, int(block))
        return (b,) * (cap // b)
    target = min(DEFAULT_PANEL_TARGET, cap)
    b = pick_block(cap, target)
    if 2 * b >= target:
        return (b,) * (cap // b)
    full, last = divmod(cap, target)
    return (target,) * full + ((last,) if last else ())

"""Seconds of the collectives' kernels per factorization on the card with
the most other device time in its factorizations (the rank the left-looking
build loads most): the kernels launched inside the program's
``mesh/broadcast`` and ``mesh/all_reduce`` scopes within its
``large_scale/factor`` scopes, summed, over its factorizations. A kernel
that waits for its peers counts its wait."""

from gpbench.cards import factors_by_card


def read(run):
    cards = factors_by_card(run)
    if cards is None:
        return None
    comm, _, factorizations = max(cards, key=lambda c: c[1])
    return comm / factorizations if comm > 0 else None

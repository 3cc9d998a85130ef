"""How evenly the row-sharded build loads the cards: of the work launched
inside the program's ``large_scale/factor`` scopes, the mean card's device
time other than the collectives' kernels (the union of its kernels, copies
and memsets) over the busiest card's, in %. 100 % is an even load; the
contiguous row layout gives rank r about ((r + 1)^3 - r^3) / W^3 of a
build's products."""

from gpbench.cards import factors_by_card


def read(run):
    cards = factors_by_card(run)
    if cards is None:
        return None
    busy = [other for _, other, _ in cards]
    return 100.0 * sum(busy) / len(busy) / max(busy) if max(busy) > 0 else None

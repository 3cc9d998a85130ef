"""Gigabytes broadcast per trained model: the program's count of the bytes
its broadcasts sent (``parallel/mesh.COLLECTIVE_BYTES["broadcast"]``) over
the window on rank 0, which takes part in every broadcast, over the models
trained (1e9 bytes). A build over W ranks broadcasts, for each panel of a
rank but the last, its inputs, its rows of the factor to its left and its
diagonal block."""

from gpbench.cards import rank_counter_delta


def read(run):
    sent = rank_counter_delta(run.rank_reports[0], "collective_bytes").get("broadcast", 0)
    if not sent or not run.timings:
        return None
    return sent / len(run.timings) / 1e9

"""Loops of the benchmark that are files of their own.

A traffic mix whose ``"loop"`` is not one built into ``gpbench/loops.py``
names a file here, ``gpbench/flows/<loop>.py``, found by that name. The file
defines ``LOOP``, a subclass of ``gpbench.loops.Loop`` with ``setup()``,
``window(seconds)`` returning a ``loops.Outcome``, ``outputs()`` returning a
``loops.ModelOutputs``, ``release()`` and optionally ``counters()``; and,
optionally, ``FAULTS``: a name to a fault of ``gpbench/faults.py``'s form,
for ``python -m gpbench.control --fault``.

In a cell on W > 1 cards the loop runs on every rank (``run.rank`` of
``run.world``, on ``run.device``, in a process group that exists: the
program joins it with ``parallel.multihost.initialize(device=run.device)``
and leaves it to the benchmark). Every rank calls the same methods with the
same arguments; rank 0 measures, and decides with ``run.agree`` what the
others follow, such as whether the window goes on. ``window`` returns an
``Outcome`` on every rank, rank 0's being the one reported; ``outputs``
returns the same answers on every rank.
"""

"""Plain reference of the benchmark's model (``gp.py``)."""

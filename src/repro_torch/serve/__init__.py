"""Serving layer of the port: the batched query engine, the slab arena
of stream states, Pareto-front admission and the async serve loop.

Counterpart of ``repro.serve``."""

"""Serving layer of the port: the batched query engine, the slab arena
of stream states, and Pareto-front admission.

Counterpart of ``repro.serve`` without the serve loop (ROADMAP.md,
item 10)."""

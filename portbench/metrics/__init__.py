"""Per-layer metric readers: metrics/<name>.py (or <name up to its first
dot>.py, shared by the cells' splits of one quantity) defines
`read(ctx, name)`, which returns the metric's value or None where the
run has nothing to read. `ctx`: steps (timed steps in the traced
window), step_counts (per step, what its data holds), summary
(portbench/trace.py `summarize`), spans (the program's host spans),
window_s, gc_s, cfg, traffic."""

"""Plain references of the hub's semantics. They import nothing of the
program (`automerge_tpu_torch`) and take nothing it made: they replay
the logical ops the benchmark's generators recorded."""

"""The benchmark of automerge_tpu_torch (see run.py)."""

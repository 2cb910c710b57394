"""The benchmark's traffic generators: change bytes and, beside them,
the logical ops the references replay."""

"""Frozen copies of the port's host codec (changes, documents, sync
messages, Bloom filters). The benchmark's generators and references use
these, never the program's, so that a later change to the program cannot
move the yardstick."""

"""Document kinds a configuration can hold. A kind makes a group's
history and batches from the seed, replays them in its reference, reads
the program's answers, and counts what a batch's data needs."""

"""automerge_tpu_torch: the PyTorch + CUDA port of automerge_tpu.

This package carries the host codecs and OpSet engine (copied from the
reference package), the native codec, and the fleet
(`automerge_tpu_torch.fleet`): the backend seam (plain and pipelined)
whose merge dispatch is a hand-written CUDA kernel, exact mode's register
scan and the Text/list sequence scan (hand-written CUDA kernels too), the
batched sync plane whose Bloom and hash-index dispatches are hand-written
CUDA kernels, the bulk loader and the parked form, durability (journal,
checkpoints, crash recovery) and the storage tier (parked documents on a
RAM or disk arena, revived onto the card, and the mixed live/parked sync
rounds). The frontend and the top-level Automerge API (F1) and the
later items of ROADMAP.md Queue 1 are still to come.
"""

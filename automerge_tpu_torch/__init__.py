"""automerge_tpu_torch: the PyTorch + CUDA port of automerge_tpu.

This slice carries the host codecs and OpSet engine (copied from the
reference package), the native codec, the fleet backend seam
(`automerge_tpu_torch.fleet.backend`, plain and pipelined) whose merge
dispatch is a hand-written CUDA kernel, and the batched sync plane
(`automerge_tpu_torch.fleet.sync_driver`) whose Bloom and hash-index
dispatches are hand-written CUDA kernels. The frontend and the
top-level Automerge API are later slices (ROADMAP.md).
"""

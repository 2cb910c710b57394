"""automerge_tpu_torch: the PyTorch + CUDA port of automerge_tpu.

This slice carries the host codecs and OpSet engine (copied from the
reference package), the native codec, and the fleet backend seam
(`automerge_tpu_torch.fleet.backend`) whose merge dispatch is a
hand-written CUDA kernel. The frontend and the top-level Automerge API
are later slices (ROADMAP.md).
"""

"""The card's peaks and the least time a kernel's work could take.

`bound_of` is a frozen copy of chip_smoke.py:5316-5323 with its two
peaks (chip_smoke.py:364-365). The byte counts that feed it are the
per-layer readers' (portbench/metrics/*_roofline.py), computed from the
inputs the harness handed to the program, never from the program's own
recorders.
"""

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12         # non-tensor float32 peak, an upper bound


def bound_of(n_bytes, n_ops=0):
    """The least time the card could take: bytes over the memory rate or
    integer operations over the issue rate, whichever is longer."""
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes=n_bytes, ops=n_ops,
                bound_by='bytes' if bytes_ms >= ops_ms else 'operations')


def roofline_pct(n_bytes, kernel_us, n_ops=0):
    """The bound's share of the kernels' device time, in %; None where
    no kernel time was read."""
    if not kernel_us or kernel_us <= 0:
        return None
    return 100.0 * bound_of(n_bytes, n_ops)['bound_ms'] * 1e3 / kernel_us

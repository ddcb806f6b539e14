"""The yardstick: the card's published peak and the bytes each kernel call
needs, from the call's shapes alone.

Frozen copies of ``chip_smoke.py``'s ``HBM_BYTES_PER_S`` and of the byte
counts in ``PERF.md``'s table of kernels: each input byte read once and each
output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

__all__ = ["HBM_BYTES_PER_S", "PORT_KERNELS", "scan_bytes",
           "dispatch_bytes", "is_port_kernel"]

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 at the 700 W limit
HBM_BYTES_PER_S = 3.35e12

# the device kernels of each of the port's kernel entry points, by the
# names the profiler gives them (substrings of the demangled names)
PORT_KERNELS = {
    "prefix_scan": ("sequential_scan_rows",),
    "dispatch_work_prefix": ("work_prefix_stage", "work_prefix_walk"),
}


def is_port_kernel(name: str, op: str | None = None) -> bool:
    """Whether the device kernel ``name`` belongs to the port's ``op`` (any
    of its ops when ``op`` is None)."""
    ops = PORT_KERNELS if op is None else {op: PORT_KERNELS[op]}
    return any(part in name for parts in ops.values() for part in parts)


def scan_bytes(rows: int, length: int) -> int:
    """``prefix_scan`` of a (rows, length) float64 tensor: each element read
    once and its exclusive prefix written once, 16 B."""
    return 16 * rows * length


def dispatch_bytes(rows: int, tokens: int, experts: int, init: bool,
                   valid: int) -> int:
    """``dispatch_work_prefix`` of (rows, tokens) int32 destinations and
    float64 weights into ``experts`` fill cells a row: 4 B read a
    destination and 8 B written a prefix, every token; 8 B read a weight,
    for the ``valid`` tokens with a destination; 8 B written a fill cell,
    and 8 B read a cell of ``init`` where the call starts from one."""
    return (rows * tokens * (4 + 8) + valid * 8
            + rows * experts * 8 * (2 if init else 1))

"""Host-entry layer (``simulate_batch`` -> ``to_tensors``): device time of
the copies to the card, in ms a sweep."""

from __future__ import annotations


def read(trace):
    copies = [end - start for name, start, end in trace.copies
              if name.startswith("Memcpy HtoD")]
    if not copies or not trace.sweeps:
        return None
    return sum(copies) / 1e3 / trace.sweeps

"""Engine layer: device time of every kernel that is not one of the port's
own (``yardstick.PORT_KERNELS``), the plain PyTorch passes of
``_simulate_batch_torch``, in ms a slot swept."""

from __future__ import annotations

from portbench.yardstick import is_port_kernel


def read(trace):
    plain = [end - start for name, start, end in trace.kernels
             if not is_port_kernel(name)]
    if not plain or not trace.slots:
        return None
    return sum(plain) / 1e3 / trace.slots

"""Hand-written CUDA kernels of the port, each beside its plain version.

See :mod:`repro_torch.kernels.ring` (the compiled interconnect) and
:mod:`repro_torch.kernels.dispatch` (the device rule and launch counts).
"""

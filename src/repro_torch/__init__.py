"""PyTorch/CUDA port of the paper's federated GRU training path and of
Mamba2-130m serving and training.

A package beside the JAX reference ``repro``, with the same module names.
It imports ``torch`` and numpy only.  The GRU recurrence and the SSD chunked
scan, forward and backward, run through hand-written CUDA kernels for
Hopper (``csrc/gru_scan.cu``, ``csrc/ssd.cu``) on CUDA tensors and through
plain PyTorch versions on CPU tensors; the tensor's device decides, and
entry points default to the card (``repro_torch.device.resolve_device``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

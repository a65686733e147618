"""Device resolution for the PyTorch port.

Counterpart of ``hybdrt_tpu/utils/device.py``. The JAX package needed
host-pinning helpers because its prep ran on the CPU backend beside a TPU
backend in one process; here every function takes an explicit ``device=``
argument and host-side assembly is plain numpy, so all that remains is
turning the caller's request into a ``torch.device``.
"""
import torch


def resolve_device(device=None):
    """Return the ``torch.device`` the caller asked for: the CUDA card when
    ``None``, the CPU only when asked for by name.

    Raises ``RuntimeError`` when a CUDA device is wanted (by default or by
    name) and none is present: there is no silent fallback to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            wanted = "the default device" if device is None else f"device {device!r}"
            raise RuntimeError(f"{wanted} is CUDA, but CUDA is not available; pass "
                               f"device='cpu' to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s) exist")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected 'cpu' or 'cuda'")
    return dev

"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when a CUDA device is asked
    for and none is present — the port never falls back to the CPU on its
    own (callers that want the CPU say ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the CPU")
    return dev


def to_device(arr, device) -> torch.Tensor:
    """``arr`` (a numpy array) on ``device`` without making the host wait.

    A copy from pageable host memory synchronizes the CUDA stream, so the
    host would stall until every queued kernel has run before it could
    queue the next. The array goes through pinned memory instead, copied
    with ``non_blocking=True``; PyTorch's pinned allocator keeps the
    buffer until the copy is done. On the CPU it is a plain tensor."""
    host = torch.from_numpy(np.ascontiguousarray(arr))
    dev = torch.device(device)
    if dev.type != "cuda":
        return host
    return host.pin_memory().to(dev, non_blocking=True)


def to_host(tensors) -> list:
    """Numpy copies of device tensors in ONE device-to-host transfer (one
    wait of the host on the card): their bytes are concatenated on the
    device, copied once, and cut apart on the host."""
    if not tensors:
        return []
    flat = [t.detach().contiguous().reshape(-1) for t in tensors]
    raw = torch.cat([f.to(torch.uint8) if f.dtype == torch.bool
                     else f.view(torch.uint8) for f in flat])
    # lint: allow[host-sync] the one transfer of a batch of tensors (a preemption's spill)
    raw = raw.cpu().numpy()
    out, off = [], 0
    for t in tensors:
        dtype = (np.dtype(np.bool_) if t.dtype == torch.bool
                 else torch.empty((), dtype=t.dtype).numpy().dtype)
        nbytes = t.numel() * dtype.itemsize
        out.append(raw[off:off + nbytes].view(dtype).reshape(t.shape))
        off += nbytes
    return out


__all__ = ["resolve_device", "to_device", "to_host"]

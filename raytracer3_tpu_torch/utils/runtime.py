"""Device reporting (port of ``raytracer3_tpu/utils/runtime.py``): what a
process renders on, for logs and the viewer.

The reference's persistent XLA compilation cache and its watchdog pull
have no counterpart here (ROADMAP.md, "Not to port"); multi-process
start-up waits for the multi-device work (ROADMAP.md M14).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str  # "gpu" or "cpu"
    device_kind: str
    num_devices: int
    num_hosts: int
    memory_per_device: int | None  # bytes; None on the CPU


def device_info(device) -> DeviceInfo:
    """The device a caller renders on: a CUDA device reports its name,
    the card count and its total memory; the CPU reports one device."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device_info: a CUDA device was asked for but none is available")
        index = device.index if device.index is not None else torch.cuda.current_device()
        return DeviceInfo(
            platform="gpu",
            device_kind=torch.cuda.get_device_name(index),
            num_devices=torch.cuda.device_count(),
            num_hosts=1,
            memory_per_device=torch.cuda.get_device_properties(index).total_memory,
        )
    if device.type == "cpu":
        return DeviceInfo(platform="cpu", device_kind="cpu", num_devices=1, num_hosts=1, memory_per_device=None)
    raise ValueError(f"device_info: cpu or cuda, not {device}")


def describe(device) -> str:
    i = device_info(device)
    mem = f", {i.memory_per_device / 2**30:.1f} GiB/device" if i.memory_per_device else ""
    return f"{i.platform} × {i.num_devices} ({i.device_kind}) on {i.num_hosts} host(s){mem}"

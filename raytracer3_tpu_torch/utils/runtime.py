"""Device reporting and multi-process start-up (port of
``raytracer3_tpu/utils/runtime.py``): what a process renders on, for logs
and the viewer, and ``init_distributed``, the process group that
``parallel/mesh`` renders over.

The reference's persistent XLA compilation cache and its watchdog pull
have no counterpart here (ROADMAP.md, "Not to port").
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    platform: str  # "gpu" or "cpu"
    device_kind: str
    num_devices: int
    num_hosts: int
    memory_per_device: int | None  # bytes; None on the CPU


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, device="cuda", timeout_s: float = 300.0):
    """Join this process to the default process group — call once per
    process before ``parallel/mesh``. NCCL on a CUDA ``device`` (one card per
    rank: NCCL refuses two ranks on one card), gloo on the CPU.

    ``coordinator`` is the rendezvous: ``host:port`` (TCP), or a URL such
    as ``tcp://localhost:29500`` or ``file:///path/to/shared/file``; with
    ``num_processes`` (the world size) and ``process_id`` (this rank). With
    no coordinator the group reads ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK`` from the environment."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: a CUDA device was asked for but none is available")
        torch.cuda.set_device(device.index if device.index is not None else 0)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: cpu or cuda, not {device}")
    kw = {}
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_distributed: a coordinator needs num_processes and process_id")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kw = dict(init_method=url, world_size=num_processes, rank=process_id)
    dist.init_process_group(backend, timeout=datetime.timedelta(seconds=timeout_s), **kw)


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

"""Production mesh construction (single-pod 16×16, multi-pod 2×16×16) on a
``torch.distributed`` :class:`~torch.distributed.device_mesh.DeviceMesh`.

PyTorch port of :mod:`repro.launch.mesh`.  Functions, not module-level
constants: importing this module creates no process group and touches no
device.  :func:`make_production_mesh` lays its shape over the process
group that exists when it is called (the dry run makes a fake one of 256
or 512 ranks, see :mod:`.dryrun`); :func:`make_host_mesh` makes a
single-rank group itself when there is none (a ``HashStore``: no
network), so on one card it is a 1×1 mesh.

The roofline's hardware model :data:`HW` is one NVIDIA H100 SXM5.  A
16-wide ``model`` axis spans two 8-GPU NVLink domains, so part of its
traffic would cross the slower network between hosts: the collective
term priced at NVLink's rate is a lower bound.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The 16×16 ``("data", "model")`` or 2×16×16 ``("pod", "data",
    "model")`` mesh of cards over the current process group (256 / 512
    ranks).  The dry run places only ``meta`` tensors on it; the mesh's
    device type decides DTensor's collective plan (all-to-alls on
    ``"cuda"``), so it is the cards' wherever it is traced."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh("cuda", shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """Small ``("data", "model")`` mesh over the ranks that exist (tests /
    examples); one card (or the CPU) alone gives 1×1."""
    dev = _device_type()
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    return init_device_mesh(dev, (data, model),
                            mesh_dim_names=("data", "model"))


# NVIDIA H100 SXM5 hardware model for the roofline (per card), from NVIDIA's
# H100 Tensor Core GPU data sheet: dense BF16 tensor-core peak, HBM3
# bandwidth, NVLink 4 (18 links, 25 GB/s each way per link), 80 GB of HBM3.
HW = {
    "peak_flops_bf16": 989e12,     # FLOP/s
    "hbm_bw": 3.35e12,             # B/s
    "nvlink_bw_per_link": 25e9,    # B/s each way per link
    "nvlink_links": 18,
    "hbm_bytes": 80 * 10**9,
}

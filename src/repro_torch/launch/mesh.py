"""Device meshes of the port (PyTorch port of ``repro.launch.mesh``), and
the H100's constants that the roofline prices.

Functions, not module-level constants, so that importing this module
touches no process group. The production target is a 16 x 16 = 256-GPU
mesh (axes data x model), and 2 pods = 512 GPUs with a leading 'pod' axis
for the multi-pod dry-run, the reference's shapes. Both build a
``DeviceMesh`` over the process group already initialized (world size =
the mesh's size): NCCL on the card, gloo on the CPU for the tests, the
fake group in the dry-run.

Constants (NVIDIA H100 SXM data sheet, dense rates, at its 700 W limit):
bf16 tensor-core peak 989 TFLOP/s; HBM3 3.35 TB/s; NVLink 4 900 GB/s a GPU,
450 GB/s each way. The collective term prices the NVLink rate each way.
A model axis of 16 spans two 8-GPU NVLink nodes (and every data-axis group
of the (16, 16) mesh spans 16 nodes), so the hops between nodes run over
the cluster network, which is several times slower than NVLink and which
no card of this repository's runs has measured; the term is therefore a
lower bound on collective time, the same bound for every cell, and a
record's wire bytes carry the collective cost at any other link rate.
"""
from __future__ import annotations

from repro_torch import device as _device

PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12  # B/s
LINK_BW = 450e9  # B/s, NVLink 4 per GPU, each way


def _mesh(shape, names, device):
    from torch.distributed.device_mesh import init_device_mesh

    dev = _device.resolve(device)
    return init_device_mesh(dev.type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_host_mesh(model: int = 1, device="cuda"):
    """(world // model, model) mesh over the initialized world."""
    import torch.distributed as dist

    n = dist.get_world_size()
    model = min(model, n)
    return _mesh((n // model, model), ("data", "model"), device)

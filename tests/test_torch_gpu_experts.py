"""The expert-axis SWIS kernel at its edges on the card, against its plain
version (dequant then einsum) on the same inputs: every row count of decode
(M 1-8) and capacity row counts, column counts that are not a multiple of
the 64-column tile, K shorter than one 256-k stage and K that ends inside
one, 1-8 planes, SWIS-C, keep_slices, bf16 x, x that is not 16-byte
aligned, groups other than 4, and E 1 at a cut of dbrx-132b's rank-0
expert shape; a stack quantized to more than 8 bits is refused. fp32 within rtol 1e-5 and atol 1e-5*max|ref| of each expert,
bf16 within 2e-2. Every test here is marked ``gpu`` and skips without a
CUDA device; this file imports no JAX."""
import pytest
import torch

from repro_torch.core import swis
from repro_torch.kernels import ops, ref
from repro_torch.kernels import swis_matmul as sm
from repro_torch.serve import quantized
from torch_port import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _stack(dev, e, k, n, n_shifts, method="swis", group=4, seed=0, bits=8):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((e, k, n), generator=g, device=dev) * 0.05
    cfg = swis.QuantConfig(method=method, n_shifts=n_shifts, group_size=group,
                           bits=bits)
    return quantized.pack_tree({"w": w}, cfg)[0]["w"]


def _check(x, leaf, *, group=4, consecutive=False, keep=None):
    """One launch against the plain version, expert by expert."""
    e = leaf["sign_plane"].shape[0]
    before = sm.KERNEL.entry_launches["swis_matmul_experts_launch"]
    got = sm.swis_matmul_experts_packed(
        x if x.ndim == 3 else x[None].expand(e, *x.shape),
        leaf["sign_plane"], leaf["mask_planes"], leaf["shifts"],
        leaf["scale"], n_shifts=leaf["mask_planes"].shape[1], group=group,
        consecutive=consecutive, keep_slices=keep)
    assert sm.KERNEL.entry_launches["swis_matmul_experts_launch"] == before + 1
    xe = x if x.ndim == 3 else x[None].expand(e, *x.shape)
    want = ref.swis_matmul_experts_ref(
        xe, leaf["sign_plane"], leaf["mask_planes"], leaf["shifts"],
        leaf["scale"], group=group, consecutive=consecutive, keep_slices=keep)
    assert got.shape == want.shape
    tol = TOL[x.dtype]
    for i in range(e):
        top = want[i].abs().max().item()
        err = (got[i] - want[i]).abs().max().item()
        assert torch.allclose(got[i], want[i], rtol=tol, atol=tol * top), (
            i, err, top)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 6, 7, 8, 21, 37])
def test_expert_kernel_rows(cuda_device, m):  # noqa: F811
    """Decode's live slots (M 1-8, shared rows and each expert's own) and the
    capacity path's rows per expert (21, 37: several row tiles)."""
    leaf = _stack(cuda_device, 6, 512, 192, 4, seed=m)
    g = torch.Generator(device=cuda_device).manual_seed(100 + m)
    for shape in ((m, 512), (6, m, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            _check(torch.randn(shape, generator=g, device=cuda_device).to(dtype),
                   leaf)


@pytest.mark.parametrize("k,n", [(64, 96), (96, 200), (1408, 72), (1536, 130),
                                 (320, 33), (2048, 1408)])
def test_expert_kernel_ragged_shapes(cuda_device, k, n):  # noqa: F811
    """K shorter than one stage (64, 96) and K ending inside one (1408, 320);
    N short of the 64-column tile, not a multiple of it, and not a multiple
    of 4 (130, 33: the copies the general instance makes)."""
    leaf = _stack(cuda_device, 3, k, n, 4, seed=k + n)
    g = torch.Generator(device=cuda_device).manual_seed(k * n)
    for m in (1, 4, 8, 21):
        for dtype in (torch.float32, torch.bfloat16):
            _check(torch.randn((3, m, k), generator=g, device=cuda_device).to(
                dtype), leaf)


@pytest.mark.parametrize("method", ["swis", "swis_c"])
@pytest.mark.parametrize("n_shifts", [1, 2, 3, 4, 5, 6, 7, 8])
def test_expert_kernel_planes(cuda_device, method, n_shifts):  # noqa: F811
    """1-8 planes (1-4 shift bytes a group), SWIS and SWIS-C, every
    keep_slices, fp32 and bf16 x."""
    leaf = _stack(cuda_device, 4, 768, 128, n_shifts, method=method,
                  seed=n_shifts)
    g = torch.Generator(device=cuda_device).manual_seed(7 * n_shifts)
    for keep in [None] + list(range(1, n_shifts + 1)):
        for m in (4, 9):
            for dtype in (torch.float32, torch.bfloat16):
                _check(torch.randn((4, m, 768), generator=g,
                                   device=cuda_device).to(dtype), leaf,
                       consecutive=method == "swis_c", keep=keep)


@pytest.mark.parametrize("group", [1, 2, 3, 8, 12, 32, 64, 512])
def test_expert_kernel_groups(cuda_device, group):  # noqa: F811
    """Groups other than 4: powers of two take the fast instances, the rest
    (and groups under 4) the general one; a group longer than a stage."""
    k = 1536
    leaf = _stack(cuda_device, 2, k, 96, 3, group=group, seed=group)
    g = torch.Generator(device=cuda_device).manual_seed(group)
    for m in (4, 8, 21):
        _check(torch.randn((2, m, k), generator=g, device=cuda_device), leaf,
               group=group)


def test_expert_kernel_unaligned_x(cuda_device):  # noqa: F811
    """x that is not 16-byte aligned (the wrapper stages it from a copy), for
    shared rows and each expert's own, fp32 and bf16."""
    leaf = _stack(cuda_device, 5, 256, 64, 4, seed=5)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((4, 256), (5, 4, 256)):
            flat = torch.randn((torch.Size(shape).numel() + 1,), generator=g,
                               device=cuda_device).to(dtype)
            x = flat[1:].view(shape)
            assert x.data_ptr() % 16
            _check(x, leaf)


def test_expert_kernel_dbrx_rank0_cut(cuda_device):  # noqa: F811
    """E 1 at dbrx-132b's rank-0 expert depth (K 6144: 24 stages), N cut from
    10752 to 640, M 8 as the rank-0 decode step runs it; and the reverse
    product (K 640, N 6144)."""
    g = torch.Generator(device=cuda_device).manual_seed(61)
    for k, n in ((6144, 640), (640, 6144)):
        leaf = _stack(cuda_device, 1, k, n, 4, seed=k)
        for m in (4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                _check(torch.randn((m, k), generator=g,
                                   device=cuda_device).to(dtype), leaf)


def test_expert_kernel_through_ops(cuda_device):  # noqa: F811
    """The op the MoE layer calls (``ops.swis_matmul_experts``) at qwen2-moe
    decode's shapes (E 64, M 4), rows shared and each expert's own."""
    g = torch.Generator(device=cuda_device).manual_seed(64)
    for k, n in ((2048, 1408), (1408, 2048)):
        leaf = _stack(cuda_device, 64, k, n, 4, seed=n)
        for x in (torch.randn((4, k), generator=g, device=cuda_device),
                  torch.randn((64, 4, k), generator=g, device=cuda_device)):
            got = ops.swis_matmul_experts(x, leaf)
            xe = x if x.ndim == 3 else x[None].expand(64, *x.shape)
            want = ref.swis_matmul_experts_ref(
                xe, leaf["sign_plane"], leaf["mask_planes"], leaf["shifts"],
                leaf["scale"], group=4)
            for i in range(64):
                top = want[i].abs().max().item()
                assert torch.allclose(got[i], want[i], rtol=1e-5,
                                      atol=1e-5 * top)


@pytest.mark.parametrize("bits", [9, 10])
def test_expert_kernel_refuses_wide_stacks(cuda_device, bits):  # noqa: F811
    """A stack quantized to more than 8 bits has shifts past 7, which the
    kernel's byte magnitudes and 3-bit shift lookup cannot hold: the op
    raises on the card and launches nothing; at 8 bits the same op runs."""
    leaf = _stack(cuda_device, 2, 256, 64, 4, seed=bits, bits=bits)
    shifts = leaf["shifts"]
    assert int(torch.maximum(shifts & 15, shifts >> 4).max()) >= 8
    x = torch.randn((4, 256), device=cuda_device)
    before = sm.KERNEL.entry_launches["swis_matmul_experts_launch"]
    with pytest.raises(ValueError, match="8-bit"):
        ops.swis_matmul_experts(x, leaf, bits=bits)
    assert sm.KERNEL.entry_launches["swis_matmul_experts_launch"] == before
    ops.swis_matmul_experts(x, _stack(cuda_device, 2, 256, 64, 4), bits=8)
    assert sm.KERNEL.entry_launches["swis_matmul_experts_launch"] == before + 1

"""The port's CUDA kernels on the card, against their plain PyTorch
versions on the same inputs, and the serve engine on the card against the
port's CPU path. Every test here is marked ``gpu`` and skips without a
CUDA device; this file imports no JAX, so on the card it runs as
``python -m pytest -q -m gpu tests/test_torch_*.py``."""
import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import packing, swis
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import swis_matmul as sm
from repro_torch.models import params as pp
from repro_torch.models.model import Model
from repro_torch.serve import (ContinuousBatchingEngine, EngineConfig,
                               SamplingParams)
from torch_port import cuda_device  # noqa: F401  (fixture)

pytestmark = pytest.mark.gpu


def _close(got, want, tol):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert torch.allclose(got, want, rtol=tol, atol=tol * scale), (err, scale)


@pytest.mark.parametrize("method", ["swis", "swis_c"])
def test_swis_kernel_matches_plain(cuda_device, method):  # noqa: F811
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for m, k, n, group, n_shifts in [(4, 576, 576, 4, 4), (37, 1536, 576, 4, 4),
                                     (64, 576, 1536, 4, 4), (8, 96, 128, 16, 3),
                                     (3, 64, 200, 8, 2)]:
        w = torch.randn((k, n), generator=g, device=cuda_device) * 0.05
        pw = packing.pack(swis.quantize(w, swis.QuantConfig(
            method=method, n_shifts=n_shifts, group_size=group)))
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            x = torch.randn((m, k), generator=g, device=cuda_device).to(dtype)
            for keep in (None, 1, n_shifts):
                before = sm.KERNEL.launches
                got = ops.swis_matmul(x, pw, keep_slices=keep)
                assert sm.KERNEL.launches == before + 1
                want = ref.swis_matmul_ref(
                    x, pw.sign_plane, pw.mask_planes, pw.shifts,
                    pw.scale.reshape(-1).expand(n), group=group,
                    consecutive=method == "swis_c", keep_slices=keep)
                _close(got, want, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_paged_kernel_matches_plain(cuda_device, dtype):  # noqa: F811
    rng = np.random.default_rng(3)
    b, hkv, g, dh, bs, nb, n_blocks = 3, 3, 3, 64, 8, 5, 16
    for sq, q_lens, window in ((1, None, None), (4, [4, 0, 2], None),
                               (2, [1, 2, 0], 6)):
        q = torch.from_numpy(rng.normal(0, 1, (b, sq, hkv * g, dh)).astype(
            np.float32)).to(cuda_device)
        kv = torch.from_numpy(rng.normal(0, 1, (2, n_blocks, bs, hkv, dh)).astype(
            np.float32)).to(cuda_device, dtype)
        pos = np.full((n_blocks, bs), -1, np.int32)
        pos[0] = 2  # garbage in the trash block
        tables = np.zeros((b, nb), np.int32)
        tables[0, :3], tables[1, :1] = [4, 9, 2], [7]  # row 2: all trash
        pos[4], pos[9], pos[2, :5] = np.arange(8), np.arange(8, 16), np.arange(16, 21)
        pos[7, :3] = np.arange(3)
        args = [torch.from_numpy(a).to(cuda_device) for a in
                (pos, tables, np.array([21 - sq, 3 - sq if sq < 3 else 0, 4],
                                       np.int32))]
        ql = (None if q_lens is None
              else torch.tensor(q_lens, dtype=torch.int32, device=cuda_device))
        before = pa.KERNEL.launches
        got = pa.paged_attention_decode(q, kv[0], kv[1], *args, q_lens=ql,
                                        window=window)
        assert pa.KERNEL.launches == before + 1
        want = pa.paged_attention_decode(
            q.cpu(), kv[0].cpu(), kv[1].cpu(), *(a.cpu() for a in args),
            q_lens=None if ql is None else ql.cpu(), window=window)
        assert torch.isfinite(got).all()
        _close(got.cpu(), want, 1e-5)


def test_engine_on_card_matches_cpu_path(cuda_device):  # noqa: F811
    cfg = configs.get_smoke("smollm-135m").replace(
        compute_dtype="float32", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    params = pp.init_params(Model(cfg).build(), torch.Generator().manual_seed(1),
                            device="cpu")
    ecfg = EngineConfig(max_len=48, n_slots=2, packed=True,
                        use_paged_kernel=True)
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)])
               for n in (5, 9, 3)] + [rng.integers(0, cfg.vocab, 12)]
    outs, engines = [], []
    for dev in (cuda_device, "cpu"):
        eng = ContinuousBatchingEngine(cfg, params, ecfg, device=dev)
        sm.KERNEL.launches = pa.KERNEL.launches = 0
        rids = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
        out = eng.drain()
        outs.append([out[r] for r in rids])
        engines.append(eng)
        if dev != "cpu":
            calls = eng.n_prefill_calls + eng.n_decode_steps
            assert sm.KERNEL.launches == 7 * cfg.n_layers * calls
            assert pa.KERNEL.launches == cfg.n_layers * eng.n_decode_steps
            assert eng.prefix_stats()["hits"] >= 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["swis", "swis_c"])
@pytest.mark.parametrize("shared", [True, False])
def test_swis_expert_kernel_matches_plain(cuda_device, method, shared):  # noqa: F811
    """The expert-axis launch (one launch for a stack of E packed weights)
    against its plain version, dequant then einsum: a sweep of E, M, K and
    N with ragged M and N, the experts' rows shared (expert stride 0, as
    decode's wi and wg read them) or each expert's own (wo, the capacity
    path), fp32 within rtol 1e-5 and bf16 within 2e-2."""
    from repro_torch.serve import quantized

    g = torch.Generator(device=cuda_device).manual_seed(3)
    for e, m, k, n, n_shifts in [(64, 4, 2048, 1408, 4), (64, 4, 1408, 2048, 4),
                                 (64, 21, 2048, 1408, 4), (8, 37, 256, 200, 3),
                                 (3, 1, 64, 96, 2), (5, 9, 1536, 64, 5)]:
        w = torch.randn((e, k, n), generator=g, device=cuda_device) * 0.05
        leaf = quantized.pack_tree({"wi": w}, swis.QuantConfig(
            method=method, n_shifts=n_shifts))[0]["wi"]
        c = method == "swis_c"
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            shape = (m, k) if shared else (e, m, k)
            x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
            for keep in (None, 1):
                before = sm.KERNEL.launches
                got = ops.swis_matmul_experts(x, leaf, consecutive=c,
                                              keep_slices=keep)
                assert sm.KERNEL.launches == before + 1
                xe = x[None].expand(e, m, k) if shared else x
                want = ref.swis_matmul_experts_ref(
                    xe, leaf["sign_plane"], leaf["mask_planes"],
                    leaf["shifts"], leaf["scale"], group=4, consecutive=c,
                    keep_slices=keep)
                assert got.shape == (e, m, n)
                for i in range(e):  # each expert against its own scale
                    _close(got[i], want[i], tol)
        # an x that is not 16-byte aligned is staged from a copy
        x = torch.randn((e * m * k + 1,), generator=g, device=cuda_device)
        xe = x[1:].view(e, m, k)
        got = ops.swis_matmul_experts(xe, leaf, consecutive=c)
        want = ref.swis_matmul_experts_ref(
            xe, leaf["sign_plane"], leaf["mask_planes"], leaf["shifts"],
            leaf["scale"], group=4, consecutive=c)
        _close(got, want, 1e-5)
        with pytest.raises(ValueError):
            ops.swis_matmul_experts(xe[:, :, :k - 32], leaf)


def test_moe_engine_on_card_matches_cpu_path(cuda_device):  # noqa: F811
    """The qwen2-moe smoke model, packed, in block mode with paged
    attention: the same greedy tokens on the card and the CPU path, with 10
    SWIS launches a layer per model call (4 attention, 3 shared, 3 expert
    stacks)."""
    cfg = configs.get_smoke("qwen2-moe-a2.7b").replace(
        compute_dtype="float32", d_ff=64,
        moe=configs.MoEConfig(n_experts=6, top_k=4, n_shared=2,
                              d_ff_expert=64, group_tokens=64,
                              n_experts_padded=8))
    params = pp.init_params(Model(cfg).build(), torch.Generator().manual_seed(2),
                            device="cpu")
    ecfg = EngineConfig(max_len=48, n_slots=2, packed=True,
                        use_paged_kernel=True)
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)])
               for n in (5, 9, 3)] + [rng.integers(0, cfg.vocab, 12)]
    outs = []
    for dev in (cuda_device, "cpu"):
        eng = ContinuousBatchingEngine(cfg, params, ecfg, device=dev)
        sm.KERNEL.launches = pa.KERNEL.launches = 0
        rids = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
        out = eng.drain()
        outs.append([out[r] for r in rids])
        if dev != "cpu":
            assert sm.KERNEL.launches == 10 * cfg.n_layers * eng.model_calls()
            assert pa.KERNEL.launches == cfg.n_layers * eng.arena_calls()
            assert eng.prefix_stats()["hits"] >= 1
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_swis_kernel_recurrent_shapes(cuda_device):  # noqa: F811
    """The recurrent families' GEMM shapes at their published widths: K =
    7680 (Griffin's MLP wo) and 5120 (Mamba2's out_proj), N = 10576
    (Mamba2's in_proj, not a multiple of the 32-column tile) and 256
    (Griffin's one KV head), at M = 1, 4 and 256, fp32 x, 4 planes, group
    4, against the plain version (rtol 1e-5, atol 1e-5*max|ref|)."""
    g = torch.Generator(device=cuda_device).manual_seed(16)
    for k, n in ((7680, 2560), (5120, 2560), (2560, 10576), (2560, 256)):
        w = torch.randn((k, n), generator=g, device=cuda_device) * 0.05
        pw = packing.pack(swis.quantize(w, swis.QuantConfig(
            method="swis", n_shifts=4, group_size=4)))
        for m in (1, 4, 256):
            x = torch.randn((m, k), generator=g, device=cuda_device)
            before = sm.KERNEL.launches
            got = ops.swis_matmul(x, pw)
            assert sm.KERNEL.launches == before + 1
            want = ref.swis_matmul_ref(x, pw.sign_plane, pw.mask_planes,
                                       pw.shifts, pw.scale.reshape(-1).expand(n),
                                       group=4)
            _close(got, want, 1e-5)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "mamba2-2.7b"])
def test_recurrent_engine_on_card_matches_cpu_path(cuda_device, arch):  # noqa: F811
    """The Griffin and Mamba2 smoke models, packed, through the contiguous
    fallback: the continuous engine (greedy, prompts of unequal lengths,
    Griffin's past its 8-token window) and ``DecodeEngine`` (T 0.7) give
    the CPU path's tokens on the card, with one SWIS launch per GEMM per
    model call and no paged launch."""
    from repro_torch.serve import DecodeEngine

    cfg = configs.get_smoke(arch).replace(compute_dtype="float32")
    model = Model(cfg)
    per_call = sum({"rec": 6, "attn_local": 7, "mamba": 2}[k]
                   for k in list(model.unit) * model.n_units + list(model.tail))
    params = pp.init_params(model.build(), torch.Generator().manual_seed(4),
                            device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (23, 5, 11, 11, 1)]
    batch = rng.integers(0, cfg.vocab, (3, 9)).astype(np.int32)
    outs = []
    for dev in (cuda_device, "cpu"):
        eng = ContinuousBatchingEngine(
            cfg, params, EngineConfig(max_len=48, n_slots=2, packed=True,
                                      prefix_cache=True), device=dev)
        assert eng.prefix_cache is None and eng.cache.block_size is None
        sm.KERNEL.launches = pa.KERNEL.launches = 0
        rids = [eng.submit(p, SamplingParams(max_tokens=6)) for p in prompts]
        out = eng.drain()
        if dev != "cpu":
            assert sm.KERNEL.launches == per_call * eng.model_calls()
            assert pa.KERNEL.launches == 0
        dec = DecodeEngine(cfg, params, max_len=24, batch=3, packed=True,
                           device=dev)
        outs.append([out[r] for r in rids]
                    + list(dec.generate(batch, 8, temperature=0.7, seed=2)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# -- edges of the kernels' designs: row tiles, K splits, column tiles, clusters


@pytest.mark.parametrize("method", ["swis", "swis_c"])
@pytest.mark.parametrize("n_shifts", [2, 4, 5])
def test_swis_kernel_tile_and_split_edges(cuda_device, method, n_shifts):  # noqa: F811
    """M crosses the 4-, 8- and 32-row tiles, K = 1536 and 96 split
    unevenly over the cluster's blocks and warps, N = 200 is not a multiple
    of the 32-column tile (and N = 202 leaves the shift rows unaligned to
    4 bytes for SWIS-C); group 16; every keep_slices; x at M = 9 starts off
    a 16-byte boundary."""
    g = torch.Generator(device=cuda_device).manual_seed(n_shifts)
    group = 16
    for k, n in ((1536, 200), (96, 200), (96, 202)):
        w = torch.randn((k, n), generator=g, device=cuda_device) * 0.05
        pw = packing.pack(swis.quantize(w, swis.QuantConfig(
            method=method, n_shifts=n_shifts, group_size=group)))
        for m in (1, 4, 8, 9, 256):
            x = torch.randn((m * k + 1,), generator=g, device=cuda_device)
            x = x[1:].view(m, k) if m == 9 else x[:-1].view(m, k)
            for keep in (None,) + tuple(range(1, n_shifts + 1)):
                before = sm.KERNEL.launches
                got = ops.swis_matmul(x, pw, keep_slices=keep)
                assert sm.KERNEL.launches == before + 1
                want = ref.swis_matmul_ref(
                    x, pw.sign_plane, pw.mask_planes, pw.shifts,
                    pw.scale.reshape(-1).expand(n), group=group,
                    consecutive=method == "swis_c", keep_slices=keep)
                _close(got, want, 1e-5)


def _arena(rng, *, b, sq, nb, live, hkv=3, g=3, dh=64, bs=8):
    """Arena with the engine's invariants: trash block 0 with garbage
    positions, trash-padded table tails, a partly filled last live block;
    row r holds live[r] blocks (0 = an all-trash row)."""
    n_blocks = sum(live) + 1
    q = rng.normal(0, 1, (b, sq, hkv * g, dh)).astype(np.float32)
    kv = rng.normal(0, 1, (2, n_blocks, bs, hkv, dh)).astype(np.float32)
    pos = np.full((n_blocks, bs), -1, np.int32)
    pos[0] = rng.integers(0, bs, (bs,))
    tables = np.zeros((b, nb), np.int32)
    q_pos = np.full((b,), 3, np.int32)
    free = list(rng.permutation(np.arange(1, n_blocks)))
    for r in range(b):
        if live[r] == 0:
            continue
        n_tok = (live[r] - 1) * bs + int(rng.integers(1, bs + 1))
        for j in range(live[r]):
            blk = int(free.pop())
            tables[r, j] = blk
            filled = min(bs, n_tok - j * bs)
            pos[blk, :filled] = np.arange(j * bs, j * bs + filled)
        q_pos[r] = max(n_tok - sq, 0)
    return q, kv, pos, tables, q_pos


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("nb", [1, 5, 128])
def test_paged_kernel_split_edges(cuda_device, dtype, nb):  # noqa: F811
    """nb crosses the warp split (4 a block) and the cluster split (up to 8
    blocks); Sq = 4 with a zero q_lens, an all-trash row, a window; every
    row compared with the plain version at 1e-5."""
    rng = np.random.default_rng(nb)
    live = (nb, 0, max(nb // 2, 1), max(nb - 1, 1))
    for sq, q_lens, window in ((1, None, None), (4, [4, 0, 2, 1], None),
                               (1, None, 12), (4, [1, 3, 0, 4], 6)):
        q, kv, pos, tables, q_pos = _arena(rng, b=4, sq=sq, nb=nb, live=live)
        ql = None if q_lens is None else np.array(q_lens, np.int32)
        host = [torch.from_numpy(a) for a in (q, kv, pos, tables, q_pos)]
        dev = [t.to(cuda_device) for t in host]
        before = pa.KERNEL.launches
        got = pa.paged_attention_decode(
            dev[0], dev[1][0].to(dtype), dev[1][1].to(dtype), *dev[2:],
            q_lens=None if ql is None else torch.from_numpy(ql).to(cuda_device),
            window=window)
        assert pa.KERNEL.launches == before + 1
        want = pa.paged_attention_decode(
            host[0], host[1][0].to(dtype), host[1][1].to(dtype), *host[2:],
            q_lens=None if ql is None else torch.from_numpy(ql), window=window)
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_paged_kernel_rows_off_16_bytes(cuda_device, dtype):  # noqa: F811
    """Dh = 34: K/V rows are not a whole number of 16-byte pieces, so the
    kernel copies them element by element; the result is the same."""
    rng = np.random.default_rng(11)
    q, kv, pos, tables, q_pos = _arena(rng, b=4, sq=2, nb=9, dh=34,
                                       live=(9, 0, 4, 1))
    host = [torch.from_numpy(a) for a in (q, kv, pos, tables, q_pos)]
    dev = [t.to(cuda_device) for t in host]
    got = pa.paged_attention_decode(dev[0], dev[1][0].to(dtype),
                                    dev[1][1].to(dtype), *dev[2:], window=20)
    want = pa.paged_attention_decode(host[0], host[1][0].to(dtype),
                                     host[1][1].to(dtype), *host[2:], window=20)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_kernels_repeat_runs_bit_identical(cuda_device):  # noqa: F811
    """The same inputs twice through each kernel give the same bits: the
    designs reduce across warps and blocks in a fixed order."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    w = torch.randn((1536, 576), generator=g, device=cuda_device) * 0.05
    pw = packing.pack(swis.quantize(w, swis.QuantConfig(
        method="swis", n_shifts=4, group_size=4)))
    for m in (4, 256):
        x = torch.randn((m, 1536), generator=g, device=cuda_device)
        assert torch.equal(ops.swis_matmul(x, pw), ops.swis_matmul(x, pw))
    rng = np.random.default_rng(8)
    q, kv, pos, tables, q_pos = _arena(rng, b=4, sq=1, nb=128,
                                       live=(125, 0, 60, 127))
    q, kv, pos, tables, q_pos = (torch.from_numpy(a).to(cuda_device)
                                 for a in (q, kv, pos, tables, q_pos))
    runs = [pa.paged_attention_decode(q, kv[0], kv[1], pos, tables, q_pos)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_paged_kernel_many_query_rows(cuda_device, dtype):  # noqa: F811
    """Sq*G = 192 and 384 query rows (Sq 64 and 128 over G = 3), past what
    one block's shared memory could stage at once, in row tiles; q_lens
    mixes 0, 1 and full as the fused mixed step's decode and chunk rows do.
    Every row against the plain version at 1e-5, and a repeat run
    bit-identical."""
    rng = np.random.default_rng(12)
    for sq in (64, 128):
        live = (sq // 8 + 2, 0, 3, sq // 8 + 1)
        q, kv, pos, tables, q_pos = _arena(rng, b=4, sq=sq, nb=sq // 8 + 4,
                                           live=live)
        ql = np.array([sq, 0, 1, sq - 5], np.int32)
        host = [torch.from_numpy(a) for a in (q, kv, pos, tables, q_pos, ql)]
        dev = [t.to(cuda_device) for t in host]
        k, v = dev[1][0].to(dtype), dev[1][1].to(dtype)
        got = pa.paged_attention_decode(dev[0], k, v, *dev[2:5], q_lens=dev[5])
        again = pa.paged_attention_decode(dev[0], k, v, *dev[2:5], q_lens=dev[5])
        assert torch.equal(got, again)
        want = pa.paged_attention_decode(
            host[0], host[1][0].to(dtype), host[1][1].to(dtype), *host[2:5],
            q_lens=host[5])
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_sampler_bits_on_card_equal_cpu(cuda_device):  # noqa: F811
    """The threefry draws are integer arithmetic: on the card they give the
    CPU's bits and uniforms exactly, and the seeded sampler the same
    tokens."""
    from repro_torch.serve import prng, sample_step

    keys = torch.stack([prng.fold_in(prng.key(s), s * 7 + 1)
                        for s in (0, 1, 12345, -3)])
    for n in (1, 777, 49152):
        cpu = prng.random_bits(keys, n)
        assert torch.equal(prng.random_bits(keys.to(cuda_device), n).cpu(), cpu)
        assert torch.equal(prng.uniform(keys.to(cuda_device), n).cpu(),
                           prng.uniform(keys, n))
    logits = torch.from_numpy(np.random.default_rng(0).normal(
        0, 4, (4, 4096)).astype(np.float32))
    temps = np.array([0.8, 0.0, 1.5, 0.8], np.float32)
    for step in range(8):
        steps = np.full(4, step, np.int32)
        got = sample_step(logits.to(cuda_device), keys, steps, temps).cpu()
        assert torch.equal(got, sample_step(logits, keys, steps, temps))


def test_engine_paths_on_card_match_cpu_path(cuda_device):  # noqa: F811
    """Chunked prefill, the fused mixed step, speculative decode, seeded
    sampling and the contiguous mode give the CPU path's tokens on the
    card, with one paged launch per layer per arena call and one SWIS launch
    per GEMM per model call."""
    cfg = configs.get_smoke("smollm-135m").replace(
        compute_dtype="float32", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    params = pp.init_params(Model(cfg).build(), torch.Generator().manual_seed(2),
                            device="cpu")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (37, 9, 21, 4)]
    base = dict(max_len=64, n_slots=2, packed=True, use_paged_kernel=True)
    for kw, temp in ((dict(prefill_chunk=16), 0.0),
                     (dict(prefill_chunk=16, fused_step=True), 0.7),
                     (dict(spec_decode=True, spec_k=3, draft_slices=2), 0.0),
                     (dict(spec_decode=True, spec_k=2), 0.7),
                     (dict(prefix_cache=False, use_paged_kernel=False), 0.7)):
        outs = []
        for dev in (cuda_device, "cpu"):
            eng = ContinuousBatchingEngine(
                cfg, params, EngineConfig(**{**base, **kw}), device=dev)
            sm.KERNEL.launches = pa.KERNEL.launches = 0
            rids = [eng.submit(p, SamplingParams(max_tokens=7, temperature=temp,
                                                 seed=i))
                    for i, p in enumerate(prompts)]
            out = eng.drain()
            outs.append([out[r] for r in rids])
            if dev != "cpu":
                assert sm.KERNEL.launches == 7 * cfg.n_layers * eng.model_calls()
                assert pa.KERNEL.launches == cfg.n_layers * eng.arena_calls()
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)


def test_engine_metrics_on_card_match_cpu_path(cuda_device):  # noqa: F811
    """With metrics on, the card's counters (``cost.*`` included),
    scheduler gauges, prefix stats and trace events equal the CPU path's
    on the gather path; with the paged kernel the cost model counts no
    gathered K/V (``paged_impl`` "cuda") and every other counter but the
    HBM bytes still equals the CPU's."""
    cfg = configs.get_smoke("smollm-135m").replace(
        compute_dtype="float32", d_model=64, n_heads=4, n_kv_heads=2, d_ff=128)
    params = pp.init_params(Model(cfg).build(), torch.Generator().manual_seed(3),
                            device="cpu")
    rng = np.random.default_rng(6)
    shared = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab, n)])
               for n in (5, 9)] + [rng.integers(0, cfg.vocab, 21)]
    for paged in (False, True):
        snaps = []
        for dev in (cuda_device, "cpu"):
            eng = ContinuousBatchingEngine(cfg, params, EngineConfig(
                max_len=64, n_slots=2, packed=True, prefill_chunk=16,
                use_paged_kernel=paged), device=dev)
            for i, p in enumerate(prompts):
                eng.submit(p, SamplingParams(max_tokens=6, seed=i))
                eng.step()
            eng.drain()
            m = eng.metrics()
            assert m["engine"]["counters"]["step.model_dispatches"] == \
                eng.model_calls()
            assert "step.device_sync_s" in m["engine"]["phases"]
            snaps.append((m["engine"]["counters"], m["scheduler"],
                          m["prefix_cache"], eng.paged_impl,
                          [(e.kind, e.rid, e.fields)
                           for e in eng.tracer.events()]))
        (card, *card_rest), (cpu, *cpu_rest) = snaps
        assert card_rest[:2] == cpu_rest[:2] and card_rest[3] == cpu_rest[3]
        if not paged:
            assert card == cpu and card_rest[2] is cpu_rest[2] is None
            continue
        assert (card_rest[2], cpu_rest[2]) == ("cuda", "xla")
        assert "cost.gathered_bytes" not in card and cpu["cost.gathered_bytes"]
        moved = {k for k in cpu if "hbm_bytes" in k or "gathered" in k}
        assert {k: v for k, v in card.items() if k not in moved} == \
            {k: v for k, v in cpu.items() if k not in moved}


# -- the encoder and VLM families: large M, 32 heads over 8, patches


def test_swis_kernel_large_m(cuda_device):  # noqa: F811
    """The row counts of the encoder and of the VLM's cross-attention K/V:
    hubert-xlarge's layer GEMMs (K 1280 and 5120) at M = 2000 (4 clips of
    500 frames) and ``xattn``'s wk/wv (K 4096, N 1024) at M = 4096 (4
    images of 1024 patches), fp32 x, 4 planes, group 4, against the plain
    version (rtol 1e-5, atol 1e-5*max|ref|)."""
    g = torch.Generator(device=cuda_device).manual_seed(17)
    for m, k, n in ((2000, 1280, 1280), (2000, 1280, 5120),
                    (2000, 5120, 1280), (4096, 4096, 1024)):
        w = torch.randn((k, n), generator=g, device=cuda_device) * 0.05
        pw = packing.pack(swis.quantize(w, swis.QuantConfig(
            method="swis", n_shifts=4, group_size=4)))
        x = torch.randn((m, k), generator=g, device=cuda_device)
        before = sm.KERNEL.launches
        got = ops.swis_matmul(x, pw)
        assert sm.KERNEL.launches == before + 1
        want = ref.swis_matmul_ref(x, pw.sign_plane, pw.mask_planes,
                                   pw.shifts, pw.scale.reshape(-1).expand(n),
                                   group=4)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_paged_kernel_vlm_heads(cuda_device, dtype):  # noqa: F811
    """llama-3.2-vision-11b's heads: 32 query heads over 8 KV heads (G 4)
    of Dh 128, B 4 over 16 logical blocks, decode (Sq 1) and Sq 4 with a
    zero q_lens; every row against the plain version at 1e-5."""
    rng = np.random.default_rng(18)
    for sq, q_lens in ((1, None), (4, [4, 0, 2, 1])):
        q, kv, pos, tables, q_pos = _arena(rng, b=4, sq=sq, nb=16,
                                           live=(12, 9, 0, 16), hkv=8, g=4,
                                           dh=128)
        ql = None if q_lens is None else np.array(q_lens, np.int32)
        host = [torch.from_numpy(a) for a in (q, kv, pos, tables, q_pos)]
        dev = [t.to(cuda_device) for t in host]
        before = pa.KERNEL.launches
        got = pa.paged_attention_decode(
            dev[0], dev[1][0].to(dtype), dev[1][1].to(dtype), *dev[2:],
            q_lens=None if ql is None else torch.from_numpy(ql).to(cuda_device))
        assert pa.KERNEL.launches == before + 1
        want = pa.paged_attention_decode(
            host[0], host[1][0].to(dtype), host[1][1].to(dtype), *host[2:],
            q_lens=None if ql is None else torch.from_numpy(ql))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_vlm_and_encoder_on_card_match_cpu_path(cuda_device):  # noqa: F811
    """The VLM smoke model (xgate 0.5), packed, in block mode with paged
    attention: image and text requests give the CPU path's tokens, with 14
    SWIS launches a unit per model call plus 4 per unit for a prefill that
    carries patches, and one paged launch a layer per arena call; the
    encoder smoke model's ``apply`` logits equal the CPU's."""
    cfg = configs.get_smoke("llama-3.2-vision-11b").replace(
        compute_dtype="float32")
    model = Model(cfg)
    params = pp.init_params(model.build(), torch.Generator().manual_seed(5),
                            device="cpu")
    params["blocks"]["sub1_self_cross"]["xgate"].fill_(0.5)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (13, 20, 40)]
    patches = rng.normal(0, 1, (2, cfg.vlm.n_patches,
                                cfg.vlm.vision_dim)).astype(np.float32)
    extras = [{"patches": patches[0]}, None, {"patches": patches[1]}]
    outs = []
    for dev in (cuda_device, "cpu"):
        eng = ContinuousBatchingEngine(cfg, params, EngineConfig(
            max_len=48, n_slots=3, packed=True, use_paged_kernel=True),
            device=dev)
        sm.KERNEL.launches = pa.KERNEL.launches = 0
        rids = [eng.submit(p, SamplingParams(max_tokens=6), extra=ex)
                for p, ex in zip(prompts, extras)]
        out = eng.drain()
        outs.append([out[r] for r in rids])
        if dev != "cpu":
            # three buckets (16, 32, 48): three prefill calls, two of
            # them with patches
            assert eng.n_prefill_calls == 3
            image_calls = 2
            assert sm.KERNEL.launches == (14 * model.n_units
                                          * eng.model_calls()
                                          + 4 * model.n_units * image_calls)
            assert pa.KERNEL.launches == cfg.n_layers * eng.arena_calls()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)

    hcfg = configs.get_smoke("hubert-xlarge").replace(compute_dtype="float32")
    hmodel = Model(hcfg)
    hparams = pp.init_params(hmodel.build(), torch.Generator().manual_seed(6),
                             device="cpu")
    frames = torch.from_numpy(rng.normal(0, 1, (2, 40, hcfg.d_model)).astype(
        np.float32))
    want = hmodel.apply(hparams, {"frames": frames})[0]
    got = hmodel.apply(pp.tree_map(lambda a: a.to(cuda_device), hparams),
                       {"frames": frames.to(cuda_device)})[0]
    _close(got.cpu(), want, 1e-4)


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen2-moe-a2.7b"])
def test_qat_step_on_card_matches_cpu(cuda_device, arch):  # noqa: F811
    """One SWIS QAT train step (float32 compute) of a smoke model on the
    card against the CPU plain path from the same params and batch: the
    fake-quantized weights bit-identical (integer selection), the loss
    within rtol 1e-5, each gradient leaf within 1e-4 x its max |g|, and
    the updated weights: none more than 2.05 x lr apart and at most 1e-4
    of them more than 0.01 x lr (AdamW's first step moves a weight by lr x
    g / (|g| + 1e-8), so a gradient within its rounding of 0 can move it
    either way)."""
    from repro_torch.configs.base import QuantPolicy
    from repro_torch.core.qat import quantize_tree
    from repro_torch.data import SyntheticPipeline
    from repro_torch.optim import AdamW, warmup_cosine
    from repro_torch.train.steps import (init_state, make_grad_fn,
                                         make_train_step)

    fields = dict(d_model=64, n_heads=4, n_kv_heads=2, d_ff=128) if (
        arch == "smollm-135m") else {}
    cfg = configs.get_smoke(arch).replace(
        compute_dtype="float32", quant=QuantPolicy(
            cfg=swis.QuantConfig(method="swis", n_shifts=2.5), mode="qat"),
        **fields)
    model = Model(cfg)
    params = pp.init_params(model.build(), torch.Generator().manual_seed(2),
                            device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticPipeline(cfg, 32, 4, seed=1).batch_at(0).items()}
    lr = 3e-3
    outs = []
    for dev in (cuda_device, torch.device("cpu")):
        p = pp.tree_map(lambda a: a.to(dev), params)
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            q = quantize_tree(p, cfg.quant.cfg)
        grads, metrics = make_grad_fn(model)(p, b)
        state, _ = make_train_step(model, AdamW(), warmup_cosine(lr, 1, 10))(
            init_state(p), b)
        outs.append((q, grads, state.params, float(metrics["loss"])))
    (qc, gc, pc, lc), (qh, gh, ph, lh) = outs
    assert abs(lc - lh) <= 1e-5 * abs(lh)

    def walk(a, b, fn):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], fn)
        else:
            fn(a, b)

    walk(qc, qh, lambda a, b: torch.testing.assert_close(
        a.cpu(), b, rtol=0, atol=0))
    walk(gc, gh, lambda a, b: (a is None and b is None) or torch.testing.
         assert_close(a.cpu(), b, rtol=0, atol=1e-4 * b.abs().max().item()))
    far, total = [], []

    def params_close(a, b):
        d = (a.cpu() - b).abs() / lr
        assert d.max().item() <= 2.05
        far.append(int((d > 0.01).sum()))
        total.append(d.numel())

    walk(pc, ph, params_close)
    assert sum(far) <= 1e-4 * sum(total), (sum(far), sum(total))


@pytest.mark.parametrize("shared", [True, False])
def test_swis_expert_backward_on_card(cuda_device, shared):  # noqa: F811
    """The expert-axis launch's x-gradient on the card against autograd
    through its plain version (dequant, then einsum): ``g[e] @
    dequant(w[e]).T`` for each expert, summed over the experts for rows
    they share; fp32 within rtol 1e-5 of max |grad|."""
    from repro_torch.serve import quantized

    g = torch.Generator(device=cuda_device).manual_seed(4)
    e, m, k, n = 8, 5, 256, 192
    w = torch.randn((e, k, n), generator=g, device=cuda_device) * 0.05
    leaf = quantized.pack_tree({"wi": w}, swis.QuantConfig(n_shifts=3))[0]["wi"]
    shape = (m, k) if shared else (e, m, k)
    x = torch.randn(shape, generator=g, device=cuda_device)
    gy = torch.randn((e, m, n), generator=g, device=cuda_device)
    for keep in (None, 2):
        xa = x.clone().requires_grad_(True)
        before = sm.KERNEL.launches
        ops.swis_matmul_experts(xa, leaf, keep_slices=keep).backward(gy)
        assert sm.KERNEL.launches == before + 1
        xb = x.clone().requires_grad_(True)
        xe = xb[None].expand(e, m, k) if shared else xb
        ref.swis_matmul_experts_ref(
            xe, leaf["sign_plane"], leaf["mask_planes"], leaf["shifts"],
            leaf["scale"], group=4, keep_slices=keep).backward(gy)
        _close(xa.grad, xb.grad, 1e-5)


def test_budget_on_card_matches_cpu(cuda_device):  # noqa: F811
    """The cross-layer budget at a 2-layer cut of smollm-135m at its
    published widths (14 units): the sensitivity profile on the card within
    rtol 1e-5 of the CPU's (the card's scale may round ``amax / 255`` one
    ulp apart, and so a magnitude), identical allocations at 2.0, 2.5 and
    3.0, and
    bit-identical fake-quantized leaves; the exact scheduler's per-column
    costs of layer 0's wq equal on both."""
    from repro_torch.core import budget, scheduling

    cfg = configs.get_config("smollm-135m").replace(n_layers=2)
    params = pp.init_params(Model(cfg).build(),
                            torch.Generator().manual_seed(0), device="cpu")
    qcfg = swis.QuantConfig(method="swis", group_size=4)
    levels = (1, 2, 3, 4, 5)
    card = pp.tree_map(lambda a: a.to(cuda_device), params)
    prof_card = budget.sensitivity_profile(card, qcfg, levels)
    prof_cpu = budget.sensitivity_profile(params, qcfg, levels)
    assert list(prof_card) == list(prof_cpu) and len(prof_cpu) == 14
    for unit, want in prof_cpu.items():
        for n in levels:
            assert abs(prof_card[unit][n] - want[n]) <= 1e-5 * abs(want[n])
    sizes = budget.leaf_sizes(params)
    for target in (2.0, 2.5, 3.0):
        a_card = budget.allocate(prof_card, sizes, target, levels)
        a_cpu = budget.allocate(prof_cpu, sizes, target, levels)
        assert a_card.shifts == a_cpu.shifts
    q_card = budget.quantize_with_allocation(card, qcfg, a_cpu)
    q_cpu = budget.quantize_with_allocation(params, qcfg, a_cpu)
    for key in ("wq", "wk", "wv", "wo"):
        assert torch.equal(q_card["blocks"]["sub0_attn"]["attn"][key]["w"]
                           .cpu(), q_cpu["blocks"]["sub0_attn"]["attn"][key]
                           ["w"])
    for key in ("wi", "wg", "wo"):
        assert torch.equal(q_card["blocks"]["sub0_attn"]["mlp"][key]["w"]
                           .cpu(), q_cpu["blocks"]["sub0_attn"]["mlp"][key]
                           ["w"])
    w = params["blocks"]["sub0_attn"]["attn"]["wq"]["w"][0]
    costs = []
    for dev in (cuda_device, torch.device("cpu")):
        mags, signs, _ = swis._to_int_domain(w.to(dev), 8, False)
        costs.append({n: swis._column_costs(mags, signs, n, qcfg)[1].cpu()
                      for n in (1, 2, 3, 4)})
    for n in (1, 2, 3, 4):
        assert torch.equal(costs[0][n], costs[1][n])
    sched = scheduling.schedule_layer(lambda n: costs[0][n], 2.5,
                                      levels=[1, 2, 3, 4], sa_cols=8)
    assert sched.effective_shifts == 2.5


def test_quantize_and_pack_on_card_equal_cpu(cuda_device):  # noqa: F811
    """SWIS quantization and packing on the card give the CPU's bits. The
    scale ``amax / 255`` divides on both devices, as the reference does
    (ATen on CUDA would multiply by a Python divisor's reciprocal, one ulp
    off at times, and a magnitude rounded from that scale moves):
    ``quantize`` at 4 and 2.5 shifts of 8 seeded matrices, and the batched
    stack packing of ``pack_tree``."""
    from repro_torch.serve import quantized

    g = torch.Generator().manual_seed(3)
    fields = ("qweights", "qmags", "signs", "masks", "shifts", "scale",
              "col_shifts", "cost")
    for _ in range(8):
        w = torch.randn((576, 256), generator=g) * 0.05
        for n_shifts in (4, 2.5):
            cfg = swis.QuantConfig(n_shifts=n_shifts)
            a = swis.quantize(w.to(cuda_device), cfg)
            b = swis.quantize(w, cfg)
            for f in fields:
                assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    stack = torch.randn((3, 576, 192), generator=g) * 0.05
    cfg = swis.QuantConfig(n_shifts=3)
    got = quantized.pack_tree({"wi": stack.to(cuda_device)}, cfg)[0]["wi"]
    want = quantized.pack_tree({"wi": stack}, cfg)[0]["wi"]
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


def test_one_rank_nccl_trainer_on_card(cuda_device, tmp_path):  # noqa: F811
    """A one-rank NCCL group and a (1, 1) mesh on the card: the sharded
    trainer's losses are the unsharded trainer's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import configs as C
    from repro_torch.train.loop import Trainer

    cfg = C.get_smoke("phi3-mini-3.8b")
    kw = dict(seq_len=32, global_batch=8, total_steps=3, warmup=1)
    want = Trainer(cfg, **kw).run(3)["losses"]
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'r'}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        got = Trainer(cfg, mesh=mesh, **kw).run(3)["losses"]
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got, want, rtol=1e-6)

"""Port parity: paged attention's plain PyTorch version (what the port's
wrapper runs on CPU tensors) against the JAX reference's scan
(``impl="xla"``) and Pallas kernel (``impl="pallas_interpret"``) at
rtol = atol = 1e-5 on ALL rows, masked queries included: a fully masked
query row is not zero in the reference (masked scores and the running max
share one fill), and the port reproduces that value. Covers Sq = 1 and
Sq > 1 with ``q_lens`` holding 0, windows, trash blocks, an all-trash
table, and fp16 / bf16 caches."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import mask_value, paged_attention_decode

pytest.importorskip("jax")  # the card's test environment has no JAX
import jax.numpy as jnp  # noqa: E402
from repro.kernels.paged_attention import mask_value as jmask_value  # noqa: E402
from repro.kernels.paged_attention import paged_attention_decode as jpaged  # noqa: E402

BS = 8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _arena(seed, *, b=3, sq=1, nb=4, n_blocks=11, hkv=2, g=2, dh=16,
           all_trash_row=False):
    """Random arena with the engine's invariants: block 0 is trash (with
    garbage positions), tables have trash-padded tails, the last live
    block of each row is partly filled."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1, (b, sq, hkv * g, dh)).astype(np.float32)
    k = rng.normal(0, 1, (n_blocks, BS, hkv, dh)).astype(np.float32)
    v = rng.normal(0, 1, (n_blocks, BS, hkv, dh)).astype(np.float32)
    pos = np.full((n_blocks, BS), -1, np.int32)
    pos[0] = rng.integers(0, 8, (BS,))
    tables = np.zeros((b, nb), np.int32)
    q_pos = np.zeros((b,), np.int32)
    free = list(range(1, n_blocks))
    for r in range(b):
        if all_trash_row and r == b - 1:
            q_pos[r] = 5
            continue
        n_live = int(rng.integers(1, nb + 1))
        n_tok = (n_live - 1) * BS + int(rng.integers(1, BS + 1))
        for j in range(n_live):
            blk = free.pop()
            tables[r, j] = blk
            filled = min(BS, n_tok - j * BS)
            pos[blk, :filled] = np.arange(j * BS, j * BS + filled)
        q_pos[r] = max(n_tok - sq, 0)
    return q, k, v, pos, tables, q_pos


def _both(arrays, q_lens, dtype, *, causal, window):
    q, k, v, pos, tables, q_pos = arrays
    jdt, tdt = DTYPES[dtype]
    jq = None if q_lens is None else jnp.asarray(q_lens, jnp.int32)
    tq = None if q_lens is None else torch.tensor(q_lens, dtype=torch.int32)
    got = paged_attention_decode(
        torch.from_numpy(q), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(pos),
        torch.from_numpy(tables), torch.from_numpy(q_pos), q_lens=tq,
        causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    outs = {impl: np.asarray(jpaged(
        jnp.asarray(q), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(pos), jnp.asarray(tables), jnp.asarray(q_pos),
        q_lens=jq, causal=causal, window=window, impl=impl))
        for impl in ("xla", "pallas_interpret")}
    return got.numpy(), outs


CASES = [
    # (sq, q_lens, causal, window, dtype)
    (1, None, True, None, "float32"),
    (1, None, True, 12, "float32"),
    (1, None, False, None, "float32"),
    (4, [4, 0, 2], True, None, "float32"),
    (4, [1, 3, 0], True, 6, "float32"),
    (1, None, True, None, "bfloat16"),
    (2, [2, 1, 0], True, None, "float16"),
]


@pytest.mark.parametrize("sq,q_lens,causal,window,dtype", CASES)
def test_plain_matches_reference_on_all_rows(sq, q_lens, causal, window,
                                             dtype):
    arrays = _arena(sq * 10 + len(dtype), sq=sq)
    got, outs = _both(arrays, q_lens, dtype, causal=causal, window=window)
    for impl, want in outs.items():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=impl)
    if q_lens is not None and 0 in q_lens:
        # the reference's masked queries are not zero; neither are ours
        r = q_lens.index(0)
        assert np.abs(got[r]).max() > 0


def test_all_trash_row_is_finite_and_matches():
    arrays = _arena(3, all_trash_row=True)
    got, outs = _both(arrays, None, "float32", causal=True, window=None)
    assert np.all(np.isfinite(got))
    for want in outs.values():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # an all-masked row averages V over the positions its table visits
    _, _, v, _, _, _ = arrays
    mean_v = v[0].mean(axis=0)  # (hkv, dh): the trash block, nb times
    np.testing.assert_allclose(got[-1, 0].reshape(2, 2, 16),
                               np.repeat(mean_v[:, None], 2, axis=1),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mask_value_matches_reference(dtype):
    assert mask_value(DTYPES[dtype][1]) == jmask_value(DTYPES[dtype][0])

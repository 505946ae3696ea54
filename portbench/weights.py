"""Random weights of a configuration, drawn on the device from the seed.

The benchmark serves a SWIS-packed checkpoint, as a deployment loads one:
every GEMM weight that the port packs is drawn directly in the packed
format (random sign and mask bit-planes, four distinct 3-bit shifts a group
in ascending order, one scale a column), and every other leaf (embeddings,
norms, router) is drawn as a float. The program and the reference get the
same tensors; the reference dequantizes the planes itself
(``reference/swis.py``). No shift selection runs: it is the offline
quantizer's work, which a serving user never pays.

The tree's names and shapes come from the port's own parameter builder
(``Model.build`` and ``pack_placeholders``): they are the checkpoint's
format. Every value comes from one ``torch.Generator`` seeded with
``--seed``, one large call a leaf (stacked over layers), so the same seed
gives the same weights, on the card and again for the reference.
"""
from __future__ import annotations

import itertools
import math

import torch

N_PLANES, SHIFT_BITS = 4, 3
# every set of 4 distinct shifts out of 0..7, ascending, nibble-packed two
# a byte (low nibble first)
COMBOS = list(itertools.combinations(range(1 << SHIFT_BITS), N_PLANES))
# rms of sum(mask_j * 2**shift_j) over the combos and fair mask bits
MAG_RMS = math.sqrt(sum(
    sum(sum(2 ** c[j] for j in range(N_PLANES) if m >> j & 1) ** 2
        for m in range(1 << N_PLANES)) / (1 << N_PLANES)
    for c in COMBOS) / len(COMBOS))
CHUNK_ELEMS = 1 << 27  # elements a draw of a stacked leaf handles at once


def _nibbles(device) -> torch.Tensor:
    return torch.tensor([[c[0] | c[1] << 4, c[2] | c[3] << 4] for c in COMBOS],
                        dtype=torch.uint8, device=device)


def _bits(shape, gen, device) -> torch.Tensor:
    """Uniform random int32 words (every bit fair)."""
    *lead, c = shape
    raw = torch.randint(0, 256, (*lead, 4 * c), generator=gen,
                        dtype=torch.uint8, device=device)
    return raw.view(torch.int32)


def _shifts(shape, gen, device) -> torch.Tensor:
    """(..., K/M, C, 2) nibble-packed ascending shift sets, drawn per group
    in row chunks so the index tensor stays small."""
    *lead, c, two = shape
    table = _nibbles(device)
    idx = torch.randint(0, len(COMBOS), (*lead, c), generator=gen,
                        dtype=torch.uint8, device=device)
    flat = idx.reshape(-1, c)
    out = torch.empty((flat.shape[0], c, two), dtype=torch.uint8,
                      device=device)
    step = max(1, CHUNK_ELEMS // c)
    for lo in range(0, flat.shape[0], step):
        out[lo:lo + step] = table[flat[lo:lo + step].long()]
    return out.reshape(shape)


def _packed(leaf: dict, gen, device) -> dict:
    k = leaf["sign_plane"].shape[-2] * 32
    scale = 1.0 / (math.sqrt(k) * MAG_RMS)  # weights of std 1/sqrt(K)
    return {
        "sign_plane": _bits(leaf["sign_plane"].shape, gen, device),
        "mask_planes": _bits(leaf["mask_planes"].shape, gen, device),
        "shifts": _shifts(leaf["shifts"].shape, gen, device),
        "scale": torch.full(leaf["scale"].shape, scale, dtype=torch.float32,
                            device=device),
    }


def _dense(p, gen, device) -> torch.Tensor:
    if p.init == "ones":
        return torch.ones(p.shape, dtype=torch.float32, device=device)
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=torch.float32, device=device)
    if p.init == "embed":
        std = p.scale if p.scale is not None else 1.0
    else:
        fan_in = p.shape[-2] if len(p.shape) >= 2 else p.shape[-1]
        std = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std)


def placeholders(cfg, qcfg):
    """The packed checkpoint's placeholder tree (names, shapes, kinds)."""
    from repro_torch.models.model import Model
    from repro_torch.serve.quantized import pack_placeholders

    return pack_placeholders(Model(cfg).build(), qcfg)


def make(tree, seed: int, device) -> dict:
    """Tensors for every leaf of ``tree`` from ``seed``, in the tree's
    order: packed dicts as random planes, the rest as floats."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def walk(node):
        if isinstance(node, dict):
            if "mask_planes" in node:
                return _packed(node, gen, device)
            return {k: walk(v) for k, v in node.items()}
        return _dense(node, gen, device)

    return walk(tree)

"""Slot KV cache for continuous batching (PyTorch port of
``repro.serve.kv_cache``): a block arena behind block tables, or contiguous
per-slot rows.

**Block mode** (the serving default, and what the prefix cache needs): the
KV arena is ``n_blocks`` physical blocks of ``block_size`` token
positions: every cache leaf's batch axis is the physical block axis
(``k``: (layers, n_blocks, block_size, hkv, dh), ``pos``: (layers,
n_blocks, block_size)). Each slot owns a row of ``block_tables`` mapping
its logical block ``i`` (positions ``[i*bs, (i+1)*bs)``) to a physical
block, so decode reads its K/V through the table and slots whose tables
share a physical block share that KV with no copy (prefix caching). Block 0
is the trash block: free slots' rows point at it, and a table entry of 0
means "invalid" to the attention mask.

**Contiguous mode** (``block_size=None``): one cache tree whose batch axis
is the slot axis, each slot a row of ``max_len`` positions; prefill fills a
fresh tree and :meth:`SlotKVCache.write_slots` copies its rows in. It
serves the families whose caches are not full-length attention caches:
recurrent state (Griffin's ``rec``, Mamba2's ``mamba``), which has no
position plane, and window-truncated rings (``attn_local``). The slot axis
is 1 under ``"blocks"`` (after the stacked-layers axis) and 0 under
``"tail"``, whose layers are unstacked.

Each slot's attention leaves have their own position plane, and attention
admits only entries whose ``pos`` is valid (>= 0).

Speculative decode writes K/V for proposed tokens into a slot's owned
blocks before it knows which survive, and needs no rollback: rejected
positions lie beyond every later query position until the next feed
rewrites them, so the causal mask keeps them unread; the per-row draft
budget keeps every write inside blocks the slot owns; and blocks are
committed to the prefix trie only at release, after the verify launch has
rewritten every fed position at full precision.

The trees are updated in place (decode, ``scatter_row``, ``write_slots``
and ``invalidate_blocks`` write into them) where the reference's jitted
updates donated them.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.models import params as pp


# slot axis per top-level cache subtree: the stacked "blocks" leaves carry
# a leading layer axis, the unrolled "tail" leaves do not
_SLOT_AXIS = {"blocks": 1, "tail": 0}


def _is_attn_cache(d) -> bool:
    return isinstance(d, dict) and set(d) == {"k", "v", "pos"}


class SlotKVCache:
    """Batched per-slot cache: block-table indirection or contiguous rows."""

    def __init__(self, model, n_slots: int, max_len: int,
                 dtype: Any = torch.float32, block_size: Optional[int] = 8,
                 n_blocks: Optional[int] = None, device="cuda"):
        self.model = model
        self.n_slots = n_slots
        self.max_len = max_len
        self.dtype = dtype
        self.block_size = block_size
        self.device = torch.device(device)
        if block_size is None:
            self.tree = self.fresh(n_slots)
            return
        self.blocks_per_slot = -(-max_len // block_size)
        self.eff_len = self.blocks_per_slot * block_size
        # +1 for the reserved trash block; the default leaves room for two
        # slots' worth of cached-but-unreferenced prefix blocks
        self.n_blocks = n_blocks or (
            n_slots * self.blocks_per_slot + 2 * self.blocks_per_slot + 1)
        self.tree = self.fresh(self.n_blocks, block_size)
        self.block_tables = np.zeros((n_slots, self.blocks_per_slot), np.int32)
        self._tables_dev = None  # refreshed lazily after table mutations

    @staticmethod
    def supports_blocks(model, max_len: int) -> bool:
        """Block mode applies iff every cache leaf is a standard attention
        cache spanning the full ``max_len``, stacked under ``"blocks"``
        (the block-mode helpers walk that subtree only): no recurrent
        state, no window-truncated ring, no tail."""
        spec = model.build_cache(1, max_len, per_slot=True)
        for key, sub in spec.items():
            if key != "blocks":
                return False
            for blk in sub.values():
                if not _is_attn_cache(blk) or blk["k"].shape[-3] != max_len:
                    return False
        return True

    def fresh(self, batch: int, length: Optional[int] = None):
        """A new zero-initialized ``batch``-row cache tree of ``length``
        positions (pos planes all -1). Always a new allocation: prefill
        writes into its working tree in place."""
        length = length or (self.eff_len if self.block_size else self.max_len)
        tree = self.model.build_cache(batch, length, self.dtype, per_slot=True)
        return pp.init_params(tree, None, device=self.device)

    # -- contiguous mode ----------------------------------------------------

    def write_slots(self, slot_tree, slots: Sequence[int]) -> None:
        """Copy the rows of a ``len(slots)``-row tree into rows ``slots`` of
        the live cache (contiguous mode, after prefilling admitted
        requests)."""
        if self.block_size is not None:
            raise ValueError("write_slots is for the contiguous mode")
        idx = torch.as_tensor(np.asarray(slots, np.int64), device=self.device)
        for key, sub in self.tree.items():
            for name, leaves in sub.items():
                for leaf, live in leaves.items():
                    # every leaf, the recurrent state's too
                    if _SLOT_AXIS[key] == 1:
                        live[:, idx] = slot_tree[key][name][leaf]
                    else:
                        live[idx] = slot_tree[key][name][leaf]

    @staticmethod
    def mask_pos_tail(slot_tree, valid_lens: Sequence[int]):
        """Invalidate (-1) each row's pos entries at index >=
        ``valid_lens[r]``: bucket-padded prefill records positions for its
        pad tokens too, and they must never enter an attention mask. Only
        position planes change; recurrent state has none. Updates
        ``slot_tree`` in place and returns it."""
        for sub in slot_tree.values():
            for leaves in sub.values():
                pos = leaves.get("pos")  # (layers, g, length) or (g, length)
                if pos is None:
                    continue
                valid = torch.as_tensor(np.asarray(valid_lens, np.int64),
                                        device=pos.device)
                idx = torch.arange(pos.shape[-1], device=pos.device)
                pos.masked_fill_(~(idx[None, :] < valid[:, None]), -1)
        return slot_tree

    # -- block tables -----------------------------------------------------

    def tables_device(self) -> torch.Tensor:
        if self._tables_dev is None:
            self._tables_dev = torch.from_numpy(self.block_tables.copy()).to(
                self.device)
        return self._tables_dev

    def set_table(self, slot: int, blocks: Sequence[int]) -> None:
        """Point ``slot``'s logical blocks at physical ``blocks``; the rest
        of the row falls back to the trash block 0."""
        row = np.zeros(self.blocks_per_slot, np.int32)
        row[:len(blocks)] = blocks
        if np.any(row[:len(blocks)] == 0):
            raise ValueError(
                f"live table entry maps to reserved trash block 0: {blocks}")
        self.block_tables[slot] = row
        self._tables_dev = None

    def clear_table(self, slot: int) -> None:
        self.block_tables[slot] = 0
        self._tables_dev = None

    def group_tables(self, block_lists: Sequence[Sequence[int]]) -> np.ndarray:
        """Block tables for rows that are not live slots: the fused mixed
        step's chunk rows commit and read through these while their slots'
        own tables stay on the trash block until the last chunk lands.
        Rows are padded with the trash block 0."""
        tables = np.zeros((len(block_lists), self.blocks_per_slot), np.int32)
        for i, blocks in enumerate(block_lists):
            if any(b == 0 for b in blocks):
                raise ValueError(
                    f"group table maps to reserved trash block 0: {blocks}")
            tables[i, :len(blocks)] = blocks
        return tables

    def invalidate_blocks(self, block_ids: Sequence[int]) -> None:
        """Set the pos plane of physical ``block_ids`` to -1 (K/V stay, masked
        by pos). Freshly allocated blocks may hold a previous owner's
        positions; chunked prefill commits a slot's blocks chunk by chunk,
        so the blocks it has not reached yet are scrubbed up front."""
        if not len(block_ids):
            return
        idx = torch.as_tensor(np.asarray(block_ids, np.int64),
                              device=self.device)
        for sub in self.tree["blocks"].values():
            sub["pos"][:, idx] = -1

    # -- prefill working trees ---------------------------------------------

    def prefix_tree(self, block_ids: Sequence[Sequence[int]],
                    prefix_len: int, length: Optional[int] = None):
        """A ``g``-row cache of ``length`` positions (default ``eff_len``)
        whose rows [0, prefix_len) are gathered from the arena blocks
        ``block_ids`` ((g, prefix_len // bs) physical ids) — the working
        tree for prefilling past a cached prefix."""
        g = len(block_ids)
        base = self.fresh(g, length)
        if prefix_len == 0:
            return base
        ids = np.asarray(block_ids, np.int32)
        if ids.size * self.block_size != g * prefix_len:
            raise ValueError(f"{ids.shape} blocks for a {prefix_len}-token prefix")
        if np.any(ids == 0):
            raise ValueError(
                f"cached prefix references reserved trash block 0: {block_ids}")
        idx = torch.from_numpy(ids.reshape(-1).astype(np.int64)).to(self.device)

        def graft(dst, src):  # (L, n_blocks, bs, ...) -> (L, g, plen, ...)
            pref = src[:, idx].reshape((src.shape[0], g, prefix_len)
                                       + src.shape[3:])
            dst[:, :, :prefix_len] = pref
            return dst

        return {"blocks": {name: {leaf: graft(base["blocks"][name][leaf], src)
                                  for leaf, src in sub.items()}
                           for name, sub in self.tree["blocks"].items()}}

    def scatter_row(self, slot_tree, row: int, block_ids: Sequence[int],
                    first_block: int, n_valid: int) -> None:
        """Commit one prefilled row into its owned arena blocks: logical
        blocks [first_block, first_block + len(block_ids)) of ``slot_tree``
        row ``row`` overwrite physical ``block_ids``. Pos entries beyond
        ``n_valid`` tokens past the region start (bucket padding, the
        unwritten tail) are invalidated."""
        if not len(block_ids):
            return
        ids = np.asarray(block_ids, np.int64)
        if np.any(ids == 0):
            raise ValueError(f"commit targets reserved trash block 0: {block_ids}")
        nb, bs = len(ids), self.block_size
        lo = first_block * bs
        idx = torch.from_numpy(ids).to(self.device)
        keep = torch.arange(nb * bs, device=self.device) < n_valid
        for name, sub in self.tree["blocks"].items():
            for leaf, arena in sub.items():
                reg = slot_tree["blocks"][name][leaf][:, row, lo:lo + nb * bs]
                if leaf == "pos":
                    reg = torch.where(keep[None], reg, -1)
                arena[:, idx] = reg.reshape((reg.shape[0], nb, bs)
                                            + reg.shape[2:])

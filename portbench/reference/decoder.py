"""The plain reference of both configurations: a pre-norm decoder in float32
PyTorch, with no kernel, cache or batching of the program's.

It computes the model that the port serves, as its configuration file
states it (``configs/<name>.json``, ``arch``): token embedding; per layer
RMSNorm (eps 1e-6), multi-head attention with rotary embedding (rotate
half), RMSNorm, then a SwiGLU MLP or the mixture of experts; final RMSNorm
and an untied unembedding. The mixture of experts routes in float32
(softmax over the real experts, top-k ties to the lower index, gates
renormalized over the k), adds the shared experts' SwiGLU on every token,
and, as the model is defined for a multi-token launch, keeps GShard capacity:
a launch's tokens in dispatch groups of ``group_tokens``, each expert
taking at most ``int(gs * k * capacity_factor / n_experts)`` choices, the
k-th choices of earlier tokens first. One token at a time (decode) is
dropless. Which prompts shared a prefill launch is therefore part of the
input (a ``Job``): the benchmark reads the launch's rows, in their order,
and its padded length where the program made it, and the prompts are
padded with token 0 to that length.

With ``control=True`` every product rounds its operands to TF32 (10
mantissa bits, to nearest even) and accumulates in float32: the precision
just below the configuration's float32 with TF32 off.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from portbench.reference.swis import dequant

EPS = 1e-6
MASKED = -1e30  # router logit of a padding expert


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


# tokens a block of the feed-forward layer takes at once: blocks hold
# whole launches, so that the memory the reference needs stays bounded
FFN_BLOCK = 16384


@dataclasses.dataclass
class Job:
    """One prefill launch: its prompts (rows in launch order), the padded
    length, and for the rows to judge, the tokens the program served and
    the logit it gave each (the reference itself never reads these)."""

    prompts: List[np.ndarray]
    s_pad: int
    served: Dict[int, np.ndarray]  # row -> served tokens
    logits: Dict[int, np.ndarray]  # row -> the program's logit of each


class Reference:
    def __init__(self, arch: dict, weights: dict, control: bool = False):
        self.a = arch
        self.w = weights
        self.control = control
        self.dev = weights["embed"]["tok"].device
        (self.kind,) = weights["blocks"].keys()

    # -- arithmetic ------------------------------------------------------

    def mm(self, x, w):
        if self.control:
            x, w = tf32(x), tf32(w)
        return x @ w

    def einsum(self, eq, a, b):
        if self.control:
            a, b = tf32(a), tf32(b)
        return torch.einsum(eq, a, b)

    @staticmethod
    def norm(x, scale):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * scale

    def rope(self, x, pos):
        """x (..., S, H, Dh), pos (S,)."""
        half = x.shape[-1] // 2
        freqs = 1.0 / (self.a["rope_theta"] ** (
            torch.arange(half, dtype=torch.float32, device=x.device) / half))
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    # -- weights -----------------------------------------------------------

    def layer(self, i: int) -> dict:
        """Layer i's weights, dense float32."""
        def walk(node):
            if isinstance(node, dict):
                if "mask_planes" in node:
                    return dequant({k: v[i] for k, v in node.items()})
                return {k: walk(v) for k, v in node.items()}
            return node[i].float()
        return walk(self.w["blocks"][self.kind])

    # -- blocks ------------------------------------------------------------

    def qkv(self, lw, h, pos):
        a = self.a
        q = self.mm(h, lw["attn"]["wq"]["w"]).reshape(
            *h.shape[:-1], a["n_heads"], a["head_dim"])
        k = self.mm(h, lw["attn"]["wk"]["w"]).reshape(
            *h.shape[:-1], a["n_kv_heads"], a["head_dim"])
        v = self.mm(h, lw["attn"]["wv"]["w"]).reshape(
            *h.shape[:-1], a["n_kv_heads"], a["head_dim"])
        return self.rope(q, pos), self.rope(k, pos), v

    def attend(self, q, k, v, q_pos, k_pos):
        """q (Sq, H, Dh), k/v (Sk, Hkv, Dh): causal by position."""
        g = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = self.einsum("qhd,khd->hqk", q * q.shape[-1] ** -0.5, k)
        s = s.masked_fill(k_pos[None, None, :] > q_pos[None, :, None],
                          float("-inf"))
        return self.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)

    def swiglu(self, x, wi, wg, wo):
        return self.mm(torch.nn.functional.silu(self.mm(x, wi))
                       * self.mm(x, wg), wo)

    def ffn(self, lw, x, launches: List[tuple]):
        """x (T, D), the concatenation of segments ``launches`` ((tokens,
        multi-token launch?) each): the MLP, or the experts plus the shared
        experts. A segment that is a multi-token launch keeps GShard
        capacity within itself; the others are dropless."""
        if "mlp" in lw:
            m = lw["mlp"]
            return self.swiglu(x, m["wi"]["w"], m["wg"]["w"], m["wo"]["w"])
        mo, cfg = lw["moe"], self.a["moe"]
        e, k = cfg["n_experts"], cfg["top_k"]
        logits = self.mm(x, mo["router"])
        logits[:, e:] = MASKED
        probs = torch.softmax(logits, -1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gates, idx = vals[:, :k], idx[:, :k]
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        keep, at = [], 0
        for n, launch in launches:
            seg = idx[at:at + n]
            keep.append(self.capacity(seg, logits.shape[1]) if launch
                        else torch.ones_like(seg, dtype=torch.bool))
            at += n
        keep = torch.cat(keep)
        y = self.swiglu(x, mo["shared_wi"], mo["shared_wg"], mo["shared_wo"])
        routed = torch.zeros_like(y)
        for ex in range(e):
            tok, slot = torch.nonzero((idx == ex) & keep, as_tuple=True)
            if tok.numel():
                out = self.swiglu(x[tok], mo["wi"][ex], mo["wg"][ex],
                                  mo["wo"][ex])
                routed.index_add_(0, tok, out * gates[tok, slot, None])
        return routed + y

    def capacity(self, idx, e_total):
        """Kept choices (T, k) of a launch's tokens under GShard capacity."""
        cfg = self.a["moe"]
        t, k = idx.shape
        gs = min(cfg["group_tokens"], t)
        if t % gs:
            gs = t
        cap = max(int(gs * k * cfg["capacity_factor"] / cfg["n_experts"]), 1)
        onehot = torch.nn.functional.one_hot(
            idx.reshape(t // gs, gs, k), e_total)  # (G, gs, k, E)
        flat = onehot.permute(0, 2, 1, 3).reshape(t // gs, k * gs, e_total)
        pos = torch.cumsum(flat, 1) - flat
        kept = ((pos < cap) & (flat > 0)).any(-1)  # (G, k*gs)
        return kept.reshape(t // gs, k, gs).permute(0, 2, 1).reshape(t, k)

    # -- forward -------------------------------------------------------------

    def run(self, jobs: List[Job]) -> List[Dict[int, torch.Tensor]]:
        """For each job, {row: logits (n_served, V)}: the prompt's last
        position, then each served token but the last fed back."""
        a, dev = self.a, self.dev
        tok = self.w["embed"]["tok"]
        state = []
        for job in jobs:
            rows = np.zeros((len(job.prompts), job.s_pad), np.int64)
            for r, p in enumerate(job.prompts):
                rows[r, :len(p)] = p
            xp = tok[torch.as_tensor(rows, device=dev)].float()
            xd = {r: tok[torch.as_tensor(np.asarray(t[:-1], np.int64),
                                         device=dev)].float()
                  for r, t in job.served.items()}
            state.append((xp, xd))
        for i in range(a["n_layers"]):
            lw = self.layer(i)
            segments = []
            for job, (xp, xd) in zip(jobs, state):
                segments += self.attention(lw, job, xp, xd)
            self.feed_forward(lw, segments)
            del lw
        out = []
        fn = self.w["final_norm"]["scale"].float()
        for job, (xp, xd) in zip(jobs, state):
            res = {}
            for r in job.served:
                s0 = len(job.prompts[r])
                x = torch.cat([xp[r, s0 - 1:s0], xd[r]])
                res[r] = self.mm(self.norm(x, fn),
                                 self.w["embed"]["unembed"].float())
            out.append(res)
        return out

    def attention(self, lw, job: Job, xp, xd) -> List[tuple]:
        """One layer's attention over a job, in place: the launch's rows,
        then each judged row's fed-back tokens over its prompt's keys.
        Returns the job's feed-forward segments: (residual stream, is a
        multi-token launch) for the launch, then for each judged row."""
        g, s, d = xp.shape
        pos = torch.arange(s, device=xp.device)
        h = self.norm(xp, lw["ln1"]["scale"])
        q, k, v = self.qkv(lw, h, pos)
        att = torch.stack([self.attend(q[r], k[r], v[r], pos, pos)
                           for r in range(g)])
        wo = lw["attn"]["wo"]["w"]
        xp += self.mm(att.reshape(g, s, -1), wo)
        segments = [(xp.view(g * s, d), s > 1)]
        for r, x in xd.items():
            if not x.shape[0]:
                continue
            s0 = len(job.prompts[r])
            dpos = torch.arange(s0, s0 + x.shape[0], device=x.device)
            qd, kd, vd = self.qkv(lw, self.norm(x, lw["ln1"]["scale"]), dpos)
            x += self.mm(self.attend(
                qd, torch.cat([k[r, :s0], kd]), torch.cat([v[r, :s0], vd]),
                dpos, torch.cat([pos[:s0], dpos])).reshape(x.shape[0], -1),
                wo)
            segments.append((x, False))
        return segments

    def feed_forward(self, lw, segments: List[tuple]) -> None:
        """One layer's feed-forward over every segment, in place, in blocks
        of whole segments of at most ``FFN_BLOCK`` tokens (a segment
        larger than that alone)."""
        block, n = [], 0
        for seg in segments + [None]:
            if block and (seg is None or n + seg[0].shape[0] > FFN_BLOCK):
                x = torch.cat([x for x, _ in block])
                y = self.ffn(lw, self.norm(x, lw["ln2"]["scale"]),
                             [(x.shape[0], launch) for x, launch in block])
                at = 0
                for x, _ in block:
                    x += y[at:at + x.shape[0]]
                    at += x.shape[0]
                block, n = [], 0
            if seg is not None:
                block.append(seg)
                n += seg[0].shape[0]

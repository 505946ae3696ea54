"""Request scheduling for the continuous-batching serve engine.

``RequestScheduler`` owns the admission queue and the per-slot request
state. The engine drives it step-by-step:

  submit()        enqueue a request (any time, including mid-flight)
  admit()         pop queued requests into free slots -> they need prefill
  record_prefill  store a request's first sampled token after prefill
  decode_batch    flatten live slot state into the per-slot decode arrays
  record_decode   append one sampled token to every slot that decoded
  pop_finished    collect requests that hit their token budget (slot freed)

Slots are freed eagerly on completion, so a queued request can be admitted
on the very next step while the remaining slots keep decoding — the
mid-flight interleaving that a static batch engine cannot do.

Request lifecycle: QUEUED (in the deque, no slot) -> PREFILLING (admitted
into a slot, prompt not yet fully in the KV cache — with chunked prefill
this spans several steps) -> DECODING (first token sampled, one token per
decode step). PREFILLING slots are invisible to ``decode_batch`` /
``needs_decode``: their KV is still being written chunk by chunk, so the
other slots keep decoding around them.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S0,) int32
    n_tokens: int
    temperature: float
    key: Any  # threefry key data (repro_torch.serve.prng) for seeded sampling
    extra: Optional[Dict[str, np.ndarray]] = None  # e.g. vlm patches


# Slot phases. A request starts QUEUED (still in the deque — it has no
# SlotState yet); admission creates its SlotState in PREFILLING; the first
# sampled token moves it to DECODING.
PREFILLING = "prefilling"
DECODING = "decoding"


@dataclasses.dataclass
class SlotState:
    req: Request
    n_gen: int = 0  # tokens sampled so far (incl. the prefill token)
    last_tok: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    phase: str = PREFILLING


@dataclasses.dataclass
class Finished:
    rid: int
    prompt: np.ndarray
    tokens: np.ndarray  # (n_tokens,) generated


class RequestScheduler:
    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[SlotState]] = [None] * n_slots
        self._next_rid = 0
        self._finished: List[Finished] = []
        self._decoding: List[int] = []
        # gauges, maintained incrementally on every transition (admit /
        # unadmit / record_prefill / finish) rather than recounted per
        # step — ``gauges()`` exposes them and ``recount()`` recomputes
        # them from SlotStates so tests can pin "no drift", in particular
        # across ``unadmit()`` rollbacks under pool starvation
        self.n_active = 0        # slots holding a request (any phase)
        self.n_prefilling = 0    # slots still landing their prompt
        # lifetime counters (monotonic; engine.metrics() surfaces them)
        self.n_submitted = 0
        self.n_admitted = 0
        self.n_unadmitted = 0
        self.n_finished = 0
        # cache-aware admission: score queued requests (higher first, FIFO
        # tie-break) when more are queued than slots are free — the engine
        # plugs in expected prefix-cache hit length so requests that reuse
        # cached KV are admitted while their blocks are still resident
        self.admission_priority = None  # Optional[Callable[[Request], float]]
        # engine hook, called with (slot, SlotState) when a request leaves
        # its slot (prefix-cache block commit + refcount release)
        self.on_release = None

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------

    def next_rid(self) -> int:
        """The rid the next submit() will be assigned (for auto-keying)."""
        return self._next_rid

    def submit(self, prompt: np.ndarray, n_tokens: int, temperature: float,
               key, extra=None) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.n_submitted += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  n_tokens, temperature, key, extra))
        return rid

    def admit(self) -> List[Tuple[int, SlotState]]:
        """Move queued requests into free slots. Submission order, unless
        ``admission_priority`` is set and the queue exceeds the free slots
        — then the highest-scoring requests win (FIFO tie-break) while the
        rest keep their relative order in the queue."""
        free = [s for s in range(self.n_slots) if self.slots[s] is None]
        if not free or not self.queue:
            return []
        if self.admission_priority is not None and len(self.queue) > len(free):
            reqs = list(self.queue)
            ranked = sorted(range(len(reqs)),
                            key=lambda i: (-self.admission_priority(reqs[i]),
                                           i))
            chosen = set(ranked[:len(free)])
            picked = [reqs[i] for i in sorted(chosen)]
            self.queue = collections.deque(
                reqs[i] for i in range(len(reqs)) if i not in chosen)
        else:
            picked = [self.queue.popleft()
                      for _ in range(min(len(free), len(self.queue)))]
        admitted = []
        for slot, req in zip(free, picked):
            st = SlotState(req)
            self.slots[slot] = st
            self.n_active += 1
            self.n_prefilling += 1
            self.n_admitted += 1
            admitted.append((slot, st))
        return admitted

    def unadmit(self, slot: int) -> None:
        """Undo an admission (before any token was generated): the request
        goes back to the front of the queue — the engine uses this when
        the block pool cannot cover the request yet. Rolls the admission
        gauges back exactly (pinned by the pool-starvation regression
        test against ``recount()``)."""
        st = self.slots[slot]
        assert st is not None and st.n_gen == 0
        self.slots[slot] = None
        self.n_active -= 1
        self.n_prefilling -= 1
        self.n_unadmitted += 1
        self.queue.appendleft(st.req)

    # ------------------------------------------------------------------
    # Token bookkeeping
    # ------------------------------------------------------------------

    def record_prefill(self, slot: int, tok: int) -> None:
        """The slot's prompt is fully in the cache and its first token is
        sampled: PREFILLING -> DECODING (or straight to finished)."""
        st = self.slots[slot]
        st.phase = DECODING
        self.n_prefilling -= 1
        if st.req.n_tokens == 0:  # degenerate: nothing to generate
            self._finish(slot)
            return
        st.n_gen = 1
        st.last_tok = int(tok)
        st.tokens.append(int(tok))
        if st.n_gen >= st.req.n_tokens:
            self._finish(slot)

    def needs_decode(self) -> bool:
        return any(st is not None and st.phase == DECODING
                   and st.n_gen < st.req.n_tokens
                   for st in self.slots)

    def decode_batch(self, dummy_key):
        """Per-slot arrays for one decode step over ALL slots (fixed jit
        shape). Free slots step on dummy values; their rows are overwritten
        wholesale at the next admission, so the garbage never escapes."""
        toks = np.zeros(self.n_slots, np.int32)
        idxs = np.zeros(self.n_slots, np.int32)
        steps = np.zeros(self.n_slots, np.int32)
        temps = np.zeros(self.n_slots, np.float32)
        keys = [dummy_key] * self.n_slots
        self._decoding = []
        for slot, st in enumerate(self.slots):
            if (st is None or st.phase == PREFILLING
                    or st.n_gen >= st.req.n_tokens):
                # PREFILLING slots decode nothing: their block tables still
                # point at the trash block, so the dummy row is harmless
                continue
            self._decoding.append(slot)
            toks[slot] = st.last_tok
            # the token being fed sits at position S0 + n_gen - 1
            idxs[slot] = len(st.req.prompt) + st.n_gen - 1
            steps[slot] = st.n_gen  # sampling fold-in index
            temps[slot] = st.req.temperature
            keys[slot] = st.req.key
        return toks, idxs, steps, temps, keys

    def decoding_slots(self) -> List[int]:
        """Slots the last ``decode_batch`` marked live — the rows whose
        sampled tokens ``record_decode`` will consume (the engine reads
        this to trace per-slot decode events and to build the fused mixed
        batch's per-row query counts)."""
        return list(self._decoding)

    def record_decode(self, toks: np.ndarray) -> None:
        for slot in self._decoding:
            st = self.slots[slot]
            st.n_gen += 1
            st.last_tok = int(toks[slot])
            st.tokens.append(int(toks[slot]))
            if st.n_gen >= st.req.n_tokens:
                self._finish(slot)
        self._decoding = []

    def record_spec(self, accepted: Dict[int, np.ndarray]) -> None:
        """Multi-token variant of :meth:`record_decode` for speculative
        steps: each slot the last ``decode_batch`` marked live appends its
        accepted tokens (longest matching draft prefix + the verify's
        bonus token — at least one). The engine's per-row draft budget
        guarantees acceptance never overruns the token budget; the assert
        pins that contract."""
        for slot in self._decoding:
            st = self.slots[slot]
            toks = accepted[slot]
            assert 1 <= len(toks) <= st.req.n_tokens - st.n_gen, (
                len(toks), st.n_gen, st.req.n_tokens)
            for t in toks:
                st.n_gen += 1
                st.last_tok = int(t)
                st.tokens.append(int(t))
            if st.n_gen >= st.req.n_tokens:
                self._finish(slot)
        self._decoding = []

    # ------------------------------------------------------------------
    # Completion
    # ------------------------------------------------------------------

    def _finish(self, slot: int) -> None:
        st = self.slots[slot]
        self._finished.append(Finished(
            st.req.rid, st.req.prompt,
            np.asarray(st.tokens, np.int32)))
        self.slots[slot] = None  # evict: slot is immediately reusable
        self.n_active -= 1
        self.n_finished += 1
        if self.on_release is not None:
            self.on_release(slot, st)

    def pop_finished(self) -> List[Finished]:
        out, self._finished = self._finished, []
        return out

    def pending(self) -> bool:
        return bool(self.queue) or any(st is not None for st in self.slots)

    # ------------------------------------------------------------------
    # Observability
    # ------------------------------------------------------------------

    def gauges(self) -> Dict[str, int]:
        """Incrementally maintained scheduler gauges + lifetime counters
        (surfaced by ``engine.metrics()['scheduler']``)."""
        return {"queue_depth": len(self.queue),
                "active_slots": self.n_active,
                "prefilling_slots": self.n_prefilling,
                "decoding_slots": self.n_active - self.n_prefilling,
                "free_slots": self.n_slots - self.n_active,
                "submitted": self.n_submitted,
                "admitted": self.n_admitted,
                "unadmitted": self.n_unadmitted,
                "finished": self.n_finished}

    def recount(self) -> Dict[str, int]:
        """Gauges recomputed from the SlotStates — the drift oracle the
        incremental ``gauges()`` counters are tested against."""
        active = [st for st in self.slots if st is not None]
        prefilling = sum(st.phase == PREFILLING for st in active)
        return {"queue_depth": len(self.queue),
                "active_slots": len(active),
                "prefilling_slots": prefilling,
                "decoding_slots": len(active) - prefilling,
                "free_slots": self.n_slots - len(active)}

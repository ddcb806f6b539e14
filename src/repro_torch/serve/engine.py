"""Serving engine: slot-based continuous batching over the LM's prefill /
decode paths.

One Engine = one model replica: a fixed pool of cache slots (KV rows for
attention, state and conv window for Mamba); admissions
prefill into free slots (prompt lengths bucketed, as in the JAX package,
where the buckets bound recompilation); ``step()`` decodes every slot in one
batched call. The multi-replica front-end is ``launch.serve``, which places
requests with the PSTS request scheduler (``sched.request_sched``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

__all__ = ["Engine", "GenRequest"]


@dataclass
class GenRequest:
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: int | None = None
    generated: list = field(default_factory=list)
    slot: int = -1
    done: bool = False


def _bucket(n: int, buckets=(32, 64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    for b in buckets:
        if n <= b:
            return b
    return -(-n // 4096) * 4096


def _write_slots(big, small, idx) -> None:
    """Copy a prefill batch's cache into slots ``idx``: a dict (the hybrid
    family's per-sub-layer caches) key by key, a ``KVCache`` or
    ``SSMCache`` by its own ``write_slots``."""
    if isinstance(big, dict):
        for key, val in big.items():
            _write_slots(val, small[key], idx)
    else:
        big.write_slots(small, idx)


class Engine:
    """Continuous batching over ``lm`` (a ``models.LM``) on its device.

    Greedy decoding takes the argmax over the padded vocabulary in float32,
    as the JAX engine does. Sampling (``greedy=False``) draws from a
    ``torch.Generator`` seeded with ``seed``: the same distribution as the
    JAX engine's, not the same draws.
    """

    def __init__(self, lm, *, slots: int, max_len: int, greedy: bool = True,
                 seed: int = 0):
        self.lm = lm
        self.slots = slots
        self.max_len = max_len
        self.greedy = greedy
        self.cache = lm.init_cache(slots, max_len)
        self.lengths = np.zeros(slots, dtype=np.int32)
        self.last_token = np.zeros(slots, dtype=np.int32)
        self.active: list[GenRequest | None] = [None] * slots
        self._gen = torch.Generator(device=lm.device).manual_seed(seed)

    # ------------------------------------------------------------------
    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.active) if r is None]

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self.active)

    def admit(self, requests: list[GenRequest]) -> list[GenRequest]:
        """Prefill a batch of requests into free slots; returns admitted."""
        free = self.free_slots()
        batch = requests[:len(free)]
        if not batch:
            return []
        s_max = _bucket(max(len(r.prompt) for r in batch))
        if s_max > self.max_len:
            raise ValueError(f"prompt bucket {s_max} exceeds max_len "
                             f"{self.max_len}")
        toks = np.zeros((len(batch), s_max), dtype=np.int32)
        lens = np.zeros(len(batch), dtype=np.int32)
        for i, r in enumerate(batch):
            toks[i, :len(r.prompt)] = r.prompt
            lens[i] = len(r.prompt)
        # a scratch cache for the prefill batch (KV rows up to the bucket),
        # copied into the slots by each cache kind's write_slots
        scratch = self.lm.init_cache(len(batch), s_max)
        logits, scratch = self.lm.prefill(scratch, toks, lens)
        next_tok = self._sample(logits)
        slot_idx = np.array(free[:len(batch)])
        _write_slots(self.cache, scratch,
                     torch.as_tensor(slot_idx, device=self.lm.device))
        for i, r in enumerate(batch):
            slot = int(slot_idx[i])
            r.slot = slot
            tok = int(next_tok[i])
            r.generated.append(tok)
            self.active[slot] = r
            self.lengths[slot] = lens[i]
            self.last_token[slot] = tok
            self._maybe_finish(r)
        return batch

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.greedy:
            return logits.argmax(-1).cpu().numpy()
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0] \
            .cpu().numpy()

    def _maybe_finish(self, r: GenRequest):
        if r.eos_id is not None and r.generated and \
                r.generated[-1] == r.eos_id:
            r.done = True
        if len(r.generated) >= r.max_new_tokens:
            r.done = True
        if self.lengths[r.slot] + 1 >= self.max_len:
            r.done = True
        if r.done:
            self.active[r.slot] = None

    def step(self) -> list[GenRequest]:
        """One decode step for all slots; returns finished requests."""
        if self.n_active == 0:
            return []
        dev = self.lm.device
        tokens = torch.as_tensor(self.last_token[:, None], device=dev)
        lengths = torch.as_tensor(self.lengths, device=dev)
        logits, self.cache = self.lm.decode_step(self.cache, tokens, lengths)
        next_tok = self._sample(logits[:, 0])
        finished = []
        for slot, r in enumerate(self.active):
            if r is None:
                continue
            self.lengths[slot] += 1
            tok = int(next_tok[slot])
            r.generated.append(tok)
            self.last_token[slot] = tok
            self._maybe_finish(r)
            if r.done:
                finished.append(r)
        return finished

    def run(self, requests: list[GenRequest], max_steps: int = 10_000):
        """Drive admissions + decoding until all requests finish.

        A request can only be collected once: a request that finishes
        during ``admit()`` (e.g. ``max_new_tokens=1``) frees its slot
        immediately, so the same-iteration ``step()`` must not report it
        again."""
        pending = list(requests)
        done: list[GenRequest] = []
        seen: set[int] = set()

        def collect(batch):
            for r in batch:
                if r.done and id(r) not in seen:
                    seen.add(id(r))
                    done.append(r)

        for _ in range(max_steps):
            if pending and self.free_slots():
                admitted = self.admit(pending)
                pending = pending[len(admitted):]
                collect(admitted)
            collect(self.step())
            if not pending and self.n_active == 0:
                break
        return done

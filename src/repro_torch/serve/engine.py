"""LM serving with continuous batching: the port of the LM half of
``repro.serve.engine``.

``ServeEngine`` keeps a slot-based batch: requests occupy fixed cache slots,
and a finished request frees its slot for the next queued one (continuous
batching a la Orca/vLLM, in the static-shape form of the reference: the
decode step always runs the full (slots, 1) batch, with inactive slots
masked).  Prefill runs per slot on the prompt right-padded to a power-of-two
bucket; above ``cfg.q_chunk`` tokens its attention is K3.  PyTorch runs
eagerly, so there is no jit: ``stats["prefill_traces"]`` counts the distinct
prefill buckets, which are what the reference's traces are keyed on.  The KV
cache is updated in place.

``AnnFrontend``, the async front end and telemetry are ROADMAP item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.common.utils import next_pow2
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    tokens_out: list = dataclasses.field(default_factory=list)
    done: bool = False


def make_prefill_fn(cfg: tf.TransformerConfig):
    """(params, tokens (B, S), cache) -> (next_token_logits (B, V), cache)."""

    def prefill(params, tokens, cache):
        logits, cache, _ = tf.apply(params, cfg, tokens, cache=cache, cache_offset=0)
        return logits[:, -1], cache

    return prefill


def make_bucketed_prefill_fn(cfg: tf.TransformerConfig):
    """Prefill over a length-bucketed prompt: tokens (B, S_bucket) is the
    prompt right-padded to its bucket and ``last`` the index of the final
    real token.  Right padding is attention-valid under the causal mask: a
    pad token at position p > last cannot influence the logits at ``last``,
    and pad rows written to the cache sit at positions >= the true length,
    which decode masks out (kv_pos <= q_pos) and then overwrites in place.
    """

    def prefill(params, tokens, cache, last):
        logits, cache, _ = tf.apply(params, cfg, tokens, cache=cache, cache_offset=0)
        return logits[:, last], cache

    return prefill


def make_decode_fn(cfg: tf.TransformerConfig):
    """(params, token (B, 1), cache, offset) -> (logits (B, V), cache): one
    new token per row against a KV cache of length ``offset``."""

    def decode(params, token, cache, offset):
        logits, cache, _ = tf.apply(params, cfg, token, cache=cache, cache_offset=offset)
        return logits[:, -1], cache

    return decode


class ServeEngine:
    """Host-side continuous batching over fixed cache slots.  Runs on the
    device of ``params``."""

    def __init__(
        self,
        cfg: tf.TransformerConfig,
        params: tf.Transformer,
        *,
        slots: int = 8,
        max_seq: int = 512,
        cache_dtype=torch.float32,
        greedy: bool = True,
        seed: int = 0,
        prefill_bucket_min: int = 16,
        telemetry=None,
    ):
        if telemetry is not None:
            raise NotImplementedError("ServeEngine telemetry is not ported (ROADMAP item 8)")
        self.cfg = cfg
        self.params = params
        self.device = params.embed.device
        self.slots = slots
        self.max_seq = max_seq
        self.cache = tf.make_cache(cfg, slots, max_seq, dtype=cache_dtype, device=self.device)
        self.offsets = np.zeros(slots, dtype=np.int64)  # per-slot position
        self.active: list[Optional[Request]] = [None] * slots
        self.queue: list[Request] = []
        self.greedy = greedy
        self.rng = np.random.default_rng(seed)
        self.prefill_bucket_min = prefill_bucket_min
        self._prefill = make_bucketed_prefill_fn(cfg)
        self._decode = make_decode_fn(cfg)
        self._buckets: set[int] = set()
        self.stats = {"prefill_tokens": 0, "decode_steps": 0, "completed": 0,
                      "prefill_traces": 0}

    def submit(self, req: Request):
        self.queue.append(req)

    def _prompt_bucket(self, length: int) -> int:
        """Power-of-two length bucket, clamped to the cache extent."""
        return min(max(next_pow2(length), self.prefill_bucket_min),
                   max(self.max_seq, length))

    def _admit(self):
        for s in range(self.slots):
            if self.active[s] is None and self.queue:
                req = self.queue.pop(0)
                self.active[s] = req
                # per-slot prefill: batch of 1 into this slot's cache rows
                # (views, written in place), prompt right-padded to its bucket
                L = len(req.prompt)
                S_pad = self._prompt_bucket(L)
                toks = np.zeros((1, S_pad), np.int64)
                toks[0, :L] = req.prompt
                slot_cache = {name: c[:, s: s + 1] for name, c in self.cache.items()}
                logits, _ = self._prefill(self.params, torch.from_numpy(toks).to(self.device),
                                          slot_cache, L - 1)
                self.offsets[s] = L
                req.tokens_out.append(self._sample(logits[0].float().cpu().numpy()))
                self.stats["prefill_tokens"] += L
                self._buckets.add(S_pad)
                self.stats["prefill_traces"] = len(self._buckets)

    def _sample(self, logits: np.ndarray) -> int:
        if self.greedy:
            return int(np.argmax(logits))
        p = np.exp(logits - logits.max())
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def step(self):
        """One engine tick: admit waiting requests, decode all active slots."""
        self._admit()
        if not any(self.active):
            return False
        last = np.zeros((self.slots, 1), dtype=np.int64)
        for s, req in enumerate(self.active):
            if req is not None and req.tokens_out:
                last[s, 0] = req.tokens_out[-1]
        # per-slot offsets: slots decode at their own cache positions
        offset = torch.tensor(self.offsets, device=self.device)
        logits, _ = self._decode(self.params, torch.from_numpy(last).to(self.device),
                                 self.cache, offset)
        logits = logits.float().cpu().numpy()
        self.stats["decode_steps"] += 1
        for s, req in enumerate(self.active):
            if req is None:
                continue
            self.offsets[s] += 1
            req.tokens_out.append(self._sample(logits[s]))
            if len(req.tokens_out) >= req.max_new_tokens or self.offsets[s] >= self.max_seq - 1:
                req.done = True
                self.stats["completed"] += 1
                self.active[s] = None
                self.offsets[s] = 0
        return True

    def run(self, max_ticks: int = 10_000):
        ticks = 0
        while (self.queue or any(self.active)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.stats

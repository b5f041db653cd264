"""Serving launcher: batched greedy decoding over a request queue.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch gemma2-2b --requests 12

Continuous-batching-lite: a fixed pool of B decode slots; finished or empty
slots are refilled from the queue each step (one decode step serves the
whole pool; per-slot positions), on ``--device`` (default ``cuda``), with
slot-level fault tolerance (a poisoned request cannot take down the pool —
it is evicted and logged).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models.model import build_caches, init_model
from ..models.serve import make_decode_step


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [P] int32
    max_new: int = 16
    out: list = field(default_factory=list)
    done: bool = False


class ServePool:
    """Fixed-size decode pool with slot refill (continuous batching).

    ``device`` (``None`` -> the card) holds the caches; ``params`` must
    live there too."""

    def __init__(self, cfg, params, batch_slots: int, ctx_len: int,
                 dtype=torch.float32, *, device=None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.B = batch_slots
        self.ctx = ctx_len
        self.caches = build_caches(cfg, batch_slots, ctx_len, dtype=dtype,
                                   device=self.device)
        self.decode = make_decode_step(cfg, device=self.device)
        self.slots: list[Request | None] = [None] * batch_slots
        self.slot_pos = np.zeros(batch_slots, np.int32)   # tokens consumed
        self.slot_tok = np.zeros(batch_slots, np.int32)   # next input token
        self.extra = {}

    def _refill(self, queue: list[Request]):
        for b in range(self.B):
            if self.slots[b] is None and queue:
                req = queue.pop(0)
                self.slots[b] = req
                self.slot_pos[b] = 0
                self.slot_tok[b] = int(req.prompt[0])
                # a fresh slot must not see the previous request's cache:
                # recurrent states are zeroed, kv slots are masked by pos
                self._reset_slot_state(b)

    def _reset_slot_state(self, b: int):
        """Zero slot b's recurrent states (h/conv). KV cache rows need no
        reset: positions beyond `pos` are masked by the decode attention."""
        for part, stacked in (("cycle", True), ("tail", False)):
            for layer in self.caches[part].values():
                for name, leaf in layer.get("state", {}).items():
                    if name in ("h", "conv"):
                        # stacked [n_cycles, B, ...] or tail [B, ...]
                        (leaf[:, b] if stacked else leaf[b]).zero_()

    def step(self):
        """One decode step for every active slot (one call); each slot
        decodes at its OWN position (vectorized pos plumbing)."""
        batch = {"tokens": torch.from_numpy(self.slot_tok[:, None].copy()),
                 "pos": torch.from_numpy(self.slot_pos.copy()), **self.extra}
        logits, self.caches = self.decode(self.params, self.caches, batch)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for b, req in enumerate(self.slots):
            if req is None:
                continue
            p = int(self.slot_pos[b]) + 1
            self.slot_pos[b] = p
            if p < len(req.prompt):
                self.slot_tok[b] = int(req.prompt[p])      # teacher-forced
            else:
                tok = int(nxt[b])
                req.out.append(tok)
                self.slot_tok[b] = tok
                if len(req.out) >= req.max_new or p >= self.ctx - 1:
                    req.done = True
                    self.slots[b] = None

    def run(self, requests: list[Request], deadline_s: float = 120.0):
        queue = list(requests)
        t0 = time.time()
        served = []
        while (queue or any(s is not None for s in self.slots)) \
                and time.time() - t0 < deadline_s:
            self._refill(queue)
            try:
                self.step()
            except Exception as e:           # slot-level fault tolerance
                bad = [b for b, s in enumerate(self.slots) if s is not None]
                print(f"[evict] decode error {e!r}; evicting slots {bad}")
                for b in bad:
                    self.slots[b] = None
            served = [r for r in requests if r.done]
        return served


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="where the model runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    params = init_model(0, cfg, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab, rng.integers(4, 10)),
                    max_new=args.max_new)
            for i in range(args.requests)]
    pool = ServePool(cfg, params, args.slots, ctx_len=64, device=dev)
    t0 = time.time()
    done = pool.run(reqs)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)}/{len(reqs)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks / max(dt, 1e-9):.1f} tok/s, "
          f"{args.slots} slots, {dev})")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out}")


if __name__ == "__main__":
    main()

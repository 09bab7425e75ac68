"""GenerationEngine: autoregressive LM serving with a prefill/decode split.

The port of ``sparknet_tpu/serve/generate.py``, with the same surface
(``admit``/``step``/``finish``/``evict``/``reserve``/``release``/
``score_tokens``/``warmup``/``jit_cache_size``):

- **Prefill/decode split.**  Prefill runs one sequence at a time,
  padded to its prompt-length bucket (causal masking keeps the valid
  prefix exact), and writes the prompt's K/V straight into the paged
  arena.  Decode is ONE fixed-shape step over all ``max_streams`` slots,
  active or not; inactive slots compute into the trash block.
- **Paged KV cache.**  ``serve/kv_cache.py`` owns the arena; the engine
  keeps per-slot block tables as a host index map (slot, position) ->
  arena row, gathers each step's context from it and scatters the new
  position back.  The scatters update the arena in place.
- **Greedy decode, logprob out.**  Each admitted stream gets its first
  generated token from the prefill itself (the TTFT token), and greedy
  decode is deterministic, so re-prefilling prompt + tokens-so-far
  continues the identical sequence.  ``score_tokens`` is the canary
  surface: teacher-forced per-token logprobs under this engine's
  weights, at one fixed shape.

Attention runs the port's CUDA kernels on the card (flash forward in
prefill and the scorer, decode attention in every decode step) and
their plain versions on the CPU.  The engine runs on ``cuda`` unless
``device="cpu"`` is asked for.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sparknet_tpu_torch.obs.trace import span
from sparknet_tpu_torch.serve.kv_cache import KVBlockPool
from sparknet_tpu_torch.utils.devices import resolve_device

DEFAULT_PREFILL_BUCKETS = (16, 32, 64, 128)


class GenerationEngine:
    """Serves greedy autoregressive decode for one ``TransformerLM``.

    Parameters
    ----------
    lm:
        A port ``models.transformer_lm.TransformerLM`` (sp=1).  The
        engine draws its seeded weights (``lm.init(seed)``) and moves it
        to ``device``; the module is the engine's from then on.
    weights:
        A ``.caffemodel`` / snapshot path in the JAX package; not yet
        ported here (raises).  None serves the seeded init.
    prefill_buckets:
        Ascending prompt-length buckets; longer prompts are refused.
    max_streams:
        Decode slots — the fixed decode batch width.
    kv_blocks / kv_block_size:
        Paged-arena geometry (see ``serve/kv_cache.py``).
    device:
        ``None`` is ``cuda`` (raises without a CUDA device); ``"cpu"``
        runs the plain attention versions on the CPU.
    """

    def __init__(
        self,
        lm,
        weights: Optional[str] = None,
        prefill_buckets: Sequence[int] = DEFAULT_PREFILL_BUCKETS,
        max_streams: int = 8,
        kv_blocks: int = 64,
        kv_block_size: int = 16,
        seed: int = 0,
        device=None,
    ):
        if weights:
            raise NotImplementedError(
                "serving --weights (.caffemodel / snapshot I/O) is not yet "
                "ported to sparknet_tpu_torch; omit it to serve the seeded "
                "init"
            )
        self.device = resolve_device(device)
        self.max_streams = int(max_streams)
        if self.max_streams < 1:
            raise ValueError(f"need >= 1 decode slot, got {max_streams}")
        self.buckets: List[int] = sorted(
            {min(int(b), lm.seq_len) for b in prefill_buckets if int(b) >= 1}
        )
        if not self.buckets:
            raise ValueError(f"no usable prefill buckets in {prefill_buckets}")
        self.max_prompt = self.buckets[-1]
        self.lm = lm.init(seed).to(self.device).eval()

        self.pool = KVBlockPool(
            lm.depth,
            lm.heads,
            lm.head_dim,
            num_blocks=kv_blocks,
            block_size=kv_block_size,
            device=self.device,
        )

        # host-side slot state (the decode step's fixed-shape inputs)
        S = lm.seq_len
        self._index_map = np.zeros((self.max_streams, S), np.int64)
        self._positions = np.zeros((self.max_streams,), np.int64)
        self._last = np.zeros((self.max_streams,), np.int64)
        self._slot_blocks: List[List[int]] = [
            [] for _ in range(self.max_streams)
        ]
        self._active = [False] * self.max_streams
        # request id occupying each slot (None untraced) — decode_step
        # spans carry the active set's ids for per-request attribution
        self._slot_rids: List[Optional[str]] = [None] * self.max_streams
        self._lock = threading.Lock()
        # shapes run so far: ("prefill", bucket), ("decode",), ("score",)
        self._shapes = set()

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # The three programs (prefill per bucket, decode, scorer)
    # ------------------------------------------------------------------
    def _prefill(self, tokens: np.ndarray, last: int,
                 idx: np.ndarray) -> Tuple[int, float]:
        self._shapes.add(("prefill", tokens.shape[1]))
        logits, k, v = self.lm.prefill_with_kv(self._to_dev(tokens))
        # pad positions carry an out-of-bounds row: drop them before the
        # scatter (an index_put_ would raise on them, not skip them)
        keep = idx < self.pool.arena_rows
        if keep.any():
            rows = self._to_dev(idx[keep])
            src = self._to_dev(np.flatnonzero(keep))
            self.pool.k[:, rows] = k[:, 0, src]
            self.pool.v[:, rows] = v[:, 0, src]
        lp = torch.log_softmax(logits[0, last], dim=-1)
        tok = torch.argmax(lp)
        # the first generated token IS the response — TTFT materializes here
        return int(tok.item()), float(lp[tok].item())

    def _decode(self) -> Tuple[np.ndarray, np.ndarray]:
        self._shapes.add(("decode",))
        index_map = self._to_dev(self._index_map)
        positions = self._to_dev(self._positions)
        kc = self.pool.k[:, index_map]  # (L, B, S, H, D) gathered context
        vc = self.pool.v[:, index_map]
        logits, nk, nv = self.lm.decode_step_with_kv(
            self._to_dev(self._last), positions, kc, vc
        )
        rows = torch.arange(self.max_streams, device=self.device)
        write = index_map[rows, positions]
        # inactive slots all write trash row 0: duplicate indices there
        # are harmless whichever write lands
        self.pool.k[:, write] = nk
        self.pool.v[:, write] = nv
        lp = torch.log_softmax(logits, dim=-1)
        nxt = torch.argmax(lp, dim=-1)
        chosen = lp.gather(1, nxt[:, None])[:, 0]
        # streamed tokens ARE the response — one D2H per decode iteration
        return nxt.cpu().numpy(), chosen.cpu().numpy()

    def _score(self, tokens: np.ndarray, targets: np.ndarray) -> np.ndarray:
        self._shapes.add(("score",))
        logits = self.lm.forward_logits(self._to_dev(tokens))
        lp = torch.log_softmax(logits, dim=-1)
        return lp.gather(-1, self._to_dev(targets)[..., None])[..., 0].cpu().numpy()

    # ------------------------------------------------------------------
    # Warm-up
    # ------------------------------------------------------------------
    def warmup(self) -> int:
        """Run every shape the steady state uses once — one prefill per
        length bucket, the decode step, the canary scorer — which also
        builds the CUDA kernels on first use.  Warm-up scatters only to
        dropped pad rows and the trash block, so the arena's real blocks
        stay untouched.  Returns ``jit_cache_size()``."""
        oob = self.pool.oob_row
        with self._lock:
            for b in self.buckets:
                self._prefill(
                    np.zeros((1, b), np.int64), 0, np.full((b,), oob, np.int64)
                )
            self._decode()  # every slot inactive: writes land in trash
        S = self.lm.seq_len
        self._score(np.zeros((1, S), np.int64), np.zeros((1, S), np.int64))
        return self.jit_cache_size()

    def jit_cache_size(self) -> int:
        """Distinct shapes this engine has run: PyTorch keeps no jit
        cache, so this counts warmed shapes — ``len(buckets) + 2``
        (prefill buckets, decode, scorer) after ``warmup()``, and the
        same for ever after, since admission only runs bucketed
        shapes."""
        return len(self._shapes)

    # ------------------------------------------------------------------
    # Admission geometry
    # ------------------------------------------------------------------
    def bucket_for(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds the largest prefill "
            f"bucket ({self.max_prompt})"
        )

    def validate(self, prompt_len: int, max_new: int) -> None:
        if prompt_len < 1:
            raise ValueError("empty prompt")
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if prompt_len + max_new > self.lm.seq_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new}) "
                f"exceeds the model context ({self.lm.seq_len})"
            )
        self.bucket_for(prompt_len)

    def reserve(self, prompt_len: int, max_new: int,
                rid: Optional[str] = None) -> List[int]:
        """Worst-case KV-block reservation at SUBMIT time: raises
        ``KVBudgetExceeded`` (-> 429) when the arena cannot cover
        ``prompt + max_new`` positions.  The returned blocks are handed
        to ``admit`` (or ``release``d if the stream dies queued).  With
        a request id the reservation emits a ``kv_reserve`` span."""
        self.validate(prompt_len, max_new)
        n = self.pool.blocks_for(prompt_len + max_new)
        if rid is not None:
            with span("kv_reserve", cat="req", req=rid, blocks=n):
                return self.pool.alloc(n)
        return self.pool.alloc(n)

    def release(self, blocks: List[int]) -> None:
        self.pool.free(blocks)

    def free_slots(self) -> int:
        with self._lock:
            return self._active.count(False)

    # ------------------------------------------------------------------
    # Generation
    # ------------------------------------------------------------------
    def admit(
        self,
        prompt: Sequence[int],
        max_new: int,
        blocks: Optional[List[int]] = None,
        rid: Optional[str] = None,
    ) -> Tuple[int, int, float]:
        """Prefill one prompt into a free decode slot; returns ``(slot,
        first_token, first_logprob)``."""
        prompt = [int(t) for t in prompt]
        n = len(prompt)
        self.validate(n, int(max_new))
        bucket = self.bucket_for(n)
        with self._lock:
            try:
                slot = self._active.index(False)
            except ValueError:
                # the caller still owns ``blocks`` (if any) — ownership
                # transfers to the engine only on successful admit
                raise RuntimeError("no free decode slot") from None
            allocated_here = blocks is None
            if blocks is None:
                blocks = self.pool.alloc(
                    self.pool.blocks_for(n + int(max_new))
                )
            row = self.pool.index_row(blocks, self.lm.seq_len)
            padded = np.zeros((1, bucket), np.int64)
            padded[0, :n] = prompt
            idx = row[:bucket].copy()
            idx[n:] = self.pool.oob_row
            sp_args = {"req": rid} if rid is not None else {}
            try:
                with span("prefill", cat="gen", bucket=bucket, **sp_args):
                    tok, lp = self._prefill(padded, n - 1, idx)
            except BaseException:
                if allocated_here:
                    self.pool.free(blocks)
                raise
            self._index_map[slot] = row
            self._positions[slot] = n
            self._last[slot] = tok
            self._slot_blocks[slot] = list(blocks)
            self._slot_rids[slot] = rid
            self._active[slot] = True
        return slot, tok, lp

    def step(self) -> Dict[int, Tuple[int, float]]:
        """One decode iteration over EVERY slot (fixed shape — inactive
        slots compute into the trash block).  Returns ``{slot: (token,
        logprob)}`` for the active ones."""
        with self._lock:
            act = [i for i in range(self.max_streams) if self._active[i]]
            if not act:
                return {}
            rids = [r for r in (self._slot_rids[i] for i in act)
                    if r is not None]
            with span("decode_step", cat="gen", active=len(act),
                      reqs=rids):
                nxt, lps = self._decode()
            out: Dict[int, Tuple[int, float]] = {}
            for s in act:
                self._positions[s] += 1
                self._last[s] = int(nxt[s])
                out[s] = (int(nxt[s]), float(lps[s]))
            return out

    def finish(self, slot: int) -> None:
        """Release a slot and its blocks (stream completed)."""
        with self._lock:
            if not self._active[slot]:
                return
            blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
            self._active[slot] = False
            self._slot_rids[slot] = None
            self._positions[slot] = 0
            self._last[slot] = 0
            self._index_map[slot, :] = 0
        self.pool.free(blocks)

    def evict(self, slot: int) -> None:
        """Same release as ``finish``, named for the other reason: the
        stream is NOT done, its blocks are reclaimed, and the caller
        re-prefills prompt + generated-so-far later (greedy decode is
        deterministic, so the continuation is exact)."""
        self.finish(slot)

    # ------------------------------------------------------------------
    # Canary surface
    # ------------------------------------------------------------------
    def score_tokens(
        self, prompt: Sequence[int], tokens: Sequence[int]
    ) -> np.ndarray:
        """Teacher-forced per-token logprobs of ``tokens`` (an
        incumbent's output for ``prompt``) under THIS engine's weights,
        one fixed-shape forward regardless of lengths."""
        prompt = [int(t) for t in prompt]
        tokens = [int(t) for t in tokens]
        if not prompt or not tokens:
            raise ValueError("score_tokens needs a prompt and tokens")
        seq = prompt + tokens
        S = self.lm.seq_len
        if len(seq) > S:
            raise ValueError(
                f"prompt + tokens ({len(seq)}) exceeds context ({S})"
            )
        toks = np.zeros((1, S), np.int64)
        toks[0, : len(seq)] = seq
        tgts = np.zeros((1, S), np.int64)
        tgts[0, : len(seq) - 1] = seq[1:]
        lp = self._score(toks, tgts)
        return lp[0, len(prompt) - 1 : len(prompt) - 1 + len(tokens)]

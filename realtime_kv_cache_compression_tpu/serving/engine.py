"""Continuous-batching serving engine over compressed KV caches.

North-star component (BASELINE.json config 5; the reference has no serving
layer at all — generation is bare HF `model.generate`, longbench_eval.py:131).

Design:
  * B fixed decode slots. Each slot holds one sequence's compressed tier
    pools + recent ring (+ decode pool) + position — all batched pytrees
    indexed by slot.
  * Admission: ALL pending requests that fit free slots prefill together in
    ONE batched (ragged, right-padded) prefill — padded to a power-of-two
    batch to bound compile count — then each row scatters into its slot (a
    pure `tree_map` dynamic-update, O(cache bytes), no recompile).
    Admission is asynchronous by default: the prefill dispatches without a
    host sync and completion is polled via `Array.is_ready()` between
    decode chunks, so prefills pipeline with decode.
  * Decode: one scanned multi-step program advances ALL active slots;
    finished slots (EOS or token budget) are freed and refilled.
  * Static shapes throughout: slot count, context bucket, recent-ring
    capacity are fixed at engine build; per-sequence raggedness lives in
    positions/validity values.
  * Prefix caching (`prefix_cache_size=N`): completed prefills are kept
    (LRU) as single-row decode states keyed by the exact prompt; repeat
    prompts re-admit with zero prefill work. The compressed representation
    is what makes the cache dense — packed sub-byte tier pools instead of
    a full bf16 KV prefix.
  * Sharded serving (`mesh=`): weights shard tensor-parallel over `model`,
    slots (the decode batch) over `data`, and the KV tier pools commit to
    P(data, None, model, None) via prefill's sharding constraints
    (parallel/sharding.py). The decode program is one jit over the full
    mesh; admission inserts a replicated single-row state into the slot's
    data shard (GSPMD places the copy). num_slots must be a multiple of
    the data-axis size.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp

from ..compression.compressor import (summarize_layer_stats,
                                      summarize_layer_stats_per_row)
from ..config import CompressionConfig, ModelConfig
from ..models import llama

Array = jax.Array


@dataclasses.dataclass
class Request:
    rid: int
    input_ids: List[int]
    max_new_tokens: int
    submitted_at: float = dataclasses.field(default_factory=time.time)
    prefill_stats: Optional[Dict] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    finished: bool = False
    ttft: Optional[float] = None
    finished_at: Optional[float] = None
    # Request-level generation controls (see ServingEngine.submit):
    stop_sequences: List[List[int]] = dataclasses.field(default_factory=list)
    eos_token_id: Optional[int] = None  # None -> engine default
    on_token: Optional[Any] = None      # streaming callback(req, new_tokens)
    logprobs: List[float] = dataclasses.field(default_factory=list)
    stop_reason: Optional[str] = None   # "eos" | "stop" | "length"


# Effective prefill rate for the chunking estimate, measured: Mistral-7B
# widths, 32 layers, bf16, one 4096-token compressed prefill at batch 1 took
# 128.3 ms on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py
# phase 3) — 5.95e13 FLOP by the formula below.
PREFILL_TFLOP_S = 463.0


def estimate_prefill_seconds(params, mcfg: ModelConfig,
                             context_len: int,
                             effective_tf_s: float = PREFILL_TFLOP_S
                             ) -> float:
    """Analytic one-shot prefill wall estimate (batch 1) for the chunking
    heuristic: weight FLOPs 2·N·S plus causal attention 2·Hq·S²·D, over the
    card's measured effective prefill rate (PREFILL_TFLOP_S) — enough for
    an order-of-magnitude gate."""
    from ..models.quantized_params import params_num_weights

    n = params_num_weights(params)
    s = context_len
    flops = 2.0 * n * s + 2.0 * mcfg.num_heads * s * s * mcfg.head_dim
    return flops / (effective_tf_s * 1e12)


def resolve_prefill_chunk(params, mcfg: ModelConfig, context_len: int,
                          hol_budget_s: float = 0.5) -> Optional[int]:
    """prefill_chunk="auto" resolution: chunk only when the one-shot
    prefill would block head-of-line longer than `hol_budget_s`.

    A short prefill needs no chunking — async admission already
    pipelines it with decode, and chunk steps serialize on the host loop; a
    long one-shot prefill monopolizes the device stream and chunking is
    the only bound on the inter-token gap. The chunk size targets
    ~hol_budget_s per chunk (power of two, >= 512, dividing context_len).
    """
    est = estimate_prefill_seconds(params, mcfg, context_len)
    if est <= hol_budget_s:
        return None
    target = max(int(context_len * hol_budget_s / est), 512)
    chunk = 512
    while chunk * 2 <= target:
        chunk *= 2
    # Cap at 4096: later chunks pay full-buffer attention, which the
    # estimate (weights + one causal pass) does not charge per chunk — a
    # larger chunk converts that error straight into head-of-line delay.
    chunk = min(chunk, 4096)
    if context_len % chunk or chunk >= context_len:
        return None  # non-pow2 context: stay unchunked rather than crash
    return chunk


def _tree_insert_row(batched, multi, row, slot):
    """Scatter row `row` of a batched pytree into slot `slot` of another."""
    row = jnp.asarray(row, jnp.int32)
    slot = jnp.asarray(slot, jnp.int32)
    return jax.tree_util.tree_map(
        lambda b, m: jax.lax.dynamic_update_index_in_dim(
            b, jax.lax.dynamic_index_in_dim(m, row, axis=0, keepdims=False),
            slot, axis=0),
        batched, multi)


class ServingEngine:
    """Greedy/sampled continuous-batching engine (single host or mesh)."""

    def __init__(self, params, mcfg: ModelConfig, ccfg: CompressionConfig,
                 num_slots: int = 4, context_len: int = 2048,
                 max_new_tokens: int = 128, decode_chunk: int = 8,
                 use_flash: bool = False,
                 use_fused_decode: Optional[bool] = None,
                 eos_token_id: Optional[int] = None,
                 async_admission: bool = True,
                 temperature: float = 0.0,
                 sampling=None,
                 logprobs: bool = False,
                 prefix_cache_size: int = 0,
                 prefill_chunk: Optional[int] = None,
                 prefix_continue_budget: int = 0,
                 seed: int = 0,
                 mesh=None):
        self.mcfg = mcfg
        self.ccfg = ccfg
        self.num_slots = num_slots
        self.context_len = context_len
        self.max_new_tokens = max_new_tokens
        self.decode_chunk = decode_chunk
        self.eos_token_id = eos_token_id
        self.mesh = mesh
        if use_fused_decode is None:
            use_fused_decode = llama.resolve_fused_decode(mcfg, ccfg,
                                                          mesh=mesh)

        # Multi-host (multi-process) SPMD: engaged when the mesh spans
        # processes. Every process then runs this same engine with identical
        # submissions; collectives replace local readbacks
        # (parallel/multihost.py). A no-mesh engine inside a multi-process
        # job stays a purely local computation.
        self._multiproc = mesh is not None and any(
            d.process_index != jax.process_index()
            for d in mesh.devices.flat)
        if mesh is not None:
            from ..parallel.mesh import DATA_AXIS
            from ..parallel.sharding import shard_params

            if num_slots % mesh.shape[DATA_AXIS]:
                raise ValueError(
                    f"num_slots={num_slots} must be a multiple of the "
                    f"data-axis size ({mesh.shape[DATA_AXIS]})")
            if self._multiproc:
                from ..parallel.multihost import global_params

                params = global_params(params, mesh, mcfg)
            else:
                params = shard_params(params, mesh, mcfg)
        self.params = params

        if self._multiproc and async_admission:
            # Array.is_ready() is a per-process signal: two hosts could
            # disagree on readiness and issue collectives in different
            # orders (deadlock). Admission completes synchronously in
            # lockstep instead; the prefill itself is still one batched
            # program over the mesh.
            async_admission = False
        self.async_admission = async_admission
        self._pending: deque[Request] = deque()
        # Each entry: (pairs [(req, slot), ...], logits, state, stats)
        self._inflight: List = []
        self._slots: List[Optional[Request]] = [None] * num_slots
        self._slot_budget = [0] * num_slots
        self._next_rid = 0
        self.completed: Dict[int, Request] = {}
        # O(1) lifetime aggregates: `summary()` reads these, so popping
        # resolved requests out of `completed` (see `release`) never loses
        # stats and a long-running server's memory stays bounded.
        self._agg = {"completed": 0, "ttft_sum": 0.0, "wall_sum": 0.0,
                     "tokens_sum": 0, "savings_sum": 0.0}

        # Longest-prefix continuation (prefix_continue_budget > 0): every
        # prefill allocates `budget` extra recent-ring slots so a cached
        # prefix state can absorb up to `budget` suffix tokens via
        # extend_prefill while every slot keeps identical leaf shapes
        # (required by the batched-state row insert).
        self.prefix_continue_budget = prefix_continue_budget
        ring_cap = max_new_tokens + prefix_continue_budget
        self._prefill = jax.jit(lambda p, i, n: llama.prefill_compressed(
            p, i, mcfg, ccfg, max_decode_len=ring_cap,
            use_flash=use_flash, lengths=n, mesh=mesh))
        # Chunked prefill (prefill_chunk=c): admissions advance c prompt
        # tokens per engine step, so active slots' decode latency is bounded
        # by one chunk's time instead of a full-prompt prefill (vLLM-style).
        # The chunk offset is traced state → ONE compile serves every chunk.
        # "auto" chunks only when the estimated one-shot prefill exceeds the
        # HOL budget (resolve_prefill_chunk — at short contexts chunking
        # worsens HOL).
        if prefill_chunk == "auto":
            prefill_chunk = resolve_prefill_chunk(params, mcfg, context_len)
        self.prefill_chunk = prefill_chunk
        if prefill_chunk:
            if context_len % prefill_chunk:
                raise ValueError(
                    f"context_len={context_len} must be a multiple of "
                    f"prefill_chunk={prefill_chunk}")
            self._chunk_step = jax.jit(
                lambda p, i, t, n: llama.prefill_chunked_step(
                    p, i, t, mcfg, ccfg, lengths=n, use_flash=use_flash))
            self._chunk_finish = jax.jit(
                lambda p, t, n: llama.prefill_chunked_finish(
                    p, t, mcfg, ccfg, max_decode_len=ring_cap,
                    lengths=n, mesh=mesh))
        self._chunked: List[Dict[str, Any]] = []
        if mesh is not None:
            # Re-commit the slot layout after each insert: the admitted
            # row comes from a differently-sharded (often replicated,
            # batch<data-axis) prefill state, and without the constraint
            # GSPMD lets the scattered state's layout drift, paying
            # involuntary rematerializations in the decode step.
            from ..parallel.sharding import constrain_decode_state

            self._insert = jax.jit(lambda b, m, r, s: constrain_decode_state(
                _tree_insert_row(b, m, r, s), mesh))
        else:
            self._insert = jax.jit(_tree_insert_row)  # one dispatch/insert
        self._materialize = jax.jit(
            lambda s: jax.tree_util.tree_map(
                lambda x: jnp.repeat(x[:1], num_slots, axis=0), s))
        if sampling is None:
            from ..ops.sampling import SamplingParams

            sampling = SamplingParams(temperature=temperature)
        self.temperature = sampling.temperature
        self.sampling = sampling
        # Keys/tokens must be global arrays under a process-spanning mesh so
        # decode can mix them with the mesh-sharded state in one program
        # (same seed everywhere); _put is the one placement helper.
        self._rng = self._put(jax.random.PRNGKey(seed))
        # Repetition/presence/frequency penalties need per-slot token
        # occurrence counts persisted ACROSS decode chunks (a fresh count
        # every chunk would forget earlier repeats); the loop returns the
        # updated counts alongside the state.
        self._track_counts = sampling.uses_penalties
        # logprobs=True: every decode chunk also returns the model's
        # log-probability of each emitted token (raw distribution, OpenAI
        # convention); one extra log-softmax per step, negligible next to
        # the layer matmuls. Delivered on Request.logprobs.
        self.logprobs = logprobs
        if self._track_counts:
            self._decode = jax.jit(lambda p, t, s, k, c: llama.decode_loop(
                p, t, s, decode_chunk, mcfg, ccfg, use_fused=use_fused_decode,
                rng=k, sampling=sampling, counts=c, return_counts=True,
                return_logprobs=logprobs))
        else:
            self._decode = jax.jit(lambda p, t, s, k: llama.decode_loop(
                p, t, s, decode_chunk, mcfg, ccfg,
                use_fused=use_fused_decode, rng=k, sampling=sampling,
                return_logprobs=logprobs))

        # Prefix cache (prefix_cache_size > 0): completed prefills keyed by
        # the exact (truncated) prompt are kept as single-row decode states —
        # logits + compressed pools + ring — and re-admitted with zero
        # prefill work. Compression is what makes this cheap: a cached
        # prefix holds packed sub-byte tier pools, ~4x smaller than a dense
        # prefix cache at the same context. LRU-evicted beyond the size cap.
        from collections import OrderedDict

        self.prefix_cache_size = prefix_cache_size
        self._prefix_cache: Optional[OrderedDict] = (
            OrderedDict() if prefix_cache_size > 0 else None)
        self.prefix_hits = 0
        self.prefix_misses = 0
        # Registered prefixes (register_prefix): shared system prompts a
        # new prompt may EXTEND. A partial hit reuses the prefix's
        # compressed pools verbatim and runs extend_prefill over just the
        # suffix — prefill work proportional to the non-shared tail.
        self._registered: Dict[Tuple[int, ...], Any] = {}
        self.prefix_partial_hits = 0
        self._continue_fns: Dict[int, Any] = {}  # per suffix bucket
        self._extract_row = jax.jit(lambda s, r: jax.tree_util.tree_map(
            lambda x: jax.lax.dynamic_slice_in_dim(x, r, 1, axis=0), s))

        # Batched state, created lazily at first admission.
        self._state: Optional[llama.DecodeState] = None
        self._last_tokens: Optional[Array] = None  # [num_slots]
        self._counts: Optional[Array] = None  # [num_slots, vocab]
        self._active_mask = [False] * num_slots

    # -- public API ---------------------------------------------------------

    def submit(self, input_ids: List[int],
               max_new_tokens: Optional[int] = None,
               stop_sequences: Optional[List[List[int]]] = None,
               eos_token_id: Optional[int] = None,
               on_token=None) -> int:
        """Queue a request.

        stop_sequences: token-id sequences; generation stops when one
          appears (it stays in the output; matches may span decode chunks).
        eos_token_id: per-request EOS overriding the engine default.
        on_token: streaming callback `f(request, new_tokens: List[int])`,
          invoked from the host loop after each decode chunk with the tokens
          that survived EOS/stop/budget truncation.
        """
        rid = self._next_rid
        self._next_rid += 1
        self._pending.append(Request(
            rid=rid, input_ids=list(input_ids),
            max_new_tokens=min(max_new_tokens or self.max_new_tokens,
                               self.max_new_tokens),
            stop_sequences=[list(s) for s in (stop_sequences or [])],
            eos_token_id=eos_token_id, on_token=on_token))
        return rid

    def warmup(self) -> Dict[str, Any]:
        """Compile every program the serving load will hit, BEFORE traffic.

        Admission pads its prefill batch to a power of two, so a server with
        N slots can hit ceil-pow2 batch sizes {1, 2, 4, ..} — each a distinct
        XLA program whose in-window compile (tens of seconds) would
        otherwise land on the first unlucky client. This drives one
        admission at every reachable padded batch size, plus the slot
        insert and the full-batch decode chunk.

        The warmup prompts are DISTINCT: identical prompts in one admission
        batch share a single prefill row (in-batch dedupe) and later ones
        hit the prefix cache, so same-prompt warmups never compile the
        multi-row programs, and in-window compiles would then be
        mis-attributed to steady-state overhead.

        Returns {"batch_sizes": [...], "wall_s": ...}.
        """
        t0 = time.time()
        agg_before = dict(self._agg)
        cache_before = (set(self._prefix_cache)
                        if self._prefix_cache is not None else set())
        sizes = sorted({1 << (k - 1).bit_length()
                        for k in range(1, self.num_slots + 1)})
        n, rids = 0, []
        for b in sizes:
            for _ in range(min(b, self.num_slots)):
                n += 1
                ids = [1] * 7 + [2 + (n % max(self.mcfg.vocab_size - 3, 1))]
                rids.append(self.submit(ids,
                                        max_new_tokens=self.decode_chunk + 1))
            self.run()
        # Warmup must not leak into serving state: drop its completed
        # requests, lifetime aggregates, and prefix-cache junk entries.
        for rid in rids:
            self.release(rid)
        self._agg = agg_before
        if self._prefix_cache is not None:
            for key in [k for k in self._prefix_cache
                        if k not in cache_before]:
                del self._prefix_cache[key]
            self.prefix_misses = 0
            self.prefix_hits = 0
        return {"batch_sizes": sizes, "wall_s": time.time() - t0}

    def register_prefix(self, input_ids: List[int]) -> None:
        """Prefill and pin a shared prefix (e.g. a system prompt).

        Later prompts that EXTEND it admit via a partial prefix-cache hit:
        the prefix's compressed pools are reused verbatim and only the
        suffix runs through `extend_prefill` — prefill work proportional
        to the non-shared tail, which for the dominant serving pattern
        (one system prompt, many questions) is the whole point. Requires
        `prefix_continue_budget` >= the longest expected suffix.
        """
        if not self.prefix_continue_budget:
            raise ValueError(
                "register_prefix requires prefix_continue_budget > 0 "
                "(ring headroom for the continuation suffix)")
        import numpy as np

        from ..parallel.mesh import DATA_AXIS

        ids, length = self._bucket_ids(input_ids)
        key = tuple(ids[:length])
        if key in self._registered:
            return
        ids_arr = self._put(np.asarray([ids], np.int32), DATA_AXIS)
        len_arr = self._put(np.asarray([length], np.int32), DATA_AXIS)
        logits, state, stats = self._prefill(self.params, ids_arr, len_arr)
        row_stats = summarize_layer_stats_per_row(stats, 1)[0]
        self._registered[key] = (logits, state, row_stats)

    def _find_partial(self, key: Tuple[int, ...]):
        """Longest registered prefix that `key` strictly extends, within
        the continuation budget."""
        best = None
        for rkey in self._registered:
            if (len(rkey) < len(key) and key[:len(rkey)] == rkey
                    and len(key) - len(rkey) <= self.prefix_continue_budget
                    and (best is None or len(rkey) > len(best))):
                best = rkey
        return best

    def _continue_entry(self, rkey: Tuple[int, ...], key: Tuple[int, ...]):
        """Build an admission entry by extending a registered prefix with
        the request's suffix (compiled once per pow2 suffix bucket)."""
        import numpy as np

        logits0, state0, stats0 = self._registered[rkey]
        suffix = list(key[len(rkey):])
        t = len(suffix)
        bucket = max(8, 1 << (t - 1).bit_length())
        if bucket not in self._continue_fns:
            from ..models import speculative

            self._continue_fns[bucket] = jax.jit(
                lambda p, st, suf, n: speculative.extend_prefill(
                    p, st, suf, n, self.mcfg, self.ccfg))
        suf = self._put(np.asarray([suffix + [0] * (bucket - t)], np.int32))
        lens = self._put(np.asarray([t], np.int32))
        logits, state = self._continue_fns[bucket](self.params, state0,
                                                   suf, lens)
        stats = dict(stats0)
        stats["prefix_partial"] = True
        stats["suffix_tokens"] = t
        return (logits, state, stats)

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._inflight)
                or bool(self._chunked) or any(self._active_mask))

    def run(self, max_steps: int = 10_000) -> Dict[int, Request]:
        """Drive until all submitted requests complete."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.completed

    # -- internals ----------------------------------------------------------

    def _bucket_ids(self, ids: List[int]) -> Tuple[List[int], int]:
        """Right-pad to the serving bucket; true length rides along (ragged
        prefill never stores or attends padding)."""
        from ..utils.data import truncate_middle

        ids = truncate_middle(ids, self.context_len)
        length = len(ids)
        return ids + [0] * (self.context_len - length), length

    def _start_admissions(self, pairs: List[Tuple[Request, int]]):
        """One batched prefill for every admitted request (padded to a
        power-of-two batch so compile count stays O(log slots)); dispatched
        WITHOUT a host sync — completion is polled via Array.is_ready()
        between decode chunks, so admission pipelines with decode.
        Prefix-cache hits skip the prefill entirely: the cached single-row
        decode state is inserted into the slot immediately."""
        hits = []
        rows, lengths = [], []   # unique prompts only
        row_of_key: Dict[Tuple[int, ...], int] = {}
        keyed = []               # (req, slot, key, prefill_row)
        for req, slot in pairs:
            ids, length = self._bucket_ids(req.input_ids)
            key = tuple(ids[:length])
            entry = (self._prefix_cache.get(key)
                     if self._prefix_cache is not None else None)
            if entry is None:
                entry = self._registered.get(key)  # exact registered hit
            if entry is not None:
                if self._prefix_cache is not None and key in self._prefix_cache:
                    self._prefix_cache.move_to_end(key)
                self.prefix_hits += 1
                hits.append((req, slot, entry))
                continue
            if entry is None and self._registered:
                rkey = self._find_partial(key)
                if rkey is not None:
                    # Partial hit: reuse the registered prefix's compressed
                    # pools; prefill only the suffix (extend_prefill).
                    self.prefix_partial_hits += 1
                    hits.append((req, slot,
                                 self._continue_entry(rkey, key)))
                    continue
            # Identical prompts in the same admission batch share one
            # prefill row (their decode states diverge only after the slot
            # insert, so sharing is exact).
            row = row_of_key.get(key)
            if row is None:
                row = row_of_key[key] = len(rows)
                rows.append(ids)
                lengths.append(length)
                if self._prefix_cache is not None:
                    self.prefix_misses += 1
            elif self._prefix_cache is not None:
                self.prefix_hits += 1  # served without its own prefill row
            keyed.append((req, slot, key, row))
        for req, slot, entry in hits:
            self._slots[slot] = req
            self._complete_cached(req, slot, entry)
        if not keyed:
            return
        bsz = 1 << (len(rows) - 1).bit_length()
        while len(rows) < bsz:  # pad rows: prefilled but never inserted
            rows.append(rows[0])
            lengths.append(lengths[0])
        # Batch shards over `data` when divisible (global_put falls back to
        # replicated otherwise), whether or not the mesh spans processes.
        import numpy as np

        from ..parallel.mesh import DATA_AXIS

        ids_arr = self._put(np.asarray(rows, np.int32), DATA_AXIS)
        len_arr = self._put(np.asarray(lengths, np.int32), DATA_AXIS)
        for req, slot, _key, _row in keyed:
            self._slots[slot] = req  # reserve; not active until ready
        if self.prefill_chunk:
            # Only the chunks covering the longest real prompt run; the
            # finish pass masks everything past each row's true length.
            n_chunks = -(-max(lengths) // self.prefill_chunk)
            rec = {"keyed": keyed, "ids": ids_arr, "lens": len_arr,
                   "st": llama.prefill_chunked_init(
                       len(rows), self.context_len, self.mcfg, self.ccfg),
                   "off": 0, "end": n_chunks * self.prefill_chunk}
            if not self._advance_chunked(rec):  # dispatch the first chunk
                self._chunked.append(rec)
            return
        logits, state, stats = self._prefill(self.params, ids_arr, len_arr)
        self._inflight.append((keyed, logits, state, stats))

    def _advance_chunked(self, rec) -> bool:
        """Dispatch one prefill chunk; on the last chunk, compress into the
        decode state and hand off to the normal admission-completion path.
        Returns True when the record is finished."""
        c = self.prefill_chunk
        off = rec["off"]
        rec["st"] = self._chunk_step(self.params, rec["ids"][:, off:off + c],
                                     rec["st"], rec["lens"])
        rec["off"] = off + c
        if rec["off"] >= rec["end"]:
            logits, state, stats = self._chunk_finish(self.params, rec["st"],
                                                      rec["lens"])
            self._inflight.append((rec["keyed"], logits, state, stats))
            return True
        return False

    def _put(self, x, *spec):
        """Place a host value: global array on the mesh (works whether or
        not the mesh spans processes), plain device array otherwise."""
        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P

            from ..parallel.multihost import global_put

            return global_put(x, self.mesh, P(*spec))
        return jnp.asarray(x)

    def _host(self, x):
        """Read a (possibly cross-process) array back to every host. Gated
        on addressability: local arrays must not issue collectives."""
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            from jax.experimental import multihost_utils

            return multihost_utils.process_allgather(x, tiled=True)
        return jax.device_get(x)

    def _complete_admission(self, pairs, logits, state, stats):
        # Work in PAIR space: requests sharing a prefill row (in-batch
        # duplicates) still sample independent first tokens.
        rows_idx = jnp.asarray([row for *_, row in pairs], jnp.int32)
        pair_logits = jnp.take(logits, rows_idx, axis=0)  # [n_pairs, V]
        if self.sampling.is_greedy:
            first_toks = jnp.argmax(pair_logits, axis=-1)
        else:
            from ..ops.sampling import sample_logits

            self._rng, sub = jax.random.split(self._rng)
            first_toks = sample_logits(pair_logits, sub, self.sampling)
        toks_host = self._host(first_toks)
        lp0_host = None
        if self.logprobs:
            lp = jax.nn.log_softmax(pair_logits.astype(jnp.float32), axis=-1)
            lp0_host = self._host(
                jnp.take_along_axis(lp, first_toks[:, None], axis=-1)[:, 0])
        n_rows = 1 + max(row for *_, row in pairs)
        row_stats = summarize_layer_stats_per_row(stats, n_rows)
        self._ensure_state(state)
        for i, (req, slot, key, row) in enumerate(pairs):
            tok0 = int(toks_host[i])
            req.ttft = time.time() - req.submitted_at
            req.prefill_stats = row_stats[row]
            self._state = self._insert(self._state, state, row, slot)
            if (self._prefix_cache is not None
                    and key not in self._prefix_cache):
                row_i = jnp.asarray(row, jnp.int32)
                self._prefix_cache[key] = (
                    self._extract_row(logits, row_i),       # [1, V]
                    self._extract_row(state, row_i),        # single-row state
                    dict(row_stats[row]))
                while len(self._prefix_cache) > self.prefix_cache_size:
                    self._prefix_cache.popitem(last=False)  # LRU
            self._activate(
                req, slot, tok0,
                None if lp0_host is None else float(lp0_host[i]))

    def _ensure_state(self, template_state):
        """Materialize the batched slot state (lazily, at first admission)
        from any single/multi-row state with the canonical leaf shapes."""
        if self._state is not None:
            return
        self._state = self._materialize(template_state)
        if self.mesh is not None:
            from ..parallel.sharding import constrain_decode_state
            self._state = jax.jit(
                lambda s: constrain_decode_state(s, self.mesh))(self._state)
        import numpy as np

        self._last_tokens = self._put(np.zeros((self.num_slots,), np.int32))
        if self._track_counts:
            self._counts = self._put(np.zeros(
                (self.num_slots, self.mcfg.vocab_size), np.int32))

    def _complete_cached(self, req: Request, slot: int, entry):
        """Admit a prefix-cache hit: no prefill — sample the first token
        from the cached logits and insert the cached single-row state."""
        logits_row, state_row, stats_row = entry
        self._ensure_state(state_row)
        if self.sampling.is_greedy:
            first = jnp.argmax(logits_row, axis=-1)  # [1]
        else:
            from ..ops.sampling import sample_logits

            self._rng, sub = jax.random.split(self._rng)
            first = sample_logits(logits_row, sub, self.sampling)
        tok0 = int(self._host(first)[0])
        lp0 = None
        if self.logprobs:
            lp = jax.nn.log_softmax(logits_row.astype(jnp.float32), axis=-1)
            lp0 = float(self._host(
                jnp.take_along_axis(lp, first[:, None], axis=-1))[0, 0])
        req.ttft = time.time() - req.submitted_at
        req.prefill_stats = dict(stats_row)
        self._state = self._insert(self._state, state_row, 0, slot)
        self._activate(req, slot, tok0, lp0)

    def _activate(self, req: Request, slot: int, tok0: int,
                  lp0: Optional[float]):
        """Shared admission tail: arm the slot for decode and deliver the
        first token (EOS/stop/budget rules apply to it too)."""
        self._last_tokens = self._last_tokens.at[slot].set(tok0)
        if self._track_counts:  # fresh counts for the slot's new request
            self._counts = self._counts.at[slot].set(0)
            self._counts = self._counts.at[slot, tok0].add(1)
        self._slot_budget[slot] = req.max_new_tokens - 1
        self._active_mask[slot] = True
        _, reason = self._deliver(slot, [tok0],
                                  None if lp0 is None else [lp0])
        if reason is not None:
            self._finish(slot, reason)
        elif self._slot_budget[slot] <= 0:
            self._finish(slot, "length")

    def _deliver(self, slot: int, new: List[int],
                 lps: Optional[List[float]]
                 ) -> Tuple[int, Optional[str]]:
        """Append freshly decoded tokens to the slot's request, applying
        EOS then stop-sequence truncation; streams kept tokens via the
        request's on_token callback. Returns (n_kept, finish_reason)."""
        req = self._slots[slot]
        eos = (req.eos_token_id if req.eos_token_id is not None
               else self.eos_token_id)
        reason = None
        if eos is not None and eos in new:
            new = new[:new.index(eos) + 1]
            reason = "eos"
        start = len(req.tokens)
        req.tokens.extend(new)
        if lps is not None:
            req.logprobs.extend(lps[:len(new)])
        # Stop sequences may span decode-chunk boundaries: search for
        # matches ENDING in the newly appended region; earliest end wins
        # (and can pre-empt an EOS later in the same chunk).
        if req.stop_sequences:
            cut = None
            for s in req.stop_sequences:
                lo = max(len(s), start + 1)
                for end in range(lo, len(req.tokens) + 1):
                    if req.tokens[end - len(s):end] == s:
                        cut = end if cut is None else min(cut, end)
                        break
            if cut is not None:
                del req.tokens[cut:]
                del req.logprobs[cut:]
                new = req.tokens[start:]
                reason = "stop"
        if req.on_token is not None and new:
            req.on_token(req, list(new))
        return len(new), reason

    def _finish(self, slot: int, reason: str = "length"):
        req = self._slots[slot]
        if req is not None:
            req.stop_reason = req.stop_reason or reason
            req.finished = True
            req.finished_at = time.time()
            if isinstance(req.prefill_stats, list):  # device stats → floats
                req.prefill_stats = summarize_layer_stats(req.prefill_stats)
            self.completed[req.rid] = req
            self._agg["completed"] += 1
            self._agg["ttft_sum"] += req.ttft or 0.0
            self._agg["wall_sum"] += req.finished_at - req.submitted_at
            self._agg["tokens_sum"] += len(req.tokens)
            self._agg["savings_sum"] += (req.prefill_stats or {}).get(
                "avg_memory_savings", 0.0)
        self._slots[slot] = None
        self._active_mask[slot] = False

    def _poll_inflight(self, force: bool = False):
        still = []
        for item in self._inflight:
            pairs, logits, state, stats = item
            if force or logits.is_ready():
                self._complete_admission(pairs, logits, state, stats)
            else:
                still.append(item)
        self._inflight = still

    def step(self):
        # 1) Admit pending requests into free slots — one batched prefill.
        pairs = []
        for slot in range(self.num_slots):
            if self._slots[slot] is None and self._pending:
                pairs.append((self._pending.popleft(), slot))
        if pairs:
            self._start_admissions(pairs)
        # 1b) Advance in-progress chunked prefills — ONE chunk per engine
        # step while decode is active (that's the interleaving), to
        # completion when there is nothing to decode or admission is sync.
        if self._chunked:
            drain = not self.async_admission or not any(self._active_mask)
            still = []
            for rec in self._chunked:
                done = self._advance_chunked(rec)
                while drain and not done:
                    done = self._advance_chunked(rec)
                if not done:
                    still.append(rec)
            self._chunked = still
        if pairs and not self.async_admission:
            self._poll_inflight(force=True)
        if self.async_admission:
            # Nothing to decode yet → block on the oldest admission.
            self._poll_inflight(force=not any(self._active_mask))
        if not any(self._active_mask):
            return

        # 2) One decode chunk for the whole batch.
        self._rng, sub = jax.random.split(self._rng)
        args = (self.params, self._last_tokens, self._state, sub)
        if self._track_counts:
            res = self._decode(*args, self._counts)
            self._counts = res[2]
        else:
            res = self._decode(*args)
        toks, self._state = res[0], res[1]
        lps_host = self._host(res[-1]) if self.logprobs else None
        toks_host = self._host(toks)  # [num_slots, decode_chunk]
        self._last_tokens = toks[:, -1]

        # 3) Distribute tokens, finish slots.
        for slot in range(self.num_slots):
            if not self._active_mask[slot]:
                continue
            take = min(self.decode_chunk, self._slot_budget[slot])
            new = [int(t) for t in toks_host[slot][:take]]
            lps = (None if lps_host is None
                   else [float(x) for x in lps_host[slot][:take]])
            _, reason = self._deliver(slot, new, lps)
            self._slot_budget[slot] -= take
            if reason is not None:
                self._finish(slot, reason)
            elif self._slot_budget[slot] <= 0:
                self._finish(slot, "length")

    # -- stats --------------------------------------------------------------

    def release(self, rid: int):
        """Pop a resolved request out of `completed`. Callers that hold the
        result elsewhere (the HTTP server's jobs) must release, or a
        long-running server accumulates every request ever served; lifetime
        stats live in O(1) aggregates so `summary()` is unaffected."""
        return self.completed.pop(rid, None)

    def snapshot(self) -> Dict[str, Any]:
        """Cheap occupancy snapshot (for cross-thread /health-style reads —
        callers outside the engine's driver thread should consume a copy
        published by the driver rather than reading private fields)."""
        return {"pending": len(self._pending),
                "active_slots": int(sum(self._active_mask)),
                "num_slots": self.num_slots}

    def summary(self) -> Dict[str, Any]:
        n = self._agg["completed"]
        if not n:
            return {"completed": 0}
        out = {
            "completed": n,
            "avg_ttft_s": self._agg["ttft_sum"] / n,
            "avg_wall_s": self._agg["wall_sum"] / n,
            "total_tokens": self._agg["tokens_sum"],
            "avg_memory_savings": self._agg["savings_sum"] / n,
        }
        if self._prefix_cache is not None or self._registered:
            out["prefix_cache"] = {
                "hits": self.prefix_hits,
                "misses": self.prefix_misses,
                "partial_hits": self.prefix_partial_hits,
                "entries": (len(self._prefix_cache)
                            if self._prefix_cache is not None else 0),
                "registered": len(self._registered)}
        return out

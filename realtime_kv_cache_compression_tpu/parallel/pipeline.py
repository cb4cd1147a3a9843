"""Pipeline parallelism over a `pipe` mesh axis.

SURVEY.md §2.6 marks pipeline parallelism "optional — no reference
counterpart" (the reference is single-GPU, single-process). Two forms live here, chosen per use case:

1. `pipeline_train_step` / `pipeline_lm_loss` — **GPipe-style SPMD
   schedule** for training: layers stacked and split over the `pipe` axis
   under `shard_map`, activations rotated stage→stage with `lax.ppermute`,
   microbatches streamed through a `lax.scan` over schedule ticks. One
   jitted, differentiable program; the backward pass reverses the ppermute
   automatically. Training has uniform per-layer shapes (no KV caches), so
   the single-program SPMD form fits exactly.

2. `PipelineInference` — **per-stage programs** for compressed inference:
   each stage holds its layer slice (params on its own device) and runs a
   separately-jitted prefill/decode segment with the layer-EXACT static
   cache shapes (tier capacities depend on absolute depth via the
   0.8/0.6/0.4 layer-group ratios — an SPMD single-program pipeline would
   force every stage to the worst-case capacity, forfeiting the memory win;
   per-stage programs keep it). Activations hop stages via `device_put`
   (device-to-device transfers); dispatch is async, so microbatches overlap across
   stages in a wavefront. Decode traverses stages sequentially per token —
   the standard PP-inference latency tradeoff; serving should prefer
   tensor parallelism (parallel/sharding.py) and sequence parallelism
   (parallel/seq_parallel.py), which this framework makes first-class.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import CompressionConfig, ModelConfig
from ..models import llama

Array = jax.Array
Params = Dict[str, Any]

PIPE_AXIS = "pipe"


def create_pipe_mesh(n: int, devices: Optional[Sequence[jax.Device]] = None
                     ) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())[:n]
    return Mesh(np.asarray(devices), (PIPE_AXIS,))


# ---------------------------------------------------------------------------
# SPMD GPipe training
# ---------------------------------------------------------------------------

def stack_pipeline_params(params: Params, mesh: Mesh) -> Params:
    """Stack per-layer param dicts into leading-[L] leaves and shard the
    layer axis over `pipe` (embed/norms/lm_head replicate).

    num_layers must divide the pipe axis size evenly.
    """
    n_stages = mesh.shape[PIPE_AXIS]
    n_layers = len(params["layers"])
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by "
                         f"{n_stages} pipeline stages")
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs),
                                     *params["layers"])
    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = jax.device_put(
        stacked, NamedSharding(mesh, P(PIPE_AXIS)))
    rep = NamedSharding(mesh, P())
    for k in list(out):
        if k != "layers":
            out[k] = jax.device_put(out[k], rep)
    return out


def unstack_pipeline_params(stacked: Params) -> Params:
    """Inverse of `stack_pipeline_params` (gathers to host layout)."""
    n_layers = jax.tree_util.tree_leaves(stacked["layers"])[0].shape[0]
    layers = [jax.tree_util.tree_map(lambda x, i=i: x[i], stacked["layers"])
              for i in range(n_layers)]
    out = {k: v for k, v in stacked.items() if k != "layers"}
    out["layers"] = layers
    return out


def _run_stage(layers_local, h: Array, cos, sin, cfg: ModelConfig) -> Array:
    """Apply this stage's stacked layer slice sequentially (lax.scan over
    the layer axis — uniform shapes, one compiled body)."""
    b, s = h.shape[:2]

    def body(h, layer):
        x = llama.rmsnorm(h, layer["input_norm"], cfg.rms_norm_eps)
        q, k, v = llama._qkv(layer, x, cfg)
        q = llama.apply_rope(q, cos, sin)
        k = llama.apply_rope(k, cos, sin)
        from ..ops.attention import prefill_attention_with_prompt_mass
        attn_out, _ = prefill_attention_with_prompt_mass(q, k, v, 1)
        h = h + llama._matmul(attn_out.reshape(b, s, cfg.q_dim),
                              layer["wo"])
        h = h + llama._mlp(
            layer, llama.rmsnorm(h, layer["post_norm"], cfg.rms_norm_eps),
            cfg)
        return h, None

    h, _ = jax.lax.scan(body, h, layers_local)
    return h


def pipeline_lm_loss(stacked_params: Params, input_ids: Array,
                     cfg: ModelConfig, mesh: Mesh,
                     n_microbatches: int) -> Array:
    """Mean next-token cross-entropy computed through the pipeline.

    Matches models.train.lm_loss on the same batch (parity-tested); the
    schedule runs n_microbatches + n_stages - 1 ticks, so the bubble
    fraction is (S-1)/(M+S-1).
    """
    n_stages = mesh.shape[PIPE_AXIS]
    b, s = input_ids.shape
    if b % n_microbatches:
        raise ValueError(f"batch {b} not divisible by {n_microbatches} "
                         f"microbatches")
    mb = b // n_microbatches
    ids_mb = input_ids.reshape(n_microbatches, mb, s)
    dtype = jnp.dtype(cfg.dtype)
    tied = cfg.tie_word_embeddings
    lm_head = (stacked_params.get("lm_head")
               if not tied else stacked_params["embed"])

    def spmd(layers_local, embed, final_norm, lm_head, ids_mb):
        idx = jax.lax.axis_index(PIPE_AXIS)
        n_ticks = n_microbatches + n_stages - 1
        positions = jnp.broadcast_to(jnp.arange(s)[None], (mb, s))
        cos, sin = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                                     cfg.rope_scaling)

        def tick(carry, t):
            act, loss_acc = carry
            # Stage 0 injects microbatch t (clamped; extra injections flow
            # as dead wavefronts that never reach a valid loss slot).
            mb_in = jnp.clip(t, 0, n_microbatches - 1)
            ids_t = jax.lax.dynamic_index_in_dim(ids_mb, mb_in, 0,
                                                 keepdims=False)
            inj = llama._embed_lookup(embed, ids_t, dtype, cfg=cfg)
            act = jnp.where(idx == 0, inj, act)
            act = _run_stage(layers_local, act, cos, sin, cfg)

            # Last stage scores microbatch t - (n_stages - 1).
            out_mb = t - (n_stages - 1)
            tgt_t = jax.lax.dynamic_index_in_dim(
                ids_mb, jnp.clip(out_mb, 0, n_microbatches - 1), 0,
                keepdims=False)
            hn = llama.rmsnorm(act, final_norm, cfg.rms_norm_eps)
            logits = (hn @ lm_head.T if tied else
                      hn @ lm_head).astype(jnp.float32)
            logp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
            nll = -jnp.take_along_axis(
                logp, tgt_t[:, 1:, None], axis=-1)[..., 0].mean()
            valid = (idx == n_stages - 1) & (out_mb >= 0)
            loss_acc = loss_acc + jnp.where(valid, nll, 0.0)

            act = jax.lax.ppermute(
                act, PIPE_AXIS,
                [(i, (i + 1) % n_stages) for i in range(n_stages)])
            return (act, loss_acc), None

        act0 = jnp.zeros((mb, s, cfg.hidden_size), dtype)
        (_, loss_acc), _ = jax.lax.scan(tick, (act0, jnp.float32(0.0)),
                                        jnp.arange(n_ticks))
        return jax.lax.psum(loss_acc, PIPE_AXIS) / n_microbatches

    fn = jax.shard_map(
        spmd, mesh=mesh,
        in_specs=(P(PIPE_AXIS), P(), P(), P(), P()),
        out_specs=P(), check_vma=False)
    return fn(stacked_params["layers"], stacked_params["embed"],
              stacked_params["final_norm"], lm_head, ids_mb)


def pipeline_train_step(stacked_params: Params, opt_state, input_ids: Array,
                        cfg: ModelConfig, optimizer, mesh: Mesh,
                        n_microbatches: int):
    """One pipelined training step (loss + grads + AdamW update); layer
    grads stay sharded on their stage."""
    import optax

    loss, grads = jax.value_and_grad(pipeline_lm_loss)(
        stacked_params, input_ids, cfg, mesh, n_microbatches)
    updates, opt_state = optimizer.update(grads, opt_state, stacked_params)
    stacked_params = optax.apply_updates(stacked_params, updates)
    return stacked_params, opt_state, loss


# ---------------------------------------------------------------------------
# Per-stage compressed inference pipeline
# ---------------------------------------------------------------------------

class PipelineInference:
    """Compressed prefill + decode with layers split across devices.

    Each stage's layer params live on its own device; prefill/decode stage
    programs are jitted per stage with that stage's exact static cache
    shapes (absolute-depth layer ratios preserved — no worst-case padding).
    Activations hop stages via device_put; dispatches are async, so
    consecutive microbatches overlap in a wavefront.
    """

    def __init__(self, params: Params, cfg: ModelConfig,
                 ccfg: CompressionConfig, n_stages: int,
                 max_decode_len: int = 128, use_flash: bool = False,
                 use_fused: bool = False,
                 devices: Optional[Sequence[jax.Device]] = None):
        if cfg.num_layers % n_stages:
            raise ValueError(f"{cfg.num_layers} layers not divisible by "
                             f"{n_stages} stages")
        self.cfg, self.ccfg = cfg, ccfg
        self.n_stages = n_stages
        self.per = cfg.num_layers // n_stages
        self.max_decode_len = max_decode_len
        self.use_flash = use_flash
        self.use_fused = use_fused
        self.devices = list(devices if devices is not None
                            else jax.devices())[:n_stages]
        if len(self.devices) < n_stages:
            raise ValueError(f"need {n_stages} devices, have "
                             f"{len(self.devices)}")

        self.stage_layers = [
            jax.device_put(params["layers"][i * self.per:(i + 1) * self.per],
                           self.devices[i])
            for i in range(n_stages)]
        self.embed_first = jax.device_put(params["embed"], self.devices[0])
        last = self.devices[-1]
        self.head_last = {
            "embed": jax.device_put(params["embed"], last),
            "final_norm": jax.device_put(params["final_norm"], last),
        }
        if not cfg.tie_word_embeddings:
            self.head_last["lm_head"] = jax.device_put(params["lm_head"],
                                                       last)

        self._prefill_stage = [
            jax.jit(functools.partial(self._prefill_stage_fn, stage=i))
            for i in range(n_stages)]
        self._decode_stage = [
            jax.jit(functools.partial(self._decode_stage_fn, stage=i))
            for i in range(n_stages)]
        # Per-stage decode state: (caches, recents, pools) local tuples.
        self._state: List[Optional[Tuple]] = [None] * n_stages
        self._position: Optional[Array] = None

    # -- stage bodies (jitted once per stage) ------------------------------

    def _prefill_stage_fn(self, layer_params, h, positions, cos, sin,
                          *, stage: int):
        cfg, ccfg = self.cfg, self.ccfg
        s = h.shape[1]
        prompt_len = ccfg.prompt_length(s)
        h, caches, recents, pools, stats = llama.prefill_layers_compressed(
            layer_params, stage * self.per, h, positions, cos, sin,
            prompt_len, cfg, ccfg, self.max_decode_len,
            use_flash=self.use_flash)
        return h, (tuple(caches), tuple(recents), tuple(pools)), stats

    def _decode_stage_fn(self, layer_params, h, caches, recents, pools,
                         q_pos, cos, sin, *, stage: int):
        h, new_recents, new_pools = llama.decode_layers_step(
            layer_params, h, caches, recents, pools, q_pos, cos, sin,
            self.cfg, self.ccfg, use_fused=self.use_fused)
        return h, tuple(new_recents), tuple(new_pools)

    # -- public API --------------------------------------------------------

    def prefill(self, input_ids: Array):
        """Compressed prefill through all stages.

        Returns (last-position logits [B, V], per-layer stats list).
        """
        cfg = self.cfg
        b, s = input_ids.shape
        ids = jax.device_put(input_ids, self.devices[0])
        h = llama._embed_lookup(self.embed_first, ids, jnp.dtype(cfg.dtype),
                                cfg=cfg)
        positions = jnp.broadcast_to(jnp.arange(s)[None], (b, s))
        cos, sin = llama.rope_tables(positions, cfg.head_dim, cfg.rope_theta,
                                     cfg.rope_scaling)
        all_stats: List = []
        for i in range(self.n_stages):
            dev = self.devices[i]
            h = jax.device_put(h, dev)
            pos_d = jax.device_put(positions, dev)
            cos_d = jax.device_put(cos, dev)
            sin_d = jax.device_put(sin, dev)
            h, state_i, stats = self._prefill_stage[i](
                self.stage_layers[i], h, pos_d, cos_d, sin_d)
            self._state[i] = state_i
            all_stats.extend(stats)
        last_h = h[:, -1]
        logits = llama.logits_from_hidden(self.head_last, last_h, cfg)
        self._position = jax.device_put(jnp.full((b,), s, jnp.int32),
                                        self.devices[0])
        return logits, all_stats

    def decode(self, first_token: Array, n_steps: int) -> Array:
        """Greedy decode; each step traverses the stages (PP latency is
        additive per token — use TP for latency-critical serving).

        Returns generated tokens [B, n_steps].
        """
        cfg = self.cfg
        tok = jax.device_put(first_token, self.devices[0])
        outs = []
        for _ in range(n_steps):
            h = llama._embed_lookup(self.embed_first, tok,
                                    jnp.dtype(cfg.dtype), cfg=cfg)[:, None]
            q_pos = self._position[:, None]
            cos, sin = llama.rope_tables(q_pos, cfg.head_dim,
                                         cfg.rope_theta,
                                         cfg.rope_scaling)
            for i in range(self.n_stages):
                dev = self.devices[i]
                h = jax.device_put(h, dev)
                caches, recents, pools = self._state[i]
                h, recents, pools = self._decode_stage[i](
                    self.stage_layers[i], h, caches, recents, pools,
                    jax.device_put(q_pos, dev),
                    jax.device_put(cos, dev), jax.device_put(sin, dev))
                self._state[i] = (caches, recents, pools)
            logits = llama.logits_from_hidden(self.head_last, h[:, 0], cfg)
            tok = jnp.argmax(logits, axis=-1)
            tok = jax.device_put(tok, self.devices[0])
            outs.append(tok)
            self._position = self._position + 1
        return jnp.stack([jax.device_put(t, self.devices[0])
                          for t in outs], axis=1)

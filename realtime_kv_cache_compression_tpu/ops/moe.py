"""Mixture-of-Experts MLP (Mixtral-style) — grouped matmuls.

No reference counterpart (the reference is dense-Llama-only,
/root/reference/src/models/modified_llama.py); this extends the model layer
to the Mixtral family so compressed-KV serving covers sparse checkpoints.
The attention/compression path is untouched — MoE only replaces the MLP.

Routing follows HF Mixtral (MixtralSparseMoeBlock): softmax over all expert
logits in float32, top-k, then renormalize the kept weights.

Three execution strategies, all static-shape and jit-safe:

* ``ragged`` — sort token-slot rows by expert id and run ONE grouped matmul
  per projection via `jax.lax.ragged_dot` ([N*k, H] x [E, H, I] with
  per-expert group sizes). FLOPs are exactly the routed work; the matmul
  sees large contiguous groups. The default for prefill-sized token counts.
* ``gather`` — per-token expert-weight gather + batched einsum. For decode
  (a handful of tokens) this reads only the k routed experts' weights from
  HBM instead of streaming all E; at batch 1 that is a 4x weight-traffic
  saving for Mixtral (k=2, E=8).
* ``dynslice`` — per-routed-expert `dynamic_index_in_dim` + matvec, for
  decode-sized token counts (round 4). The gather path MATERIALIZES the
  routed experts as a fresh [N, k, in, out] buffer (read + write + re-read
  ≈ 3x the expert bytes); a dynamic slice feeds the dot operand stream
  directly, reading each routed expert's weights once.

All paths accept int8 expert stacks (`QuantizedExpertTensor`,
models/quantized_params.py): codes convert in the operand stream and the
per-(expert, out) scale applies to the projection output — halving the
streamed expert bytes, which is the decode bottleneck.
* ``dense`` — every expert processes every token, combined with the sparse
  routing weights. E/k x more FLOPs, but purely einsum-based, so under
  GSPMD with the expert axis sharded over `model` it IS expert parallelism:
  each device computes only its local experts and the combine contraction
  psums across the axis (see parallel/sharding.param_specs). Used for
  jit+GSPMD expert-parallel execution and as the universal fallback.

True capacity-based expert parallelism (per-device FLOPs ~ routed/P) lives
in `parallel/expert_parallel.py` on top of the same router.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

# Below this many tokens the gather path reads less expert-weight HBM than
# a grouped matmul over all experts (decode / tiny prefill).
_GATHER_MAX_TOKENS = 16
# Below this many tokens the unrolled dynamic-slice path wins: it reads
# routed experts' bytes exactly once (no gather materialization). The
# unroll is N*k*3 matvecs — keep it decode-sized.
_DYNSLICE_MAX_TOKENS = 8


def router_topk(x2: Array, gate: Array, num_experts_per_tok: int,
                norm_topk: bool = True) -> Tuple[Array, Array]:
    """Top-k routing (HF Mixtral semantics).

    Args:
      x2: [N, H] tokens.
      gate: [H, E] router weights.

    Returns (weights [N, k] float32, expert ids [N, k] int32).
    """
    logits = x2.astype(jnp.float32) @ gate.astype(jnp.float32)  # [N, E]
    probs = jax.nn.softmax(logits, axis=-1)
    w, ids = jax.lax.top_k(probs, num_experts_per_tok)
    if norm_topk:
        w = w / jnp.sum(w, axis=-1, keepdims=True)
    return w, ids.astype(jnp.int32)


def _act(x: Array, name: str) -> Array:
    if name == "silu":
        return jax.nn.silu(x)
    if name == "gelu_tanh":
        return jax.nn.gelu(x, approximate=True)
    raise ValueError(f"unknown hidden_act {name!r}")


def _codes(wt) -> Array:
    """Expert stack codes/values [E, in, out] (int8 stays int8 here: the
    convert fuses into the consuming contraction's operand stream)."""
    from ..models.quantized_params import QuantizedExpertTensor

    return wt.q if isinstance(wt, QuantizedExpertTensor) else wt


def _scale(wt) -> Optional[Array]:
    from ..models.quantized_params import QuantizedExpertTensor

    return wt.scale if isinstance(wt, QuantizedExpertTensor) else None


def _moe_ragged(moe: Dict[str, Array], x2: Array, w: Array, ids: Array,
                num_experts: int, act: str) -> Array:
    """Sorted grouped-matmul path: one `ragged_dot` per projection."""
    n, k = ids.shape
    flat_ids = ids.reshape(-1)                       # [N*k]
    order = jnp.argsort(flat_ids)                    # stable: ties keep order
    xs = jnp.repeat(x2, k, axis=0)[order]            # rows grouped by expert
    sorted_ids = flat_ids[order]
    group_sizes = jnp.bincount(flat_ids, length=num_experts
                               ).astype(jnp.int32)

    def rdot(lhs, wt):
        y = jax.lax.ragged_dot(lhs, _codes(wt).astype(lhs.dtype),
                               group_sizes)
        s = _scale(wt)
        # Row r belongs to expert sorted_ids[r]; its per-out scale applies
        # to the projection output (a [N*k, out] gather of scale rows).
        return y if s is None else (y * s[sorted_ids]).astype(y.dtype)

    h1 = rdot(xs, moe["w_gate"])
    h2 = rdot(xs, moe["w_up"])
    ys = rdot((_act(h1, act) * h2).astype(xs.dtype), moe["w_down"])
    inv = jnp.argsort(order)                         # unsort
    y = ys[inv].reshape(n, k, -1)
    return jnp.sum(y * w[..., None].astype(y.dtype), axis=1)


def _moe_gather(moe: Dict[str, Array], x2: Array, w: Array, ids: Array,
                act: str) -> Array:
    """Per-token expert gather: HBM reads only the routed experts."""
    def gdot(spec, lhs, wt):
        y = jnp.einsum(spec, lhs, _codes(wt)[ids].astype(lhs.dtype))
        s = _scale(wt)
        return y if s is None else (y * s[ids]).astype(y.dtype)

    h1 = gdot("nh,nkhi->nki", x2, moe["w_gate"])
    h2 = gdot("nh,nkhi->nki", x2, moe["w_up"])
    y = gdot("nki,nkih->nkh", (_act(h1, act) * h2).astype(x2.dtype),
             moe["w_down"])
    return jnp.sum(y * w[..., None].astype(y.dtype), axis=1)


def _moe_dynslice(moe: Dict[str, Array], x2: Array, w: Array, ids: Array,
                  act: str) -> Array:
    """Per-routed-expert dynamic slice + matvec (decode-sized N only:
    the N*k loop unrolls at trace time).

    Reads each routed expert's weights from HBM exactly once, fused into
    the dot operand stream — no [N, k, in, out] gather materialization
    (the r3-measured 4.6x-off-floor defect of the gather path at batch 1).
    """
    def sdot(lhs, wt, e):
        from ..models.quantized_params import Int4ExpertTensor

        if isinstance(wt, Int4ExpertTensor):
            # ONE expert's packed codes through the grouped-einsum int4
            # matmul (models/llama._matmul).
            from ..models.llama import _matmul

            y = _matmul(lhs[None, :].astype(jnp.bfloat16), wt.expert(e))[0]
            return y.astype(jnp.float32)
        mat = jax.lax.dynamic_index_in_dim(_codes(wt), e, 0, keepdims=False)
        y = jnp.dot(lhs, mat.astype(lhs.dtype),
                    preferred_element_type=jnp.float32)
        s = _scale(wt)
        if s is None:
            return y
        return y * jax.lax.dynamic_index_in_dim(s, e, 0, keepdims=False)

    n, k = ids.shape
    outs = []
    for t in range(n):
        xt = x2[t]
        acc = jnp.zeros((x2.shape[1],), jnp.float32)
        for j in range(k):
            e = ids[t, j]
            h1 = sdot(xt, moe["w_gate"], e)
            h2 = sdot(xt, moe["w_up"], e)
            y = sdot((_act(h1, act) * h2).astype(xt.dtype),
                     moe["w_down"], e)
            acc = acc + w[t, j] * y
        outs.append(acc)
    return jnp.stack(outs)


def _moe_dense(moe: Dict[str, Array], x2: Array, w: Array, ids: Array,
               num_experts: int, act: str) -> Array:
    """All-experts einsum path (GSPMD expert parallelism when the expert
    axis is sharded: the final contraction over `e` becomes a psum)."""
    n = x2.shape[0]
    combine = jnp.zeros((n, num_experts), x2.dtype)
    combine = combine.at[jnp.arange(n)[:, None], ids].add(
        w.astype(x2.dtype))                          # [N, E] sparse weights

    def edot(spec, lhs, wt):
        y = jnp.einsum(spec, lhs, _codes(wt).astype(lhs.dtype))
        s = _scale(wt)
        return y if s is None else (y * s[None]).astype(y.dtype)

    h1 = edot("nh,ehi->nei", x2, moe["w_gate"])
    h2 = edot("nh,ehi->nei", x2, moe["w_up"])
    y = edot("nei,eih->neh", (_act(h1, act) * h2).astype(x2.dtype),
             moe["w_down"])
    return jnp.einsum("ne,neh->nh", combine.astype(y.dtype), y)


def moe_mlp(moe: Dict[str, Array], x: Array, cfg,
            impl: Optional[str] = None) -> Array:
    """Sparse MoE MLP over [..., H] hidden states.

    `moe` holds `gate` [H, E], `w_gate`/`w_up` [E, H, I], `w_down` [E, I, H]
    (see models.llama.init_params / models.weights for the layouts).
    `impl` overrides cfg.moe_impl ("auto" | "ragged" | "gather" | "dense").
    """
    impl = impl or getattr(cfg, "moe_impl", "auto")
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    n = x2.shape[0]
    from ..models.quantized_params import Int4ExpertTensor

    if (any(isinstance(v, Int4ExpertTensor) for v in moe.values())
            and not (impl == "dynslice"
                     or (impl == "auto" and n <= _DYNSLICE_MAX_TOKENS))):
        # int4 experts fuse only on the dynslice (decode) path; the
        # batched paths dequantize up-front — prefill is FLOP-bound, so
        # materializing bf16 expert weights there costs bandwidth the
        # matmuls hide (decode, where it cannot hide, takes dynslice).
        moe = {k: (v.dequantize() if isinstance(v, Int4ExpertTensor) else v)
               for k, v in moe.items()}
    w, ids = router_topk(x2, moe["gate"], cfg.num_experts_per_tok)
    if impl == "auto":
        # dynslice for decode-sized batches (no gather materialization —
        # the r3-measured 3x-traffic defect of the gather path), gather up
        # to the weight-traffic crossover, grouped matmuls beyond.
        if n <= _DYNSLICE_MAX_TOKENS:
            impl = "dynslice"
        else:
            impl = "gather" if n <= _GATHER_MAX_TOKENS else "ragged"
    if impl == "ragged":
        out = _moe_ragged(moe, x2, w, ids, cfg.num_experts, cfg.hidden_act)
    elif impl == "gather":
        out = _moe_gather(moe, x2, w, ids, cfg.hidden_act)
    elif impl == "dynslice":
        out = _moe_dynslice(moe, x2, w, ids, cfg.hidden_act)
    elif impl == "dense":
        out = _moe_dense(moe, x2, w, ids, cfg.num_experts, cfg.hidden_act)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    return out.reshape(shape).astype(x.dtype)


def moe_mlp_reference(moe: Dict[str, Array], x: Array, cfg) -> Array:
    """Slow per-expert masked loop — the golden oracle for tests."""
    from ..models.quantized_params import (Int4ExpertTensor,
                                           QuantizedExpertTensor)

    moe = {k: (v.dequantize(jnp.float32)
               if isinstance(v, (QuantizedExpertTensor, Int4ExpertTensor))
               else v)
           for k, v in moe.items()}
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    w, ids = router_topk(x2, moe["gate"], cfg.num_experts_per_tok)
    out = jnp.zeros_like(x2, dtype=jnp.float32)
    for e in range(cfg.num_experts):
        h1 = x2 @ moe["w_gate"][e]
        h2 = x2 @ moe["w_up"][e]
        y = (_act(h1, cfg.hidden_act) * h2) @ moe["w_down"][e]  # [N, H]
        weight = jnp.sum(jnp.where(ids == e, w, 0.0), axis=1)  # [N]
        out = out + weight[:, None] * y.astype(jnp.float32)
    return out.reshape(shape).astype(x.dtype)

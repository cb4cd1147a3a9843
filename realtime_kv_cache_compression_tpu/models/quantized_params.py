"""Weight-only int8 quantization for the params pytree.

North-star capability ("quantized-inference engine"): per-output-channel
symmetric int8 weights halve both the device-memory footprint
(Llama-2-7B: 12.9 GB → 6.6 GB) and the weight-streaming floor of decode
latency. Norm vectors stay in full precision; the embedding table
quantizes per row (gather → scale).

Matmul execution: `llama._matmul` dispatches on `QuantizedTensor`. Default:
the XLA path dequantizes the weight operand into the dot. With
`act_quant=True` (quantize_params(..., act_quant=True)), activations
quantize per token on the fly and the matmul runs int8 x int8 -> int32
through `ops/int8_matmul.py` (the int8 tensor-core rate is twice bf16's).

Round 3 adds **int4 weights** (`quantize_params(..., bits=4)` →
`Int4Tensor`): nibble-packed codes with group-wise scales along the
reduction axis (default group 128, the standard W4 recipe — per-out-channel
int4 alone is too coarse). Decode at batch 1 is weight-streaming-bound, so
halving the weight bytes again (Llama-2-7B: 6.6 GB int8 → 3.4 GB int4)
directly raises the tok/s ceiling. Embedding and lm_head stay int8: their
quality sensitivity is high and they are a small fraction of the bytes.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict

import jax
import jax.numpy as jnp

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedTensor:
    """Symmetric per-out-channel int8 weight: w ≈ q * scale.

    q: [in, out] int8; scale: [out] float32 (or [vocab] per-row for embed,
    with q laid out [vocab, hidden]).
    """

    q: Array
    scale: Array
    axis: int = dataclasses.field(metadata=dict(static=True), default=1)
    # int8 x int8 path: quantize activations per token and run an int8
    # GEMM instead of dequantizing the weight (ops/int8_matmul.py).
    act_quant: bool = dataclasses.field(metadata=dict(static=True),
                                        default=False)

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=jnp.bfloat16) -> Array:
        scale = self.scale
        if self.axis == 0:
            return (self.q.astype(jnp.float32)
                    * scale[:, None]).astype(dtype)
        return (self.q.astype(jnp.float32) * scale[None, :]).astype(dtype)


def quantize_tensor(w: Array, axis: int = 1,
                    act_quant: bool = False) -> QuantizedTensor:
    """Symmetric int8 quantization along `axis` (the preserved channel)."""
    wf = w.astype(jnp.float32)
    reduce_axis = 1 - axis
    absmax = jnp.max(jnp.abs(wf), axis=reduce_axis)
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    scale_b = scale[:, None] if axis == 0 else scale[None, :]
    q = jnp.clip(jnp.round(wf / scale_b), -127, 127).astype(jnp.int8)
    return QuantizedTensor(q=q, scale=scale, axis=axis, act_quant=act_quant)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Int4Tensor:
    """Group-wise symmetric int4 weight: w[i, o] ≈ q[i, o] · scale[i//G, o].

    Codes are stored OFFSET-BINARY: u = q + 8 in [1, 15] (q in [-7, 7]),
    nibble-packed along the IN (reduction) axis in a HALF-SPLIT layout:
    uint8 `q_packed[p, o]` holds row p in its low nibble and row
    p + in_dim/2 in its high nibble. Unpacking is zero-extend + mask/shift
    (no sign-extension double-shift), and the -8 offset folds into a rank-1 correction around the raw code dot:
        x @ W_g = (x_g @ u_g - 8·Σx_g) · s_g
    so a fused dequant-matmul can stream packed bytes at 0.5
    bytes/element. Scales are per
    (group, out-channel), group size G along the reduction axis
    (in_dim % G == 0; callers fall back to one group otherwise). History:
    r3 interleaved signed pairs (16x regression — XLA materialized the
    unpack), r4 half-split signed, r5 offset-binary.
    """

    q_packed: Array  # [in_dim // 2, out] uint8 (two offset-binary nibbles)
    scale: Array     # [in_dim // G, out] float32
    in_dim: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def shape(self):
        return (self.in_dim, self.q_packed.shape[-1])

    @property
    def group_size(self) -> int:
        return self.in_dim // self.scale.shape[0]

    def unpack_codes(self) -> Array:
        """[in_dim, out] int8 codes in [-7, 7] (offset-binary nibbles)."""
        p = self.q_packed.astype(jnp.int32)  # uint8 -> zero-extends
        lo = jnp.bitwise_and(p, 0xF) - 8
        hi = jnp.right_shift(p, 4) - 8
        return jnp.concatenate([lo, hi], axis=0).astype(jnp.int8)

    def dequantize(self, dtype=jnp.bfloat16) -> Array:
        n_g = self.scale.shape[0]
        codes = self.unpack_codes().astype(jnp.float32)
        w = (codes.reshape(n_g, self.group_size, -1)
             * self.scale[:, None, :])
        return w.reshape(self.in_dim, -1).astype(dtype)


def quantize_tensor_int4(w: Array, group_size: int = 128) -> Int4Tensor:
    """Symmetric group-wise int4 quantization along the reduction axis.

    Falls back to a single group when in_dim % group_size != 0. in_dim must
    be even (nibble packing); every transformer matmul dim is.
    """
    wf = w.astype(jnp.float32)
    in_dim, out = wf.shape
    if in_dim % 2:
        raise ValueError(f"int4 packing needs even in_dim, got {in_dim}")
    # The fused kernel needs whole groups per packed half (half-split
    # layout), i.e. in_dim % (2*G) == 0; otherwise fall back to one group.
    g = group_size if in_dim % (2 * group_size) == 0 else in_dim
    n_g = in_dim // g
    grouped = wf.reshape(n_g, g, out)
    absmax = jnp.max(jnp.abs(grouped), axis=1)
    scale = jnp.maximum(absmax, 1e-8) / 7.0
    q = jnp.clip(jnp.round(grouped / scale[:, None, :]), -7, 7)
    u = (q + 8).astype(jnp.uint8).reshape(in_dim, out)  # offset-binary
    half = in_dim // 2
    lo, hi = u[:half], u[half:]  # half-split layout (class docstring)
    packed = jnp.bitwise_or(jnp.left_shift(hi, 4), lo)
    return Int4Tensor(q_packed=packed.astype(jnp.uint8), scale=scale,
                      in_dim=in_dim)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class QuantizedExpertTensor:
    """Per-(expert, out-channel) symmetric int8 MoE weight stack:
    w[e, i, o] ≈ q[e, i, o] · scale[e, o].

    Batch-1 MoE decode is routed-expert-weight-streaming-bound; int8
    experts halve the streamed bytes, and the dequant (convert + per-out
    scale) fuses into each path's einsum/dot operand stream in ops/moe.py.
    """

    q: Array      # [E, in, out] int8
    scale: Array  # [E, out] float32

    @property
    def shape(self):
        return self.q.shape

    def dequantize(self, dtype=jnp.bfloat16) -> Array:
        return (self.q.astype(jnp.float32)
                * self.scale[:, None, :]).astype(dtype)


def quantize_expert_tensor(w: Array) -> QuantizedExpertTensor:
    """Symmetric int8 over the per-expert reduction axis (axis 1)."""
    wf = w.astype(jnp.float32)
    absmax = jnp.max(jnp.abs(wf), axis=1)            # [E, out]
    scale = jnp.maximum(absmax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(wf / scale[:, None, :]), -127, 127).astype(jnp.int8)
    return QuantizedExpertTensor(q=q, scale=scale)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Int4ExpertTensor:
    """Group-wise int4 MoE expert stack: Int4Tensor's half-split packed
    layout (class docstring above) with a leading expert axis.

    Composes the two round-4 decode levers: the dynslice MoE path slices
    ONE expert's packed codes + scales (ops/moe.py) and feeds them to the
    grouped-einsum int4 matmul (models/llama._matmul), so batch-1 MoE
    decode reads only the routed experts' packed bytes.
    """

    q_packed: Array  # [E, in_dim // 2, out] uint8 (offset-binary nibbles)
    scale: Array     # [E, in_dim // G, out] float32
    in_dim: int = dataclasses.field(metadata=dict(static=True), default=0)

    @property
    def shape(self):
        return (self.q_packed.shape[0], self.in_dim,
                self.q_packed.shape[-1])

    @property
    def group_size(self) -> int:
        return self.in_dim // self.scale.shape[1]

    def expert(self, e) -> Int4Tensor:
        """Slice one expert's weight (e may be traced)."""
        return Int4Tensor(
            q_packed=jax.lax.dynamic_index_in_dim(self.q_packed, e, 0,
                                                  keepdims=False),
            scale=jax.lax.dynamic_index_in_dim(self.scale, e, 0,
                                               keepdims=False),
            in_dim=self.in_dim)

    def dequantize(self, dtype=jnp.bfloat16) -> Array:
        p = self.q_packed.astype(jnp.int32)
        lo = jnp.bitwise_and(p, 0xF) - 8
        hi = jnp.right_shift(p, 4) - 8
        codes = jnp.concatenate([lo, hi], axis=1).astype(jnp.float32)
        e, _, out = p.shape
        n_g = self.scale.shape[1]
        w = (codes.reshape(e, n_g, self.group_size, out)
             * self.scale[:, :, None, :])
        return w.reshape(e, self.in_dim, out).astype(dtype)


def quantize_expert_tensor_int4(w: Array,
                                group_size: int = 128) -> Int4ExpertTensor:
    """Group-wise symmetric int4 along each expert's reduction axis
    (same grouping/packing math as `quantize_tensor_int4`, vectorized
    over the expert axis)."""
    wf = w.astype(jnp.float32)
    e, in_dim, out = wf.shape
    if in_dim % 2:
        raise ValueError(f"int4 packing needs even in_dim, got {in_dim}")
    g = group_size if in_dim % (2 * group_size) == 0 else in_dim
    n_g = in_dim // g
    grouped = wf.reshape(e, n_g, g, out)
    absmax = jnp.max(jnp.abs(grouped), axis=2)
    scale = jnp.maximum(absmax, 1e-8) / 7.0
    q = jnp.clip(jnp.round(grouped / scale[:, :, None, :]), -7, 7)
    u = (q + 8).astype(jnp.uint8).reshape(e, in_dim, out)
    half = in_dim // 2
    lo, hi = u[:, :half], u[:, half:]
    packed = jnp.bitwise_or(jnp.left_shift(hi, 4), lo)
    return Int4ExpertTensor(q_packed=packed.astype(jnp.uint8), scale=scale,
                            in_dim=in_dim)


_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "wqkv", "w_gateup")  # fused names: llama.fuse_params
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _quantize_matmul_weight(v: Array, bits: int, act_quant: bool,
                            group_size: int):
    if bits == 4:
        return quantize_tensor_int4(v, group_size=group_size)
    return quantize_tensor(v, axis=1, act_quant=act_quant)


def quantize_params(params: Dict[str, Any], act_quant: bool = False,
                    bits: int = 8, group_size: int = 128) -> Dict[str, Any]:
    """Quantize all matmul weights (+ embed/lm_head) of a llama params tree.

    act_quant=True additionally routes these matmuls through the int8 x int8
    GEMM with on-the-fly activation quantization (int8 only).
    bits=4 stores layer matmul weights as nibble-packed group-wise
    `Int4Tensor`s; embed and lm_head stay int8 (quality-critical, few
    bytes).
    """
    if bits not in (4, 8):
        raise ValueError(f"weight bits must be 4 or 8, got {bits}")
    out: Dict[str, Any] = {}
    out["embed"] = quantize_tensor(params["embed"], axis=0)  # per-row
    out["final_norm"] = params["final_norm"]
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"], axis=1,
                                         act_quant=act_quant)
    out["layers"] = []
    for layer in params["layers"]:
        ql = {}
        for k, v in layer.items():
            if k == "moe":
                # Expert stacks: int8 per (expert, out-channel), or
                # grouped int4 at bits=4; the router gate stays full
                # precision (tiny, routing-critical).
                qe = (functools.partial(quantize_expert_tensor_int4,
                                        group_size=group_size)
                      if bits == 4 else quantize_expert_tensor)
                ql[k] = {mk: (qe(mv) if mk in _EXPERT_KEYS else mv)
                         for mk, mv in v.items()}
            else:
                ql[k] = (_quantize_matmul_weight(v, bits, act_quant,
                                                 group_size)
                         if k in _MATMUL_KEYS else v)
        out["layers"].append(ql)
    return out


def quantize_params_streaming(params: Dict[str, Any],
                              act_quant: bool = False, bits: int = 8,
                              group_size: int = 128) -> Dict[str, Any]:
    """Like `quantize_params`, but CONSUMES the input tree: each fp weight is
    freed as soon as its quantized replacement exists, so peak HBM is
    fp_total + one tensor instead of fp_total + quant_total. Use when the fp
    params barely fit (e.g. Llama-2-7B bf16 = 12.9 GB on a 16 GB chip)."""
    if bits not in (4, 8):
        raise ValueError(f"weight bits must be 4 or 8, got {bits}")
    out: Dict[str, Any] = {"layers": []}
    out["embed"] = quantize_tensor(params["embed"], axis=0)
    params["embed"] = None
    out["final_norm"] = params.pop("final_norm")
    if "lm_head" in params:
        out["lm_head"] = quantize_tensor(params["lm_head"], axis=1,
                                         act_quant=act_quant)
        params["lm_head"] = None
    layers = params["layers"]
    for i in range(len(layers)):
        layer = layers[i]
        ql = {}
        for k in list(layer.keys()):
            v = layer.pop(k)
            if k == "moe":
                qe = (functools.partial(quantize_expert_tensor_int4,
                                        group_size=group_size)
                      if bits == 4 else quantize_expert_tensor)
                ql[k] = {}
                for mk in list(v.keys()):
                    mv = v.pop(mk)
                    ql[k][mk] = qe(mv) if mk in _EXPERT_KEYS else mv
                    del mv
            else:
                ql[k] = (_quantize_matmul_weight(v, bits, act_quant,
                                                 group_size)
                         if k in _MATMUL_KEYS else v)
            del v
        layers[i] = None
        out["layers"].append(ql)
    return out


def params_are_quantized(params: Any) -> bool:
    """True when the pytree carries int8/int4 quantized weights."""
    found = False

    def visit(x):
        nonlocal found
        if isinstance(x, (QuantizedTensor, Int4Tensor,
                          QuantizedExpertTensor, Int4ExpertTensor)):
            found = True
        return x

    jax.tree_util.tree_map(
        visit, params,
        is_leaf=lambda x: isinstance(
            x, (QuantizedTensor, Int4Tensor, QuantizedExpertTensor,
                Int4ExpertTensor)))
    return found


def params_bytes(params: Any) -> int:
    return sum(x.size * x.dtype.itemsize
               for x in jax.tree_util.tree_leaves(params))


def params_num_weights(params: Any) -> int:
    """Logical weight count (independent of storage precision): int4
    packed bytes count 2 elements, int8 1 — for FLOP estimates."""
    total = 0

    def visit(x):
        nonlocal total
        if isinstance(x, (Int4Tensor, Int4ExpertTensor)):
            total += x.q_packed.size * 2 + x.scale.size
        elif isinstance(x, (QuantizedTensor, QuantizedExpertTensor)):
            total += x.q.size + x.scale.size
        else:
            total += x.size
        return x

    jax.tree_util.tree_map(
        visit, params,
        is_leaf=lambda x: isinstance(
            x, (QuantizedTensor, Int4Tensor, QuantizedExpertTensor,
                Int4ExpertTensor)))
    return total

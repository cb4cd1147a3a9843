"""Real-time KV-cache compression framework in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of the
reference PyTorch prototype `RealTime-KV-cache-Compression`:
prompt-guided token importance scoring, dynamic mixed-bit (2/4/8/16)
per-token KV quantization with real bit-packed storage, and budgeted
selective token propagation — fused into the prefill attention path and
sharded over device meshes with GSPMD.
"""

from .config import (CompressionConfig, ModelConfig, RopeScaling,
                     HIGH, MID, LOW,
                     LLAMA2_7B, LLAMA2_13B, LLAMA3_8B, MISTRAL_7B,
                     MIXTRAL_8X7B, TINYLLAMA_1_1B, reference_anchor_config,
                     tiny_test_model)

__version__ = "0.2.0"

__all__ = [
    "CompressionConfig", "ModelConfig", "RopeScaling",
    "HIGH", "MID", "LOW",
    "LLAMA2_7B", "LLAMA2_13B", "LLAMA3_8B", "MISTRAL_7B",
    "MIXTRAL_8X7B", "TINYLLAMA_1_1B", "reference_anchor_config",
    "tiny_test_model",
]

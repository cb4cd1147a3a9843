#!/usr/bin/env bash
# Environment setup (reference scripts/setup_environment.sh parity).
#
# The reference script creates a venv and pip-installs torch+cu124; here the
# runtime (jax with its CUDA plugin) is expected to be installed, so this
# script VERIFIES the toolchain instead of installing it, and prepares the same
# directory layout the experiment CLIs write into. It never touches the
# network (works in zero-egress environments).
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== python =="
python - <<'EOF'
import sys
print("python", sys.version.split()[0])

missing = []
for mod in ("jax", "jaxlib", "numpy", "optax", "orbax.checkpoint",
            "safetensors", "matplotlib"):
    try:
        __import__(mod)
    except ImportError:
        missing.append(mod)
if missing:
    sys.exit("missing required packages: " + ", ".join(missing)
             + "\nOn a GPU host: pip install 'jax[cuda12]' optax "
               "orbax-checkpoint safetensors matplotlib")

import jax
print("jax", jax.__version__, "backend:", jax.default_backend(),
      "devices:", jax.device_count())
EOF

echo "== package import =="
python -c "import realtime_kv_cache_compression_tpu as r; \
           print('realtime_kv_cache_compression_tpu', r.__version__)"

echo "== directories =="
mkdir -p data/longbench experiments/results logs
echo "created data/longbench experiments/results logs"

echo "== smoke test (CPU, tiny model) =="
python - <<'EOF'
import jax
jax.config.update("jax_platforms", "cpu")
import realtime_kv_cache_compression_tpu as rtc
from realtime_kv_cache_compression_tpu.models import llama

cfg = rtc.tiny_test_model(num_layers=2)
ccfg = rtc.CompressionConfig(num_layers=2)
params = llama.init_params(jax.random.PRNGKey(0), cfg)
ids = jax.random.randint(jax.random.PRNGKey(1), (1, 32), 0, cfg.vocab_size)
out, _ = llama.generate(params, ids, cfg, ccfg, max_new_tokens=4)
assert out.shape == (1, 4)
print("compressed generation OK:", out.tolist())
EOF

echo "setup complete"

"""True multi-process ("multi-host") SPMD execution of the compressed model.

The reference is single-process/single-GPU (SURVEY.md §2.6); the north star
demands multi-host serving. This module provides the process-level layer on
top of the GSPMD shardings in `parallel.sharding`:

  * `initialize(...)`         — per-host jax.distributed bring-up.
  * `global_put/global_params` — form global (cross-process) arrays from a
    full host-local copy: every process holds the same value and contributes
    only its addressable shards, so nothing is ever transferred host→host
    for weights/inputs (exactly how identical checkpoints are loaded on
    real pods).
  * `run_spmd_check(...)`      — one compressed prefill + scanned decode over
    a mesh that SPANS processes, verified token-identical against the
    single-device path, with the KV tier-pool sharding asserted.
  * `launch_local_sim(...)`    — spawn N local worker processes × M virtual
    CPU devices each and run `run_spmd_check` across them. On CPU the
    cross-process collectives ride Gloo; on a real cluster the identical
    code rides the interconnect — nothing here is simulation-specific
    except the platform flags.

Worker entry: `python -m realtime_kv_cache_compression_tpu.parallel.multihost
--process-id I --num-processes N --coordinator HOST:PORT [--data D --model M]`.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from functools import partial
from typing import Any, Dict, Optional

import numpy as np

from .mesh import DATA_AXIS, create_mesh

Params = Dict[str, Any]


def initialize(coordinator: str, num_processes: int, process_id: int) -> None:
    """jax.distributed bring-up (call once per process, before first use of
    the backend). On a real multi-host cluster this is the only per-host
    step."""
    import jax

    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def global_put(x, mesh, spec):
    """Build a global array on `mesh` from a full host-local value.

    Every process passes the same full `x`; each contributes only the
    shards it addresses (no host-to-host transfer). Works identically in
    single-process mode, so callers need not branch.
    """
    import jax
    from jax.sharding import NamedSharding

    from .sharding import _feasible_spec

    arr = np.asarray(x)
    sharding = NamedSharding(mesh, _feasible_spec(arr, spec, mesh))
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def global_params(params: Params, mesh, cfg) -> Params:
    """Tensor-parallel placement of a (host-replicated) params pytree onto a
    cross-process mesh — the multi-process analog of
    `sharding.shard_params` (which uses device_put and therefore requires a
    fully-addressable mesh)."""
    import jax
    from jax.sharding import PartitionSpec as P

    from .sharding import param_specs

    specs = param_specs(cfg)
    return jax.tree_util.tree_map(
        lambda x, s: global_put(x, mesh, s), params, specs,
        is_leaf=lambda x: isinstance(x, P))


def run_spmd_check(data: int, model: int, batch: int = 4, seq_len: int = 96,
                   new_tokens: int = 8, verbose: bool = True) -> bool:
    """Compressed prefill + scanned decode over the (data, model) mesh —
    which may span processes — compared token-for-token against the
    single-device path computed locally by every process.

    Returns True on an exact match (and raises on sharding-layout drift).
    SPMD contract: every participating process must call this with the same
    arguments.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P

    from .. import CompressionConfig, tiny_test_model
    from ..models import llama

    mesh = create_mesh(data, model)
    mcfg = tiny_test_model(num_layers=2, num_heads=8, num_kv_heads=4,
                           head_dim=16, hidden_size=128)
    ccfg = CompressionConfig(num_layers=2, high_precision_bits=8,
                             medium_precision_bits=4, low_precision_bits=2)
    params = llama.init_params(jax.random.PRNGKey(0), mcfg)
    ids = jax.random.randint(jax.random.PRNGKey(1), (batch, seq_len), 0,
                             mcfg.vocab_size)

    # Single-device reference, computed identically by every process (tiny
    # model; deterministic on CPU) — the bar the sharded run must match.
    n_steps = new_tokens - 1
    ref_logits, ref_state, _ = llama.prefill_compressed(
        params, ids, mcfg, ccfg, max_decode_len=new_tokens)
    ref_tok = jnp.argmax(ref_logits, axis=-1)
    ref_toks, _ = llama.decode_loop(params, ref_tok, ref_state, n_steps,
                                    mcfg, ccfg)
    ref = np.asarray(jnp.concatenate([ref_tok[:, None], ref_toks], axis=1))

    # Global placement: weights tensor-parallel, batch data-parallel.
    gp = global_params(params, mesh, mcfg)
    gids = global_put(ids, mesh, P(DATA_AXIS))

    prefill = jax.jit(lambda p, i: llama.prefill_compressed(
        p, i, mcfg, ccfg, max_decode_len=new_tokens, mesh=mesh))
    loop = jax.jit(partial(llama.decode_loop, n_steps=n_steps, cfg=mcfg,
                           ccfg=ccfg))
    logits, state, _stats = prefill(gp, gids)

    # The KV tier pools must have committed to the enforced mesh layout.
    committed = state.caches[0].tiers[0].k_stored.sharding.spec
    want = P(DATA_AXIS, None, "model")  # trailing Nones normalized away
    if tuple(committed) != tuple(want):
        raise AssertionError(
            f"tier cache sharding drifted: {committed} != {want}")

    tok = jnp.argmax(logits, axis=-1)
    toks, _ = loop(gp, tok, state)
    full = multihost_utils.process_allgather(
        jnp.concatenate([tok[:, None], toks], axis=1), tiled=True)

    ok = bool(np.array_equal(np.asarray(full), ref))
    if verbose:
        pid = jax.process_index()
        print(f"[p{pid}] mesh {data}x{model} over "
              f"{jax.process_count()} process(es): token match = {ok}; "
              f"tier cache sharding {committed}", flush=True)
    return ok


def run_serving_check(data: int, model: int, verbose: bool = True) -> bool:
    """Continuous-batching serving over a process-spanning mesh, verified
    token-identical against the single-process (no-mesh) engine.

    Multi-host serving contract (serving.engine): every process runs the
    same engine with identical submissions; decode/prefill are single SPMD
    programs over the joint mesh; host readbacks become collective
    all-gathers; admission completes in lockstep. This is the executable
    form of the north-star "multi-host continuous batching" — on a real pod
    only the platform flags change.
    """
    import jax

    from .. import CompressionConfig, tiny_test_model
    from ..models import llama
    from ..serving.engine import ServingEngine

    mcfg = tiny_test_model(num_layers=2, num_heads=8, num_kv_heads=4,
                           head_dim=16, hidden_size=128)
    ccfg = CompressionConfig(num_layers=2, high_precision_bits=8,
                             medium_precision_bits=4, low_precision_bits=2)
    params = llama.init_params(jax.random.PRNGKey(0), mcfg)
    rng = np.random.RandomState(7)
    prompts = [rng.randint(0, mcfg.vocab_size, size=n).tolist()
               for n in (48, 64, 96, 56, 80, 72)]
    kw = dict(num_slots=4, context_len=96, max_new_tokens=8, decode_chunk=4)

    # Single-process reference, computed identically by every process.
    ref = ServingEngine(params, mcfg, ccfg, **kw)
    for p in prompts:
        ref.submit(p)
    ref_tokens = {r.rid: r.tokens for r in ref.run().values()}

    mesh = create_mesh(data, model)
    eng = ServingEngine(params, mcfg, ccfg, mesh=mesh, **kw)
    for p in prompts:
        eng.submit(p)
    got_tokens = {r.rid: r.tokens for r in eng.run().values()}

    ok = got_tokens == ref_tokens
    if verbose:
        print(f"[p{jax.process_index()}] serving over mesh {data}x{model}, "
              f"{jax.process_count()} process(es): "
              f"{len(got_tokens)} requests, token match = {ok}", flush=True)
    return ok


def _worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=4)
    ap.add_argument("--arm", default="spmd", choices=["spmd", "serving",
                                                      "both"])
    ap.add_argument("--platform", default=None,
                    help="force a jax platform (the local simulator passes "
                         "'cpu'); omit on a real cluster to use the default "
                         "backend")
    args = ap.parse_args(argv)

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    initialize(args.coordinator, args.num_processes, args.process_id)
    ok = True
    if args.arm in ("spmd", "both"):
        ok &= run_spmd_check(args.data, args.model)
    if args.arm in ("serving", "both"):
        ok &= run_serving_check(args.data, args.model)
    if ok and jax.process_index() == 0:
        print("MULTIHOST_SIM_OK", flush=True)
    return 0 if ok else 1


def launch_local_sim(num_processes: int = 2, local_devices: int = 4,
                     data: int = 2, model: Optional[int] = None,
                     arm: str = "spmd", timeout: float = 600.0) -> str:
    """Spawn `num_processes` local worker processes (each with
    `local_devices` virtual CPU devices) and run `run_spmd_check` over the
    joint mesh. Returns process 0's combined output; raises on failure.

    This is the zero-egress stand-in for an N-host pod launch: same worker
    code, same collectives, Gloo instead of DCN.
    """
    last_err: Optional[Exception] = None
    for _attempt in range(2):  # ephemeral-port TOCTOU race → one retry
        try:
            return _launch_once(num_processes, local_devices, data, model,
                                arm, timeout)
        except RuntimeError as e:
            last_err = e
    raise last_err  # type: ignore[misc]


def _launch_once(num_processes: int, local_devices: int, data: int,
                 model: Optional[int], arm: str, timeout: float) -> str:
    import socket
    import tempfile
    import time

    if model is None:
        model = num_processes * local_devices // data
    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    # NB: the port is released before worker 0 binds it — a concurrent
    # launcher could steal it in the gap, which surfaces as a worker
    # failure; launch_local_sim retries once with a fresh port.

    repo_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env = os.environ.copy()
    # Pin virtual CPU devices.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count="
                        f"{local_devices}")

    procs, files = [], []
    deadline = timeout + time.monotonic()
    try:
        for i in range(num_processes):
            # Temp files, not PIPEs: a worker that fills a 64 KB pipe mid-
            # collective would stall the whole pod while we drain peers.
            f = tempfile.TemporaryFile(mode="w+", encoding="utf-8")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "realtime_kv_cache_compression_tpu.parallel.multihost",
                 "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(num_processes),
                 "--process-id", str(i),
                 "--data", str(data), "--model", str(model), "--arm", arm,
                 "--platform", "cpu"],
                cwd=repo_root, env=env, stdout=f, stderr=f, text=True))
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(
                f"multihost worker {i} failed (rc={p.returncode}):\n{out}")
    if "MULTIHOST_SIM_OK" not in outs[0]:
        raise RuntimeError(f"process 0 did not report OK:\n{outs[0]}")
    return outs[0]


if __name__ == "__main__":
    sys.exit(_worker_main())

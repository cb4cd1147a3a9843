#!/usr/bin/env python
"""Continuous-batching serving benchmark: sustained throughput + TTFT under
concurrent requests (no reference counterpart — the reference served one
sequence at a time through HF generate; SURVEY.md §1 "no serving layer").
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--platform", default=None, choices=["cpu", "gpu"])
    ap.add_argument("--model", default="tinyllama",
                    choices=["tiny-test", "tinyllama"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--context", type=int, default=1024)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip the warm-up request (timed run then includes "
                         "prefill/decode compilation — tens of seconds)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL mesh, e.g. 2x4 (slots shard over data,"
                         " weights tensor-parallel; on CPU set "
                         "XLA_FLAGS=--xla_force_host_platform_device_count)")
    args = ap.parse_args()

    if args.platform:
        import os as _os
        if args.platform == "cpu" and args.mesh:
            need = 1
            for f in args.mesh.split("x"):
                need *= int(f)
            flags = _os.environ.get("XLA_FLAGS", "")
            if "host_platform_device_count" not in flags:
                _os.environ["XLA_FLAGS"] = (
                    flags + f" --xla_force_host_platform_device_count={need}"
                ).strip()
        import jax

        jax.config.update("jax_platforms", args.platform)
    import dataclasses

    import jax
    import numpy as np

    import realtime_kv_cache_compression_tpu as rtc
    from realtime_kv_cache_compression_tpu.models import llama
    from realtime_kv_cache_compression_tpu.serving import ServingEngine

    mcfg = (rtc.tiny_test_model() if args.model == "tiny-test"
            else rtc.TINYLLAMA_1_1B)
    if args.layers:
        mcfg = dataclasses.replace(mcfg, num_layers=args.layers)
    if mcfg.max_position_embeddings < args.context + args.new_tokens:
        mcfg = dataclasses.replace(
            mcfg, max_position_embeddings=args.context + args.new_tokens)
    ccfg = rtc.CompressionConfig(num_layers=mcfg.num_layers,
                                 high_precision_bits=8,
                                 medium_precision_bits=4,
                                 low_precision_bits=2)
    params = jax.device_put(llama.init_params(jax.random.PRNGKey(0), mcfg))

    mesh = None
    if args.mesh:
        from realtime_kv_cache_compression_tpu.parallel import create_mesh

        data, model = (int(x) for x in args.mesh.split("x"))
        mesh = create_mesh(data, model)
        print(f"mesh: data={data} model={model} "
              f"({jax.device_count()} devices)")
    eng = ServingEngine(params, mcfg, ccfg, num_slots=args.slots,
                        context_len=args.context,
                        max_new_tokens=args.new_tokens,
                        decode_chunk=args.decode_chunk,
                        use_flash=args.flash, mesh=mesh)
    rng = np.random.default_rng(0)
    if not args.no_warmup:
        # Compile outside the timed region: the decode chunk, slot insert,
        # and one batched prefill per power-of-two admission size (admission
        # pads to powers of two, so these are ALL the programs steady-state
        # serving ever runs). One-time compilation is not the metric.
        t0 = time.time()
        b = 1
        while True:
            for _ in range(min(b, args.slots)):
                eng.submit(rng.integers(1, mcfg.vocab_size,
                                        size=args.context).tolist(),
                           max_new_tokens=min(args.new_tokens,
                                              args.decode_chunk))
            eng.run()
            if b >= args.slots:
                break
            b *= 2
        eng.completed.clear()
        print(f"warmup (compilation): {time.time() - t0:.1f}s")
    t0 = time.time()
    for i in range(args.requests):
        n = int(rng.integers(args.context // 2, args.context))
        eng.submit(rng.integers(1, mcfg.vocab_size, size=n).tolist())
    done = eng.run()
    wall = time.time() - t0
    s = eng.summary()
    total_tokens = s["total_tokens"]
    print(f"requests={len(done)} wall={wall:.2f}s "
          f"throughput={total_tokens / wall:.1f} tok/s "
          f"avg_ttft={s['avg_ttft_s'] * 1e3:.1f}ms "
          f"avg_savings={s['avg_memory_savings']:.3f}")


if __name__ == "__main__":
    main()

"""Serving launcher: continuous-batching generation on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b --paged --batch 4
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch llama3_8b --reduced --paged

The reference's flags and output lines, minus ``--devices`` and ``--mesh``
(a device mesh is ROADMAP A7; ``--shards`` above 1 errors for the same
reason).  Runs on the card unless ``--device cpu`` is given.  The weights
are drawn on the device from ``torch.Generator(device).manual_seed(0)``.
"""
import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--batch", type=int, default=4, help="request count")
    ap.add_argument("--slots", type=int, default=4, help="concurrent batch slots")
    ap.add_argument("--bucket", type=int, default=8, help="prompt-length shape bucket")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--ragged", action="store_true",
                    help="vary prompt/new-token lengths across requests")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help=">0 enables per-slot sampled decoding")
    ap.add_argument("--seed", type=int, default=0,
                    help="base sampling seed (request i uses seed+i)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache with shared-prefix reuse")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (paged mode)")
    ap.add_argument("--pool-pages", type=int, default=0,
                    help="page-pool size incl. the reserved scrap page "
                         "(0: slots * pages-per-slot + 1)")
    ap.add_argument("--shards", type=int, default=1,
                    help="per-shard page pools: not ported yet (ROADMAP A7), only 1")
    args = ap.parse_args(argv)
    if args.shards != 1:
        ap.error("--shards > 1 (mesh-sharded page pools) is not ported to repro_torch yet "
                 "(ROADMAP A7)")

    import numpy as np
    import torch

    from repro_torch import device as _device
    from repro_torch.configs.base import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, GenRequest

    dev = _device.resolve(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.batch):
        s0 = args.prompt_len
        nt = args.new_tokens
        if args.ragged:
            s0 = int(rng.integers(max(args.prompt_len // 4, 1), args.prompt_len + 1))
            nt = int(rng.integers(max(args.new_tokens // 4, 1), args.new_tokens + 1))
        reqs.append(GenRequest(
            tokens=rng.integers(0, cfg.vocab_size, (s0,)).astype(np.int32),
            max_new_tokens=nt, temperature=args.temperature, seed=args.seed + i,
        ))
    max_len = args.prompt_len + args.bucket + args.new_tokens + cfg.num_prefix_embeds + 8

    paged_kw = {}
    if args.paged:
        if args.page_size % args.bucket != 0 and args.bucket > 1:
            ap.error(
                f"--page-size {args.page_size} must be a multiple of "
                f"--bucket {args.bucket}: shared-prefix hits are only "
                "bitwise-exact within one padded length, so page and "
                "bucket boundaries must agree"
            )
        # worst-case pages one request can occupy, from the CLI's own
        # request-shaping knobs: the arithmetic the engine enforces per request
        pages_per_req = -(-max_len // args.page_size)
        if args.pool_pages:
            cap = (args.pool_pages - 1) // pages_per_req
            if cap < 1:
                ap.error(
                    f"--pool-pages {args.pool_pages} cannot hold even one "
                    f"request (worst case {pages_per_req} pages of "
                    f"{args.page_size}); need >= {pages_per_req + 1}"
                )
            if args.slots > cap:
                ap.error(
                    f"--slots {args.slots} exceeds the pool's worst-case "
                    f"concurrency {cap} ({args.pool_pages - 1} usable pages "
                    f"/ {pages_per_req} pages per request); lower --slots "
                    "or raise --pool-pages"
                )
        paged_kw = dict(paged=True, page_size=args.page_size, pool_pages=args.pool_pages or None)

    eng = Engine(params, cfg, max_len=max_len, slots=args.slots, bucket=args.bucket, **paged_kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.serve(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    st = eng.stats
    gen = st.generated_tokens
    print(f"served {len(reqs)} requests ({gen} new tokens) in {dt*1e3:.1f} ms "
          f"({len(reqs)/dt:.1f} req/s, {gen/dt:,.0f} tok/s)")
    print(f"dispatches: {st.prefill_dispatches} prefill + {st.decode_dispatches} decode "
          f"({st.tokens_per_dispatch:.2f} tok/dispatch)")
    print(f"padding waste: {100*st.padding_frac:.1f}% of prompt tokens "
          f"(bucket={args.bucket})")
    if args.paged:
        print(f"page pool: peak {st.pool_peak_pages}/{eng.pool.capacity} pages "
              f"of {eng.page_size} ({st.peak_active} slots at peak); "
              f"page waste {100*st.page_frac:.1f}%")
        print(f"prefix reuse: {st.prefix_hits} warm admissions, "
              f"{st.prefix_hit_tokens} prompt tokens skipped")
    print(f"sample: {outs[0][len(reqs[0].tokens):].tolist()}")


if __name__ == "__main__":
    main()

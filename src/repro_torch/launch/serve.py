"""Serving launcher: batched decoding with the slot engine, optionally with
a CSR-dtANS-compressed (pruned + entropy-coded) LM head served by the
CUDA kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --sparse-head                      # full width, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --smoke --sparse-head --device cpu # reduced config, plain torch
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels.pack import check_device
from repro_torch.models import api
from repro_torch.serving.engine import Engine


def main(argv=None) -> list:
    """Serve ``--requests`` random prompts; returns the requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--sparse-head", action="store_true",
                    help="prune + CSR-dtANS-encode the LM head and report "
                         "its compression (paper technique)")
    ap.add_argument("--sparsity", type=float, default=0.8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    args = ap.parse_args(argv)

    dev = check_device(args.device)
    cfg = (configs.get_smoke(args.arch) if args.smoke
           else configs.get(args.arch))
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)

    sparse_head = None
    if args.sparse_head:
        sparse_head = Engine.compress_lm_head(model, sparsity=args.sparsity)
        print(f"LM head: {sparse_head.dense_bytes:,} B dense -> "
              f"{sparse_head.compressed_bytes:,} B CSR-dtANS "
              f"({sparse_head.compression_vs_dense:.2f}x vs dense, "
              f"{sparse_head.compression_vs_best_sparse:.2f}x vs best "
              f"sparse format)")

    eng = Engine(model, slots=args.slots, max_seq=args.max_seq,
                 sparse_head=sparse_head, device=dev)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, size=args.prompt_len),
                       args.max_new_tokens) for _ in range(args.requests)]
    t0 = time.perf_counter()
    eng.run_until_drained()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "CPU, plain torch"
    print(f"served {sum(r.done for r in reqs)}/{len(reqs)} requests, "
          f"{toks} tokens in {dt:.1f}s ({toks/max(dt,1e-9):.1f} tok/s, "
          f"{where})")
    return reqs


if __name__ == "__main__":
    main()

"""Serve a pruned LM with an entropy-coded (CSR-dtANS) LM head on the
PyTorch/CUDA port (`src/repro_torch`): the steps of
`examples/sparse_inference.py`, on the card by default.

  1. train-free setup: a SmolLM-family model with random weights;
  2. magnitude-prune + 8-bit-codebook the LM head (vocab x d, the largest
     matrix of a small LM, matvec-bound at decode);
  3. check that the compressed head's logits track its own decoded dense
     matrix, then serve a batch of requests through the engine with the
     compressed head, and report the compression.

    PYTHONPATH=src python examples/sparse_inference_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.kernels.pack import check_device
from repro_torch.models import api
from repro_torch.serving.engine import Engine
from repro_torch.serving.sparse_linear import SparseLinear


def main(device="cuda") -> list:
    """Runs the three steps on ``device``; returns the served requests."""
    dev = check_device(device)
    cfg = configs.get_smoke("smollm-135m").with_(vocab=512, d_model=128,
                                                 n_heads=8, n_kv_heads=4)
    model = api.build_model(cfg, generator=torch.Generator().manual_seed(0),
                            device=dev)

    # --- compress the LM head -------------------------------------------
    w = model.embed.head_weight().detach().float().cpu().numpy()  # (d, V)
    sl = SparseLinear.from_dense(w, sparsity=0.7, value_bits=6, device=dev)
    print(f"LM head: dense {sl.dense_bytes:,} B -> CSR-dtANS "
          f"{sl.compressed_bytes:,} B "
          f"({sl.compression_vs_dense:.2f}x vs dense, "
          f"{sl.compression_vs_best_sparse:.2f}x vs best sparse format)")

    # --- logits parity: sparse head vs its own dense reconstruction ------
    h = torch.randn((4, 1, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).to(dev)
    ls = sl.apply(h).cpu().numpy()
    ld = sl.apply_dense_reference(h).cpu().numpy()
    np.testing.assert_allclose(ls, ld, rtol=1e-4, atol=1e-4)
    agree = (ls.argmax(-1) == ld.argmax(-1)).mean()
    print(f"sparse-head decode == dense(pruned) reference: OK "
          f"(argmax agreement {agree:.0%})")

    # --- batched serving through the compressed head -----------------------
    eng = Engine(model, slots=4, max_seq=48, sparse_head=sl, device=dev)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, size=5), 8)
            for _ in range(6)]
    eng.run_until_drained()
    done = sum(r.done for r in reqs)
    toks = sum(len(r.out) for r in reqs)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "the CPU"
    print(f"served {done}/{len(reqs)} requests, {toks} tokens generated "
          f"on {where}")
    if done != len(reqs):
        raise RuntimeError(f"only {done} of {len(reqs)} requests finished")
    print("batched serving: OK")
    return reqs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain torch path)")
    main(ap.parse_args().device)

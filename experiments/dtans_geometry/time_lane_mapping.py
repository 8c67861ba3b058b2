#!/usr/bin/env python3
"""Times the two lane mappings of a wide dtANS slice on one GPU.

    python3 experiments/dtans_geometry/time_lane_mapping.py

On the SmolLM-135M head as ``chip_smoke.py`` phase 4 builds it (49152 x
576, lane width 128, 384 slices), it times the port's SpMV kernel (one
warp per 32 lanes, warps of a slice exchanging counts behind a named
barrier: ``src/repro_torch/kernels/csrc/dtans_spmv.cu``) against
``spmv_lanes_in_registers.cu`` beside this script (one warp per slice,
four lanes a thread in registers, ranks warp-local), after checking the
two bitwise equal. Runs alternate (port, registers, registers, port) and
print the card's name and power limit. The alternative is built here with
``nvcc`` into ``build/`` beside this script.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import dtans_spmv as K  # noqa: E402
from repro_torch.kernels.pack import to_device  # noqa: E402
from repro_torch.serving.sparse_linear import SparseLinear  # noqa: E402


def build() -> ctypes.CDLL:
    out = HERE / "build" / "libspmv_lanes.so"
    out.parent.mkdir(exist_ok=True)
    log = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(HERE / "spmv_lanes_in_registers.cu")],
                         capture_output=True, text=True)
    for line in (log.stdout + log.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")
    if log.returncode != 0:
        raise RuntimeError("nvcc failed")
    lib = ctypes.CDLL(str(out))
    lib.spmv_lanes_launch.argtypes = K.MATRIX_ARGS + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.spmv_lanes_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    lib = build()
    rng = np.random.default_rng(C.SEED)
    w = (rng.standard_normal((C.D_MODEL, C.VOCAB)) * 0.02).astype(np.float32)
    sl = SparseLinear.from_dense(w, sparsity=0.8, value_bits=8,
                                 lane_width=128, shared_table=True,
                                 device="cuda")
    dm = to_device(sl.packed, "cuda")
    x = torch.randn(C.D_MODEL, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def lanes(threads):
        y = torch.empty((dm.n_slices, dm.lane_width), device="cuda")
        blocks = -(-dm.n_slices // (threads // 32))
        rc = lib.spmv_lanes_launch(*K.kernel_args(dm), blocks, threads,
                                   x.data_ptr(), x.shape[0], y.data_ptr(),
                                   stream)
        if rc:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return y

    want = K.dtans_spmv(dm, x)
    res = {"card": smi, "geometry": vars(K.spmv_geometry(dm))}
    for threads in (32, 64, 128):
        assert torch.equal(lanes(threads), want), threads
    port, regs = [], {t: [] for t in (32, 64, 128)}
    for _ in range(2):
        port.append(C.time_ms(lambda: K.dtans_spmv(dm, x), 100))
        for t in regs:
            regs[t].append(C.time_ms(lambda: lanes(t), 100))
        for t in regs:
            regs[t].append(C.time_ms(lambda: lanes(t), 100))
        port.append(C.time_ms(lambda: K.dtans_spmv(dm, x), 100))
    res["warps_per_32_lanes_ms"] = port
    res["lanes_in_registers_ms"] = {f"{t} threads a block": v
                                    for t, v in regs.items()}
    print(json.dumps(res))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

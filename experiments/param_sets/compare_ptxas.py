"""Compares the dtANS kernels' ptxas lines (registers, stack frame, spill
stores and loads) of two checkouts, kernel by kernel, for one parameter
set (PAPER unless given).

    python3 experiments/param_sets/compare_ptxas.py --parent build/parent \
        [--json build/ptxas.json]

Builds ``dtans_spmv`` and ``dtans_decode`` of each checkout into that
checkout's own ``src/repro_torch/kernels/build/`` (each tree's `_build`,
in a subprocess: ``nvcc`` needed, no card), then prints each kernel's
numbers side by side, marked "same" or "DIFF", and "ALL SAME" when no
kernel differs. Unpack the tree to compare into an ignored directory
first: ``git archive <commit> | tar -x -C build/parent``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels._build import ptxas  # noqa: E402

STEMS = ("dtans_spmv", "dtans_decode")


def build_logs(root: Path, params: list | None) -> dict:
    """Builds a checkout's dtANS libraries for a set (PAPER where None);
    returns stem -> its ptxas log."""
    # PAPER through the calls every checkout has (the sets' through the
    # ones that take a set)
    build, log = (f"_build.build_all({STEMS!r})", "_build.log_path(s)")
    if params is not None:
        build = (f"_build.build_all({STEMS!r}, "
                 f"(DtansParams(*{tuple(params)}),))")
        log = f"_build.log_path(s, DtansParams(*{tuple(params)}))"
    code = "\n".join((
        f"import sys; sys.path.insert(0, {str(root / 'src')!r})",
        "from repro_torch.core.params import DtansParams",
        "from repro_torch.kernels import _build",
        build,
        f"print({{s: str({log}) for s in {STEMS!r}}})"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    paths = eval(out.strip().splitlines()[-1])
    return {s: Path(v).read_text() for s, v in paths.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="the other checkout's root")
    ap.add_argument("--params", type=int, nargs=6, default=None,
                    help="w_bits k_bits l o f m_bits (default PAPER)")
    ap.add_argument("--json", type=Path, default=None)
    args = ap.parse_args()
    res = {tag: {s: ptxas(log) for s, log in
                 build_logs(root.resolve(), args.params).items()}
           for tag, root in (("parent", args.parent), ("change", ROOT))}
    same = True
    for stem in STEMS:
        p, c = res["parent"][stem], res["change"][stem]
        print(f"{stem}: {len(p)} kernels in the parent, {len(c)} here "
              f"(registers, stack, spill stores, spill loads)")
        for k in sorted(set(p) | set(c)):
            flag = "same" if p.get(k) == c.get(k) else "DIFF"
            same &= flag == "same"
            print(f"  {flag} {k[:80]}: parent {p.get(k)}, here {c.get(k)}")
    print("ALL SAME" if same else "SOME DIFFER")
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())

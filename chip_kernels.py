#!/usr/bin/env python3
"""The flash and decode kernel phases of ``chip_smoke.py`` alone, on one
NVIDIA GPU.

    python3 chip_kernels.py [TREE] [--slice] [--ptxas]

Builds the port's kernels from the sources of TREE (a checkout that holds
``chip_smoke.py`` and ``src/repro_torch``; by default the directory of this
script) and runs that tree's own ``phase_flash`` and ``phase_decode``, gates
included: on every case of ``FLASH_CASES``, ``DECODE_CASES`` and
``PAGED_CASES`` (with ``--slice``, on the slices' cases only) and on the
head-dim cases (hd 112 and 96). ``--ptxas`` also prints the
tree's ``nvcc -Xptxas -v`` report. Each record's label names the tree, so
that one command can compare two trees on one card in turns, e.g. a parent
unpacked with ``git archive`` into ``_archive/parent``:

    for t in _archive/parent . . _archive/parent; do python3 chip_kernels.py $t --slice; done

Exits non-zero without CUDA or when a gate fails.
"""
from __future__ import annotations

import argparse
import importlib.util
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--slice", action="store_true", help="of the main cases, the slices' only")
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v of the kernels")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("[FAIL] torch.cuda.is_available() is false: this script needs a CUDA card")
        sys.exit(1)
    tree = Path(args.tree).resolve()
    if not (tree / "chip_smoke.py").is_file() or not (tree / "src" / "repro_torch").is_dir():
        print(f"[FAIL] {tree} holds no chip_smoke.py and src/repro_torch")
        sys.exit(1)
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("tree_chip_smoke", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import cg_fused

    procs = cs.start_ptxas() if args.ptxas else None
    cg_fused.extension()
    print(f"[build] {tree.name}: cg_fused in {cg_fused.build_seconds:.1f} s", flush=True)
    if procs:
        cs.print_ptxas(procs)
    print(f"[card] {cs.card_line()}", flush=True)

    def pick(cases):
        return tuple(c for c in cases if not args.slice or c[0] == "slice")

    tag = tree.name if tree != Path(__file__).resolve().parent else "this tree"
    cs.phase_flash(torch, cases=pick(cs.FLASH_CASES), label=f"flash {tag}")
    cs.phase_flash(torch, reps_cold=5, reps_warm=10, cases=cs.HEAD_FLASH_CASES,
                   label=f"heads {tag}")
    cs.phase_decode(torch, dense_cases=pick(cs.DECODE_CASES), paged_cases=pick(cs.PAGED_CASES),
                    label=f"decode {tag}")
    cs.phase_decode(torch, reps_cold=5, reps_warm=10, dense_cases=cs.HEAD_DECODE_CASES,
                    paged_cases=cs.HEAD_PAGED_CASES, label=f"heads {tag}")
    print(f"[done] {tag}: every gate held", flush=True)


if __name__ == "__main__":
    main()

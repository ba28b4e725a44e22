#!/usr/bin/env python3
"""Kernel phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 chip_kernels.py [TREE] [--slice] [--ptxas] [--ssd] [--gram] [--krylov]

Builds the port's kernels from the sources of TREE (a checkout that holds
``chip_smoke.py`` and ``src/repro_torch``; by default the directory of this
script) and runs that tree's own phases, gates included. By default these
are ``phase_flash`` and ``phase_decode``: on every case of ``FLASH_CASES``,
``DECODE_CASES`` and ``PAGED_CASES`` (with ``--slice``, on the slices' cases
only) and on the head-dim cases (hd 112 and 96). ``--ssd`` runs the tree's
``phase_ssd`` instead (with ``--slice``, on its slice case where the tree's
``phase_ssd`` takes a list of cases) and ``--gram`` its ``phase_gram`` (the
s-step Gram shapes); ``--krylov`` runs its ``phase_kernels`` (``dot2``,
``x_update`` and ``residual_dots``), then this script's
``phase_krylov_large`` on the tree's kernels (``dot2``, ``x_update`` and
``residual_dots`` with r0s read and with r0s = s, at 464,118,784
elements). These flags combine.
``--ptxas`` also prints the tree's ``nvcc -Xptxas -v`` report. Each
record's label names the tree, so that one command can compare two trees on
one card in turns, e.g. a parent unpacked with ``git archive`` into
``_archive/parent``:

    for t in _archive/parent . . _archive/parent; do python3 chip_kernels.py $t --slice; done
    for t in _archive/parent . . _archive/parent; do
        python3 chip_kernels.py $t --slice --ssd --gram; done
    for t in _archive/parent . . _archive/parent; do python3 chip_kernels.py $t --krylov; done

Exits non-zero without CUDA or when a gate fails.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import sys
from pathlib import Path


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--slice", action="store_true", help="of the main cases, the slices' only")
    ap.add_argument("--ptxas", action="store_true", help="print nvcc -Xptxas -v of the kernels")
    ap.add_argument("--ssd", action="store_true", help="run phase_ssd instead")
    ap.add_argument("--gram", action="store_true", help="run phase_gram instead")
    ap.add_argument("--krylov", action="store_true",
                    help="run phase_kernels and phase_krylov_large instead")
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
    cs = _load("tree_chip_smoke", tree / "chip_smoke.py")
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import cg_fused, ref

    procs = cs.start_ptxas() if args.ptxas else None
    cg_fused.extension()
    print(f"[build] {tree.name}: cg_fused in {cg_fused.build_seconds:.1f} s", flush=True)
    if procs:
        cs.print_ptxas(procs)
    print(f"[card] {cs.card_line()}", flush=True)

    def pick(cases):
        return tuple(c for c in cases if not args.slice or c[0] == "slice")

    tag = tree.name if tree != Path(__file__).resolve().parent else "this tree"
    if args.ssd or args.gram or args.krylov:
        if args.krylov:
            takes = inspect.signature(cs.phase_kernels).parameters
            kw = {"label": f"krylov {tag}"} if "label" in takes else {}
            print(f"[krylov] {tag}", flush=True)
            cs.phase_kernels(torch, cg_fused, ref, **kw)
            # This script's own phase, on the tree's kernels: one harness for
            # every tree, also a tree that has no such phase.
            own = _load("own_chip_smoke", Path(__file__).resolve().parent / "chip_smoke.py")
            own.phase_krylov_large(torch, cg_fused, ref, label=f"krylov {tag}")
        if args.gram:
            takes = inspect.signature(cs.phase_gram).parameters
            kw = {"label": f"gram {tag}"} if "label" in takes else {}
            print(f"[gram] {tag}", flush=True)
            cs.phase_gram(torch, cg_fused, ref, **kw)
        if args.ssd:
            kw = {"cases": pick(cs.SSD_CASES), "label": f"ssd {tag}"} \
                if "cases" in inspect.signature(cs.phase_ssd).parameters else {}
            print(f"[ssd] {tag}", flush=True)
            cs.phase_ssd(torch, **kw)
        print(f"[done] {tag}: every gate held", flush=True)
        return
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

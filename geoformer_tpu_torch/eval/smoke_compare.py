"""One checkout's chip_smoke.py on one GPU, phase by phase: seconds and
device memory, or the main path's ms per pair alone.

    python3 geoformer_tpu_torch/eval/smoke_compare.py --mode full \\
        [--root DIR] [--label NAME]
    python3 geoformer_tpu_torch/eval/smoke_compare.py --mode main_path \\
        [--repeat 3] [--root DIR] [--label NAME]

--mode full runs DIR's chip_smoke.main() with each of its phase_*
functions wrapped. For each phase it prints the caching allocator's
reserved and allocated GiB and the card's free GiB at entry and exit, and
the peak allocated and reserved GiB within the phase. It prints the same
just before each subprocess the script starts and around each
torch.cuda.empty_cache() that chip_smoke.py calls itself, naming the
function and line. These records show what the process holds on the card
when a subprocess starts there.

--mode main_path runs phase 1 and then phase 3 (the inference main path:
B=2 requests of 480x640 in bf16 through BatchedMatcher, K1 and K2) REPEAT
times in one process, and prints each run's ms per pair.

DIR defaults to this checkout. With --root, DIR's package and script are
used, so two commits can be compared on one card in one call: unpack the
older one under a directory .gitignore lists (``git archive <rev>
geoformer_tpu_torch chip_smoke.py cpp data``), link its
checkpoints/tpu_r3_main to this checkout's, and run old, new, new, old,
each in its own process. Run it as a file, as above, so that the package
is imported from DIR. Every record is one JSON line starting with
``[smoke_compare]``. Needs a CUDA device, as chip_smoke.py does.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

GIB = 2 ** 30


def _memory() -> dict:
    free, _ = torch.cuda.mem_get_info()
    return dict(reserved_gib=round(torch.cuda.memory_reserved() / GIB, 3),
                allocated_gib=round(torch.cuda.memory_allocated() / GIB, 3),
                card_free_gib=round(free / GIB, 3))


def _emit(label: str, **kw) -> None:
    print("[smoke_compare] " + json.dumps({"label": label, **kw}),
          flush=True)


def _wrap_phase(label, name, fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        before = _memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            torch.cuda.synchronize()
            _emit(label, phase=name,
                  seconds=round(time.perf_counter() - t0, 1),
                  entry=before, exit=_memory(),
                  peak_allocated_gib=round(
                      torch.cuda.max_memory_allocated() / GIB, 3),
                  peak_reserved_gib=round(
                      torch.cuda.max_memory_reserved() / GIB, 3))
    return run


def _caller(script: str):
    """(function, line) of the nearest frame in ``script``, else None."""
    f = sys._getframe(2)
    while f is not None and f.f_code.co_filename != script:
        f = f.f_back
    return None if f is None else (f.f_code.co_name, f.f_lineno)


def _instrument(label: str, cs) -> None:
    """Wrap cs's phases, subprocess.run and torch.cuda.empty_cache."""
    for name in [n for n in vars(cs) if n.startswith("phase_")]:
        setattr(cs, name, _wrap_phase(label, name, getattr(cs, name)))
    script = cs.__file__
    run, empty = subprocess.run, torch.cuda.empty_cache

    def logged_run(cmd, *args, **kwargs):
        where = _caller(script)
        if where is not None and torch.cuda.is_initialized():
            _emit(label, event="subprocess", at=list(where),
                  cmd=" ".join(map(str, cmd))[:120], **_memory())
        return run(cmd, *args, **kwargs)

    def logged_empty():
        where = _caller(script)
        before = _memory() if where is not None else None
        empty()
        if where is not None:
            _emit(label, event="empty_cache", at=list(where), before=before,
                  after=_memory())

    subprocess.run = logged_run
    torch.cuda.empty_cache = logged_empty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose chip_smoke.py and package run "
                         "(default: this one)")
    ap.add_argument("--label", default="new")
    ap.add_argument("--mode", choices=("full", "main_path"), required=True)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    root = Path(args.root or Path(__file__).resolve().parents[2]).resolve()
    if not torch.cuda.is_available():
        raise SystemExit("smoke_compare needs a CUDA device")
    os.chdir(root)
    # DIR, not this file's directory, is where imports resolve
    sys.path[0:1] = [str(root)]
    cs = importlib.import_module("chip_smoke")
    pkg = importlib.import_module("geoformer_tpu_torch")
    for mod in (cs, pkg):
        if root not in Path(mod.__file__).resolve().parents:
            raise SystemExit(f"{mod.__name__} came from {mod.__file__}, "
                             f"not from {root}: run this as a file")
    if args.mode == "full":
        _instrument(args.label, cs)
        return cs.main()
    card = cs.phase_device()
    device = torch.device("cuda", 0)
    for i in range(args.repeat):
        _, ms_per_pair, _ = cs.phase_main_path(device)
        _emit(args.label, mode="main_path", run=i, card=card,
              ms_per_pair=round(ms_per_pair, 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())

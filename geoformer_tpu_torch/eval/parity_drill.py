"""Readiness drill for ``cli parity`` with a torch checkpoint, on the port.

Counterpart of scripts/parity_drill.py: it writes a reference-named
Lightning-style checkpoint (``{"state_dict": ..., "epoch": 0}``, keys
``matcher.``-prefixed) from a JAX ``.npz`` through the port's own
utils/torch_convert.to_torch_state_dict, then runs the one-command parity
gate, ``cli parity --ckpt <that>``, on a corpus in the HPatches layout
(eval/hpatches_synth.py's when none is there). With the released
``geoformer.ckpt`` and ``hpatches-sequences-release`` the real run is

    python -m geoformer_tpu_torch.cli parity --ckpt geoformer.ckpt \\
        --hpatches hpatches-sequences-release --pallas --bf16

(gated against the reference README's AUC block within --gate-pt 1.0).
The rehearsal:

    python -m geoformer_tpu_torch.eval.parity_drill --corpus DIR \\
        --expect <auc1,auc3,auc5,auc10> [--max-seqs 8] [--bf16 --pallas]

Without ``--corpus`` the corpus is built into a temporary directory and
removed after the run, as is the checkpoint without ``--ckpt-out``. The
exit code is the gate's.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from geoformer_tpu_torch import weights
from geoformer_tpu_torch.config import GeoFormerConfig
from geoformer_tpu_torch.models import GeoFormer
from geoformer_tpu_torch.utils.torch_convert import to_torch_state_dict


def fabricate_checkpoint(npz: str, out: str) -> int:
    """Write the torch checkpoint of a JAX ``.npz`` the way Lightning saved
    the released one; returns its number of tensors."""
    model = weights.load_jax_params(GeoFormer(GeoFormerConfig()),
                                    weights.load_npz(npz))
    sd = {k: torch.from_numpy(v.copy())
          for k, v in to_torch_state_dict(model).items()}
    torch.save({"state_dict": sd, "epoch": 0}, out)
    return len(sd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="geoformer_tpu_torch.eval.parity_drill",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--npz", default="checkpoints/tpu_r3_main/params_final.npz")
    ap.add_argument("--corpus", default=None,
                    help="corpus in the HPatches layout (default: the "
                         "synthetic one, built into a temporary directory)")
    ap.add_argument("--ckpt-out", default=None,
                    help="where to write the checkpoint (default: a "
                         "temporary file)")
    ap.add_argument("--expect", default=None,
                    help="AUC gate for the rehearsal (default: the README "
                         "block, which a synthetic corpus is not expected "
                         "to meet unless given its own measured numbers)")
    ap.add_argument("--max-seqs", type=int, default=None)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from geoformer_tpu_torch import cli
    from geoformer_tpu_torch.eval.hpatches_protocol import build_corpus

    made = []
    try:
        if args.ckpt_out is None:
            made.append(tempfile.mkdtemp(prefix="parity_drill_"))
            args.ckpt_out = os.path.join(made[-1], "drill_geoformer.ckpt")
        n = fabricate_checkpoint(args.npz, args.ckpt_out)
        print(f"fabricated torch checkpoint: {args.ckpt_out} ({n} tensors)",
              flush=True)
        if args.corpus is None:
            made.append(tempfile.mkdtemp(prefix="hpatches_synth_"))
            args.corpus = made[-1]
            build_corpus(args.corpus)
        elif not os.path.isdir(args.corpus):
            build_corpus(args.corpus)
        argv = ["parity", "--ckpt", args.ckpt_out, "--hpatches", args.corpus,
                "--device", args.device]
        if args.expect:
            argv += ["--expect", args.expect]
        if args.max_seqs:
            argv += ["--max-seqs", str(args.max_seqs)]
        argv += [f"--{f}" for f in ("bf16", "pallas") if getattr(args, f)]
        print("running: cli " + " ".join(argv), flush=True)
        try:
            cli.main(argv)
        except SystemExit as e:
            return int(e.code or 0)
        return 0
    finally:
        for d in made:
            shutil.rmtree(d, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())

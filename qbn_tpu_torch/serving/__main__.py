"""Serving-export CLI (port of qbn_tpu's `python -m qbn_tpu.serving`):
freeze an experiment's checkpoint into a serving artifact.

  python -m qbn_tpu_torch.serving --exp <exp-dir> --out <artifact-dir> \
      [--mode int] [--batch 256] [--samples 100] \
      [--use_plan --chunk 20] [--freeze_draws SEED] [--device cpu]

<exp-dir> is a run directory that `models.factory.load_trained` reads
(config.json + weights.msgpack; for INT artifacts, the QAT run's
checkpoint with its converted 'qconst' codes). The default mode follows
the experiment's own q flag. The export runs on the card unless
`--device cpu`; a CPU artifact can be moved to the card when loaded
(`load_predictor(path, device="cuda")`).
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser("python -m qbn_tpu_torch.serving")
    p.add_argument("--exp", required=True,
                   help="experiment dir (config.json + weights.msgpack)")
    p.add_argument("--out", required=True, help="artifact output dir")
    p.add_argument("--mode", default=None,
                   choices=[None, "float", "qat", "int"],
                   help="forward family; default: 'int' when the "
                        "experiment config is quantised, else 'float'")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--samples", type=int, default=None,
                   help="MC samples of the program (default: the "
                        "experiment's --samples)")
    p.add_argument("--use_plan", action="store_true",
                   help="INT only: enables --chunk and --freeze_draws "
                        "(the port always draws in one launch and runs "
                        "the merged layout)")
    p.add_argument("--chunk", type=int, default=None,
                   help="with --use_plan: consume the drawn codes in "
                        "chunks of this size (ignored without it, as in "
                        "qbn_tpu)")
    p.add_argument("--freeze_draws", type=int, default=None,
                   metavar="SEED",
                   help="draw the posterior weight samples ONCE at export "
                        "(this seed) and hold the int8 codes in the "
                        "artifact: no per-call draw (fixed-ensemble "
                        "serving; implies --use_plan)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    from qbn_tpu_torch.models.factory import load_trained
    from qbn_tpu_torch.serving.export import export_predictor

    cfg, model, state = load_trained(args.exp, device=args.device)
    mode = args.mode or ("int" if cfg.q else "float")
    blob = export_predictor(
        model, state, cfg, mode=mode, batch=args.batch,
        input_shape=tuple(cfg.input_size), path=args.out,
        samples=args.samples, ensemble=cfg.method == "sgld",
        use_plan=args.use_plan or args.freeze_draws is not None,
        chunk=args.chunk, freeze_draws=args.freeze_draws)
    with open(os.path.join(args.out, "manifest.json")) as fh:
        print(fh.read())
    print(f"wrote {blob} ({os.path.getsize(blob) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main(sys.argv[1:])

"""End-to-end training driver on the PyTorch port: the program of
``examples/train_lm.py`` on ``repro_torch`` — train an LM on the synthetic
Markov language with checkpointing and telemetry through the port's
training CLI (``repro_torch.launch.train``), then mine the run.

The model's weights come from the trainer's ``torch.Generator`` (seed 0)
and the batches from the seeded token pipeline, so the losses are the
port's own, not the reference's.  Defaults are CPU-sized (preset=small
trains a ~20M model for 200 steps); ``--preset full`` trains the real
config.  Training runs on ``--device`` (the card by default, with no
fallback to the host); other arguments go to the CLI as they are.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200
    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 2 --device cpu
"""

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default="small")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args()

    from repro_torch.device import resolve_device
    from repro_torch.launch import train as train_cli

    resolve_device(args.device)  # no card: fail before building anything
    train_cli.main([
        "--arch", args.arch, "--preset", args.preset,
        "--steps", str(args.steps), "--batch", "8", "--seq", "128",
        "--mine", "--device", args.device,
    ] + rest)


if __name__ == "__main__":
    main()

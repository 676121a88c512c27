"""End-to-end driver on the PyTorch port: train a ~100M-param LM on the
XML-filtered byte stream (pub-sub ingest → tokenize → train), with
checkpoint and restart.

The twin of ``examples/train_lm.py``: ``repro_torch.launch.train`` with
the JAX example's arguments (the qwen3 family reduced to d_model 512, 12
layers, a byte vocabulary, batch 8 of 128 tokens), plus ``--device`` (a
CUDA card by default; ``cpu`` trains there and runs the filter kernels'
plain PyTorch versions).  ``--d-model``, ``--layers``, ``--batch`` and
``--seq-len`` shrink it, for a quick run on the CPU.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] \\
          [--device cpu]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch import train as train_mod


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    args = ap.parse_args()
    sys.argv = [
        "train", "--arch", "qwen3-0.6b", "--reduced",
        "--d-model", str(args.d_model), "--layers", str(args.layers),
        "--steps", str(args.steps), "--batch", str(args.batch),
        "--seq-len", str(args.seq_len),
        "--data-filter", "--ckpt-dir", args.ckpt_dir,
        "--device", args.device,
    ]
    train_mod.main()


if __name__ == "__main__":
    main()

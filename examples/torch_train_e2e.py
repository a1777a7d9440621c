"""End-to-end driver on the PyTorch port: training steps through the SWIRL plan.

The counterpart of ``examples/train_e2e.py`` over ``repro_torch``: trains a
reduced llama-family model (the smoke config; the same driver trains the
full configs on the card) across 2 emulated pods with int8 error-feedback
gradient compression on the cross-pod sync, checkpointing every iteration
boundary, and prints the loss curve.  Each iteration is one SWIRL plan run
on the ``inprocess`` backend, as in the reference.

Run: ``PYTHONPATH=src python examples/torch_train_e2e.py [--steps 200]`` (on
``cuda``; ``--device cpu`` for the CPU)
"""

import argparse
import tempfile

import torch

from repro_torch.launch.train import train


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but torch.cuda.is_available() is False (pass --device cpu)")

    with tempfile.TemporaryDirectory() as ckpt_dir:
        out = train(
            "llama3.2-3b",  # smoke variant: same family, CPU-sized
            smoke=True,
            steps=args.steps,
            n_pods=args.pods,
            global_batch=8,
            seq_len=64,
            ckpt_dir=ckpt_dir,
            log_every=20,
            device=args.device,
        )
    losses = [float(h["loss"]) for h in out["history"]]
    drop = losses[0] - min(losses[len(losses) // 2 :])
    print(f"loss: {losses[0]:.4f} → {losses[-1]:.4f} (best-half Δ {drop:.4f})")
    assert drop > 0.05, "training did not make progress"
    print("OK")


if __name__ == "__main__":
    main()

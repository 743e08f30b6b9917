"""Training on the PyTorch/CUDA port: train the GPT-2 smoke model for a few
hundred steps on the synthetic corpus, with checkpoints and restart.

    PYTHONPATH=src python examples/train_small_torch.py [--steps 300]
        [--resume] [--device cpu] [--ckpt-dir DIR]

The counterpart of ``examples/train_small.py`` on ``repro_torch``:
AdamW with its cosine schedule, gradient accumulation, int8 gradient
compression with error feedback, remat, async atomic checkpoints, the
deterministic resumable data pipeline and the heartbeat monitor.  Runs on
``cuda`` unless ``--device`` names another device.  Checkpoints go to
``--ckpt-dir`` (default: ``nanozk_train_ck_torch`` in the temporary
directory); rerun with ``--resume`` for an elastic restart.
"""
import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.train import TrainCfg, train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "nanozk_train_ck_torch"))
    args = ap.parse_args()
    t0 = time.time()
    tc = TrainCfg(steps=args.steps, batch=8, seq=64, microbatches=2,
                  compress_grads=True, remat=True,
                  ckpt_dir=args.ckpt_dir, ckpt_every=100, log_every=20)
    out = train("gpt2_small", tc, smoke=True, resume=args.resume,
                device=args.device)
    losses = out["losses"]
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps in {time.time() - t0:.1f}s")
    assert losses[-1] < losses[0], "training must reduce loss"
    print(f"checkpoints in {args.ckpt_dir} (atomic commits; rerun with "
          "--resume for elastic restart)")


if __name__ == "__main__":
    main()

"""Training driver (mirrors ``repro.launch.train``).

Composes the substrates: gradient accumulation over microbatches, int8
gradient compression with error feedback, remat
(``torch.utils.checkpoint``), AdamW updating the parameters in place,
async checkpoints with atomic commits, the deterministic data pipeline,
heartbeat/straggler monitoring, and elastic restart (resume from the
latest checkpoint, the pipeline's state from its manifest).

    python -m repro_torch.launch.train --arch gpt2_small --steps 200 --smoke
    python -m repro_torch.launch.train --smoke --device cpu

Everything runs on ``cuda`` unless ``--device`` (or ``device=``) names
another device; without a card it raises.  Differences from the JAX
package (ROADMAP "Kept differences"): one device only (``mesh`` takes
a one-device ``launch.mesh.Mesh`` or None, ``multi_pod`` must be False),
the returned dict
has no ``mesh`` but the seconds of each step and of each batch's host
work, and the weights are the port's draws from a ``torch.Generator``
(weights cross from the JAX package by ``models.model.params_from_numpy``
or by a checkpoint).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict

import torch

from repro_torch._tree import leaves, tree_map
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import DataPipeline, SyntheticCorpus
from repro_torch.device import resolve_device
from repro_torch.models import model as MDL
from repro_torch.optim import adamw, compression
from repro_torch.runtime.fault import HeartbeatMonitor


@dataclasses.dataclass
class TrainCfg:
    steps: int = 200
    batch: int = 8
    seq: int = 128
    microbatches: int = 1
    compress_grads: bool = False
    remat: bool = True
    scan_layers: bool = False
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 100
    log_every: int = 10
    seed: int = 0


def make_train_step(cfg, sh, opt_cfg: adamw.AdamWCfg, train_cfg: TrainCfg):
    """Grad-accumulation step; optional int8 compression before update.
    ``step(params, opt_state, ef_state, tokens, labels)`` returns
    (params, opt_state, ef_state, metrics); the parameters and moments are
    updated in place."""

    def step(params, opt_state, ef_state, tokens, labels):
        nm = train_cfg.microbatches
        mb = tokens.shape[0] // nm
        gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        lsum = 0.0
        for i in range(nm):
            # a fresh autograd leaf per parameter, sharing its storage
            live = tree_map(lambda p: p.detach().requires_grad_(True), params)
            with torch.enable_grad():
                loss = MDL.loss_fn(cfg, sh, live, tokens[i * mb:(i + 1) * mb],
                                   labels[i * mb:(i + 1) * mb],
                                   remat=train_cfg.remat)
                # a parameter the loss does not reach (whisper's encoder
                # without enc_input) gets a zero gradient, as under jax.grad
                g = torch.autograd.grad(loss, leaves(live),
                                        materialize_grads=True)
            for a, b in zip(leaves(gsum), g):
                a.add_(b.to(torch.float32))
            lsum = lsum + loss.detach()
        grads = tree_map(lambda a: a.div_(nm), gsum)
        del gsum
        if train_cfg.compress_grads:
            codes, scales, ef_state = compression.compress_tree(grads,
                                                                ef_state)
            del grads       # the float32 sums go before their decompression
            grads = compression.decompress_tree(codes, scales)
            del codes
        params, opt_state, metrics = adamw.update(opt_cfg, opt_state,
                                                  params, grads)
        metrics["loss"] = lsum / nm
        return params, opt_state, ef_state, metrics

    return step


def train(arch: str, train_cfg: TrainCfg, smoke: bool = True,
          mesh=None, multi_pod: bool = False, resume: bool = True,
          device=None) -> Dict[str, Any]:
    dev = resolve_device(device)
    if multi_pod or (mesh is not None and mesh.size != 1):
        raise NotImplementedError(
            "repro_torch trains on one card: mesh takes only a one-device "
            "mesh (launch.mesh.make_debug_mesh(1, 1)), and multi_pod is "
            "not supported")
    bundle = get_arch(arch)
    cfg = bundle.smoke if smoke else bundle.cfg
    sh = cfg.shard_cfg(dp=("data",), tp_size=1, dp_size=1)

    gen = torch.Generator(device=dev).manual_seed(train_cfg.seed)
    opt_cfg = adamw.AdamWCfg(total_steps=train_cfg.steps)
    pipeline = DataPipeline(SyntheticCorpus(cfg.vocab, train_cfg.seed),
                            train_cfg.batch, train_cfg.seq)
    monitor = HeartbeatMonitor(["host0"])

    params = MDL.init(cfg, sh, gen, dev, train_cfg.scan_layers)
    opt_state = adamw.init(params)
    ef_state = compression.init_ef(params) \
        if train_cfg.compress_grads else compression.EFState(residual=0)
    start = 0
    if resume and ckpt.latest_step(train_cfg.ckpt_dir) is not None:
        (params, opt_state), manifest = ckpt.restore(
            (params, opt_state), train_cfg.ckpt_dir, device=dev)
        start = manifest["step"]
        if "pipeline" in manifest["extra"]:
            pipeline.restore(manifest["extra"]["pipeline"])
        print(f"[train] elastic resume from step {start}")

    step_fn = make_train_step(cfg, sh, opt_cfg, train_cfg)
    losses, step_seconds, data_seconds = [], [], []
    for step in range(start, train_cfg.steps):
        t0 = time.perf_counter()
        toks, labels = pipeline.next_batch()
        tokens = torch.from_numpy(toks).to(dev, torch.int64)
        labels = torch.from_numpy(labels).to(dev, torch.int64)
        t1 = time.perf_counter()
        params, opt_state, ef_state, metrics = step_fn(
            params, opt_state, ef_state, tokens, labels)
        losses.append(float(metrics["loss"]))     # waits for the device
        t2 = time.perf_counter()
        data_seconds.append(t1 - t0)
        step_seconds.append(t2 - t1)
        monitor.beat("host0", t2 - t0)
        if step % train_cfg.log_every == 0:
            print(f"[train] step {step} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(t2 - t0) * 1e3:.0f} ms)")
        if (step + 1) % train_cfg.ckpt_every == 0:
            ckpt.save_async((params, opt_state), train_cfg.ckpt_dir,
                            step + 1, extra={"pipeline": pipeline.state()})
    ckpt.wait_pending()
    return {"params": params, "losses": losses, "cfg": cfg, "sh": sh,
            "step_seconds": step_seconds,
            "data_seconds": data_seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2_small")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--device", default=None,
                    help="torch device to train on (default: cuda; 'cpu' "
                         "runs everything on the host)")
    args = ap.parse_args(argv)
    tc = TrainCfg(steps=args.steps, batch=args.batch, seq=args.seq,
                  microbatches=args.microbatches,
                  compress_grads=args.compress_grads,
                  ckpt_dir=args.ckpt_dir)
    out = train(args.arch, tc, smoke=args.smoke, device=args.device)
    print(f"final loss: {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()

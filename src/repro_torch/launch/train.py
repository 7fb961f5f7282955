#!/usr/bin/env python
"""Restartable, fault-tolerant training driver, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
        --steps 300 --ckpt-dir DIR --data-dir DIR [--fail-at-step 150] [--reduced] [--device cpu]

The port of ``repro.launch.train``, step for step:
  * data from OpenZL-compressed shards (paper §VIII "training data"),
    compressed and read back on the device,
  * straggler-tolerant prefetch (timeout -> skip),
  * OpenZL-compressed checkpoints every --save-interval (paper §VIII
    "PyTorch model checkpoints"), atomic + keep-K,
  * crash/restart: --fail-at-step N simulates a node failure (exit code 42);
    rerunning the same command auto-resumes from the latest checkpoint
    (params, optimizer, data-pipeline cursor),
  * trained checkpoint compressors: --ckpt-plan [DTYPE=]plan.ozp routes
    checkpoint leaves through a `python -m repro_torch train` plan instead of
    the shipped profiles (restore is untouched: frames are self-describing).

Runs on the card unless ``--device cpu`` is given; without a card it raises
``NoCardError`` before it writes a shard or a checkpoint file.  Initial
weights come from a ``torch.Generator`` seeded 0; batch starts from the
reference's ``np.random.default_rng(0)`` on the host, so both packages cut
the same batches from the same shards.  Checkpoints hold
``{"params", "opt"}`` under the reference's keys, so either package resumes
the other's.  As in the reference, a ``--steps`` that is a multiple of
``--save-interval`` saves that step twice, and the second save's
``os.replace`` onto the published directory raises ``OSError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .. import _device
from ..configs import get_arch
from ..data import CompressedShardStore, Prefetcher, Straggler
from ..data.synthetic import zipf_tokens
from ..distributed import optimizer as opt_lib
from ..distributed.checkpoint import CheckpointManager
from ..models import transformer
from ..models.layers import tree_leaves


def make_shards(store: CompressedShardStore, cfg, n_shards: int, batch: int, seq: int):
    if store.shard_ids():
        return
    for i in range(n_shards):
        toks = zipf_tokens((batch * (seq + 1)) * 4, cfg.vocab, seed=i)
        store.write_shard(i, {"tokens": torch.from_numpy(toks)})
    stats = store.stats()
    print(
        f"[data] wrote {n_shards} OpenZL-compressed shards:"
        f" {stats['raw_bytes']/1e6:.1f}MB -> {stats['compressed_bytes']/1e6:.1f}MB"
        f" (ratio {stats['ratio']:.2f}x)"
    )


def batches_from_shard(data, batch, seq, rng):
    """``batch`` windows of ``seq`` tokens and their next tokens, at starts
    drawn from the host ``rng``, cut on the shard's device."""
    toks = data["tokens"]
    n = toks.shape[0] - seq - 1
    starts = rng.integers(0, n, size=batch)
    idx = torch.from_numpy(starts[:, None] + np.arange(seq)[None, :]).to(toks.device)
    return {"tokens": toks[idx], "labels": toks[idx + 1]}


def train_step(params, opt_state, batch, cfg, optimizer):
    """One step: the loss's gradients by autograd, then the optimizer's
    update -> (params, opt_state, loss).  The gradients are dropped on
    return, before any save."""
    leaves = opt_lib.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss = transformer.loss_fn(leaves, batch, cfg)
    flat = tree_leaves(leaves)
    grad_of = {id(p): g for p, g in zip(flat, torch.autograd.grad(loss, flat))}
    grads = opt_lib.tree_map(lambda p: grad_of[id(p)], leaves)
    params, opt_state = optimizer.update(grads, opt_state, params)
    return params, opt_state, loss.detach()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true", help="smoke-size model")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--data-dir", default="/tmp/repro_data")
    ap.add_argument("--save-interval", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--fail-at-step", type=int, default=0, help="simulate a crash")
    ap.add_argument(
        "--ckpt-plan",
        action="append",
        default=[],
        metavar="[DTYPE=]PLAN.ozp",
        help="compress checkpoint leaves with a trained plan (repeatable;"
        " bare PATH applies to all dtypes)",
    )
    ap.add_argument("--straggler-timeout", type=float, default=30.0)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = _device.resolve_device(args.device)

    spec = get_arch(args.arch)
    if spec.family != "lm":
        ap.error("train.py drives LM archs")

    if args.ckpt_plan:
        from ..core.serialize import deserialize_plan
        from ..distributed.checkpoint import set_checkpoint_plan

        for item in args.ckpt_plan:
            dtype_name, _, path = item.rpartition("=")
            dtype_name = dtype_name or "*"
            plan, meta = deserialize_plan(Path(path).read_bytes())
            set_checkpoint_plan(dtype_name, plan)
            print(
                f"[ckpt] trained plan {meta.get('name') or plan.name or path}"
                f" deployed for dtype {dtype_name!r}"
            )
    cfg = spec.reduced_cfg if args.reduced else spec.model_cfg
    cfg = dataclasses.replace(cfg, remat=False) if args.reduced else cfg

    # ---------------------------------------------------------------- data
    store = CompressedShardStore(args.data_dir, device=device)
    make_shards(store, cfg, n_shards=4, batch=args.batch, seq=args.seq)
    rng = np.random.default_rng(0)

    # --------------------------------------------------------------- model
    optimizer = opt_lib.adamw(lr=args.lr)
    mgr = CheckpointManager(
        args.ckpt_dir,
        save_interval=args.save_interval,
        keep=args.keep,
        async_save=False,
        device=device,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = transformer.init_params(cfg, generator=gen)
    opt_state = optimizer.init(params)
    start_step = 0
    cursor = 0
    restored = mgr.restore_or_none({"params": params, "opt": opt_state})
    if restored is not None:
        start_step, tree, manifest = restored
        params, opt_state = tree["params"], tree["opt"]
        cursor = int(manifest["metadata"].get("data_cursor", 0))
        print(
            f"[resume] restored step {start_step} from {args.ckpt_dir}"
            f" (compressed ratio {manifest['ratio']:.2f}x), data cursor {cursor}"
        )
        del tree  # the steps replace its tensors: no second train state on the card
    del restored

    prefetch = Prefetcher(store.read_shard, store.shard_ids(), start_cursor=cursor)
    t0 = time.time()
    losses = []
    try:
        for step in range(start_step + 1, args.steps + 1):
            try:
                item = prefetch.next(timeout=args.straggler_timeout)
            except Straggler as e:
                print(f"[straggler] {e}; skipping a fetch")
                continue
            batch = batches_from_shard(item["data"], args.batch, args.seq, rng)
            params, opt_state, loss = train_step(params, opt_state, batch, cfg, optimizer)
            losses.append(float(loss))
            if step % args.log_every == 0:
                dt = time.time() - t0
                print(
                    f"step {step:5d} loss {np.mean(losses[-args.log_every:]):.4f}"
                    f" ({step - start_step} steps in {dt:.1f}s)",
                    flush=True,
                )
            if args.fail_at_step and step == args.fail_at_step:
                print(f"[failure-sim] crashing at step {step} (before save)")
                prefetch.stop()
                return 42
            if mgr.should_save(step):
                mgr.save(
                    step,
                    {"params": params, "opt": opt_state},
                    metadata={"data_cursor": prefetch.state()["cursor"]},
                )
                print(f"[ckpt] saved step {step}")
        mgr.save(
            args.steps,
            {"params": params, "opt": opt_state},
            metadata={"data_cursor": prefetch.state()["cursor"]},
        )
        print(
            f"[done] {args.steps} steps, final loss"
            f" {np.mean(losses[-10:]):.4f}, initial {losses[0]:.4f}"
        )
    finally:
        prefetch.stop()
        mgr.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Batched LM serving driver: prefill + KV-cache decode, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --batch 8 --prompt-len 32 --gen 32 [--ckpt-dir DIR] [--reduced] [--device cpu]

Loads the latest checkpoint from --ckpt-dir if present (OpenZL frames,
decoded on the device; the whole step is decoded, optimizer state included,
and the params kept), otherwise serves random-init weights.  Reports prefill
and decode throughput.  SWA archs (h2o-danube) serve with a ring-buffer
cache of window size — constant memory however long the generation runs.

Runs on the card unless ``--device cpu`` is given; without a card it raises
``NoCardError`` before it reads anything.  Checkpoint leaves decode through
the per-process long-lived codec session of
``repro_torch.distributed.checkpoint``.  Initial weights, prompts and
sampling come from ``torch.Generator``s seeded 0, 1 and 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from .. import _device
from ..configs import get_arch
from ..distributed.checkpoint import CheckpointManager, codec_session_stats
from ..models import transformer


def _generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = _device.resolve_device(args.device)

    spec = get_arch(args.arch)
    cfg = spec.reduced_cfg if args.reduced else spec.model_cfg
    cfg = dataclasses.replace(cfg, remat=False)

    params = transformer.init_params(cfg, generator=_generator(device, 0))
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, device=device)
        restored = mgr.restore_or_none({"params": params})
        if restored is not None:
            step, tree, _ = restored
            params = tree["params"]
            cs = codec_session_stats()
            print(f"[serve] loaded checkpoint step {step}")
            print(
                f"[serve] ozl session: {cs['dec_calls']} leaf frames,"
                f" {cs['dec_bytes_in']/1e6:.1f} MB compressed ->"
                f" {cs['dec_bytes_out']/1e6:.1f} MB (pool+tables reused"
                " across leaves)"
            )

    B, P, G = args.batch, args.prompt_len, args.gen
    max_len = P + G
    prompts = torch.randint(
        0, cfg.vocab, (B, P), generator=_generator(device, 1), device=device
    )

    with torch.inference_mode():
        # ---- prefill: write the prompt KV into the cache by replaying tokens
        # through decode_step (simple, cache-layout agnostic)
        cache = transformer.init_kv_cache(cfg, B, max_len, device=device)
        _sync(device)
        t0 = time.time()
        logits = None
        for t in range(P):
            logits, cache = transformer.decode_step(
                params, cache, prompts[:, t : t + 1], t, cfg
            )
        _sync(device)
        t_prefill = time.time() - t0

        # ---- decode
        sampler = _generator(device, 2)
        tok = torch.argmax(logits, -1)[:, None]
        generated = [tok]
        t0 = time.time()
        for t in range(P, P + G - 1):
            logits, cache = transformer.decode_step(params, cache, tok, t, cfg)
            if args.temperature > 0:
                probs = torch.softmax(logits.float() / args.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=sampler)
            else:
                tok = torch.argmax(logits, -1)[:, None]
            generated.append(tok)
        _sync(device)
        t_decode = time.time() - t0

    out = torch.cat(generated, dim=1)
    print(f"[serve] arch={args.arch} batch={B} prompt={P} gen={G}")
    print(
        f"  prefill: {B*P} tokens in {t_prefill:.2f}s"
        f" ({B*P/max(t_prefill,1e-9):.0f} tok/s, incl. warm-up)"
    )
    print(
        f"  decode:  {B*(G-1)} tokens in {t_decode:.2f}s"
        f" ({B*(G-1)/max(t_decode,1e-9):.0f} tok/s)"
    )
    print(f"  sample[0,:12] = {out[0, :12].tolist()}")
    cache_mb = sum(x.numel() * x.element_size() for x in cache.values()) / 1e6
    print(f"  kv-cache: {cache_mb:.1f} MB ({'ring/SWA' if cfg.sliding_window else 'linear'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

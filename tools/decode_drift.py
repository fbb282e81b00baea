#!/usr/bin/env python3
"""Decode against prefill for the recurrent and audio LM families on one
CUDA card, by depth and activation dtype.

    python3 tools/decode_drift.py [--seed 0] [--arch rwkv6-3b zamba2-2.7b]
                                  [--depths 2 8 16 32] [--dtypes bf16 f32]

Run from the root of a checkout.  For each arch at full width and each
depth (``n_layers``, and whisper's ``enc_layers`` with it; all of the
config's layers by default), with random parameters from ``--seed``: a
prompt of 4 x (4,096 - D) tokens (whisper-medium: behind seeded normal
frames) is prefilled, D more are decoded from its cache (the config's
chunk; 8 for whisper-medium), and the last decode's logits are compared
with a prefill of all 4,096 (``chip_smoke.prefill_and_decode``, the same
steps as the checks of legs 20 and 21).
It prints the largest |difference| and the largest |logit| per depth and
dtype (f32 with TF32 off), beside the reference's bound for bf16
activations, 0.15.  Nothing is held: this measures how far bf16 rounding
at the decode's and the prefill's GEMM shapes carries the two apart.
"""
from __future__ import annotations

import argparse
import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--arch", nargs="+", default=["rwkv6-3b", "zamba2-2.7b"])
    ap.add_argument("--depths", nargs="*", type=int, default=[],
                    help="n_layers to run (default: the config's own)")
    ap.add_argument("--dtypes", nargs="+", default=["bf16", "f32"], choices=["bf16", "f32"])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("decode_drift: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import model as t_model

    print(cs.card_line(), flush=True)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    matmul = torch.backends.cuda.matmul
    before = (t_model.ACT_DTYPE, matmul.allow_tf32)
    try:
        matmul.allow_tf32 = False
        for arch in args.arch:
            published = get_config(arch)
            for depth in args.depths or [published.n_layers]:
                audio = published.family == "audio"
                cfg = published.scaled(n_layers=depth, **({"enc_layers": depth} if audio else {}))
                gen = torch.Generator("cuda").manual_seed(args.seed)
                model = t_model.get_model(cfg, "cuda").init(gen)
                D = cs.DECODE_STEPS if audio else cfg.ssm.chunk
                batch = cs.serve_batch(torch, cfg, gen, args.seed)
                for name in args.dtypes:
                    t_model.ACT_DTYPE = dtypes[name]
                    _, _, logits = cs.prefill_and_decode(torch, model, batch, cs.TRAIN_SEQ - D, D)
                    full, _ = model.prefill(batch)
                    err = float((logits - full).abs().max())
                    print(f"decode_drift: {arch} n_layers {depth}, {name} activations: the last "
                          f"of {D} decoded logits vs a prefill of all {cs.TRAIN_SEQ}: largest "
                          f"|difference| {err:.4g}, largest |logit| "
                          f"{float(full.abs().max()):.4g} (bf16 bound 0.15)", flush=True)
                    del logits, full
                del model
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        t_model.ACT_DTYPE, matmul.allow_tf32 = before
    return 0


if __name__ == "__main__":
    sys.exit(main())

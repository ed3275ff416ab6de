"""The packed kernel against its two plain versions, over seeds, on one card.

``chip_smoke.py`` holds the packed kernel at the configurations' lengths
(L = 1024 and 2048) to the bf16 plain version, and at the 3072 tokens of
32-frame clips to the plain version in float32 on the same inputs. This
prints, for ``--seeds`` seeds, the three measures of ``relative_errors``
against both plain versions at [2, 2048, 384] and [2, 3072, 384] (bf16,
eight heads of 16), beside the limits, so that the bf16 plain version's own
rounding can be told from a drift of the kernel: one JSON line per seed and
shape.

    python3 tools/packed_oracles.py [--seeds 4]    # repository root, a card
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    import torch

    from moditalker_tpu_torch.ops.kernels import (
        BF16_LIMITS, QUANTILE_LIMITS, relative_errors)
    from moditalker_tpu_torch.ops.kernels import packed_attention as pk

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    heads, c = 8, 128
    sc = (c // heads) ** -0.5
    for seed in range(args.seeds):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for length in (2048, 3072):
            qkv = torch.randn((2, length, 3 * c), generator=gen,
                              device="cuda").bfloat16()
            got = pk.packed_attention(qkv, heads, sc)
            bf16 = pk.packed_attention_reference(qkv, heads, sc)
            f32 = pk.packed_attention_reference(qkv.float(), heads, sc)
            print(json.dumps({
                "seed": seed, "shape": list(qkv.shape),
                "vs_bf16_plain": [float(f"{e:.4g}")
                                  for e in relative_errors(got, bf16)],
                "vs_float32_plain": [float(f"{e:.4g}")
                                     for e in relative_errors(got, f32)],
                "bf16_plain_vs_float32_plain": [
                    float(f"{e:.4g}") for e in relative_errors(bf16, f32)],
                "limits": [*BF16_LIMITS["packed_attention"],
                           QUANTILE_LIMITS["packed_attention"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

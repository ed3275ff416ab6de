"""Differentiable GAN augmentation: colour, translation, cutout (port of
``moditalker_tpu/models/mtov/diffaugment.py``; ref MToV/losses/diffaugment.py).

The reference imports it into the perceptual loss but never invokes it on
the active path (perceptual.py:10); it is here for opt-in use. Each
augmentation takes its random draws as tensors, in the form the JAX
package draws them (uniform [B, 1, 1, 1] in [0, 1); integer offsets [B]);
``draw_augment`` makes them from a ``torch.Generator``. Frames are
[B, H, W, C].
"""

from __future__ import annotations

import torch


def rand_brightness(x, u):
    return x + (u - 0.5)


def rand_saturation(x, u):
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * (u * 2) + mean


def rand_contrast(x, u):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * (u + 0.5) + mean


def _translation_extent(h: int, w: int, ratio: float = 0.125):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def rand_translation(x, tx, ty, ratio: float = 0.125):
    """Shift each frame by (tx, ty) pixels, zero-filled; tx in [-sh, sh]."""
    b, h, w, _ = x.shape
    sh, sw = _translation_extent(h, w, ratio)
    pad = torch.nn.functional.pad(x, (0, 0, sw, sw, sh, sh))
    rows = torch.arange(h, device=x.device)[None] + (sh + tx)[:, None]
    cols = torch.arange(w, device=x.device)[None] + (sw + ty)[:, None]
    bidx = torch.arange(b, device=x.device)[:, None, None]
    return pad[bidx, rows[:, :, None], cols[:, None, :]]


def _cutout_extent(h: int, w: int, ratio: float = 0.5):
    return int(h * ratio + 0.5), int(w * ratio + 0.5)


def rand_cutout(x, ox, oy, ratio: float = 0.5):
    """Zero a ch × cw box centred at (ox, oy) in each frame."""
    b, h, w, _ = x.shape
    ch, cw = _cutout_extent(h, w, ratio)
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    y0 = (ox - ch // 2)[:, None, None]
    x0 = (oy - cw // 2)[:, None, None]
    mask = (ys >= y0) & (ys < y0 + ch) & (xs >= x0) & (xs < x0 + cw)
    return x * (1.0 - mask[..., None].to(x.dtype))


AUGMENT_FNS = {
    "color": (rand_brightness, rand_saturation, rand_contrast),
    "translation": (rand_translation,),
    "cutout": (rand_cutout,),
}


def draw_augment(shape, policy: str = "color,translation,cutout",
                 generator=None, device=None) -> list[tuple]:
    """One tuple of draws per augmentation of ``policy``, in order, for
    frames of ``shape`` [B, H, W, C]."""
    b, h, w, _ = shape
    draws = []
    for p in filter(None, (p.strip() for p in policy.split(","))):
        for fn in AUGMENT_FNS[p]:
            if fn is rand_translation:
                sh, sw = _translation_extent(h, w)
                draws.append((
                    torch.randint(-sh, sh + 1, (b,), generator=generator),
                    torch.randint(-sw, sw + 1, (b,), generator=generator)))
            elif fn is rand_cutout:
                ch, cw = _cutout_extent(h, w)
                draws.append((
                    torch.randint(0, h + (1 - ch % 2), (b,),
                                  generator=generator),
                    torch.randint(0, w + (1 - cw % 2), (b,),
                                  generator=generator)))
            else:
                draws.append((torch.rand((b, 1, 1, 1), generator=generator),))
    return [tuple(d.to(device) for d in ds) for ds in draws]


def diff_augment(x, policy: str = "color,translation,cutout", draws=None,
                 generator=None):
    """x: [B, H, W, C]; ``draws`` from ``draw_augment`` (made from
    ``generator`` where not given)."""
    if not policy:
        return x
    if draws is None:
        draws = draw_augment(x.shape, policy, generator, x.device)
    fns = [fn for p in policy.split(",") for fn in AUGMENT_FNS[p.strip()]]
    for fn, args in zip(fns, draws, strict=True):
        x = fn(x, *(a.to(x.device, x.dtype) if a.is_floating_point()
                    else a.to(x.device) for a in args))
    return x

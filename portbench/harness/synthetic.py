"""Seeded synthetic mammograms, the benchmark's traffic.

Frozen copies of the port's two generators (`synthetic.py`:
`synthetic_mammograms`, `synthetic_native_mammogram`), drawn with a
`torch.Generator` on the device the benchmark runs on, in a few large
calls, so that a run's inputs cost little set-up. The geometry is the
port's; the noise is drawn in bulk, so the pixels differ from the port's
numpy draws.

- `mammograms(n, hw, gen)`: (n, hw, hw) uint8 screening crops: a textured
  breast disc at the right edge, a bright pectoral wedge in the top-right
  corner, one saturated 6x6 artifact.
- `native_mammogram(h, w, gen)`: (h, w) uint16 full-field scan (values up
  to 60000): a half-ellipse breast at the right edge with textured tissue,
  a bright pectoral wedge, zero background, as in CBIS-DDSM.
"""

from __future__ import annotations

import torch


def mammograms(n: int, hw: int, gen: torch.Generator) -> torch.Tensor:
    dev = gen.device
    yy = torch.arange(hw, device=dev).view(hw, 1)
    xx = torch.arange(hw, device=dev).view(1, hw)
    r = hw // 2
    breast = ((xx - (hw - 1)) ** 2 + (yy - hw // 2) ** 2) < r * r
    tissue = (110 + 25 * torch.randn((n, hw, hw), generator=gen, device=dev))
    tissue = tissue.clamp(40, 185).to(torch.uint8)
    img = torch.where(breast, tissue, torch.zeros((), dtype=torch.uint8, device=dev))
    wedge = ((hw - 1 - xx) + yy) < hw // 4
    img = torch.where(wedge, img.clamp_min(230), img)
    ay = torch.randint(0, hw // 2, (n,), generator=gen, device=dev)
    ax = torch.randint(0, hw // 4, (n,), generator=gen, device=dev)
    art = (((yy - ay.view(n, 1, 1)) >= 0) & ((yy - ay.view(n, 1, 1)) < 6)
           & ((xx - ax.view(n, 1, 1)) >= 0) & ((xx - ax.view(n, 1, 1)) < 6))
    return torch.where(art, torch.full((), 255, dtype=torch.uint8, device=dev), img)


def native_mammogram(h: int, w: int, gen: torch.Generator, top: int = 60000) -> torch.Tensor:
    """(h, w) int32 tensor holding uint16 values (torch has no uint16
    arithmetic on every device); the caller converts it."""
    dev = gen.device
    yy = torch.arange(h, device=dev, dtype=torch.float64).view(h, 1)
    xx = torch.arange(w, device=dev, dtype=torch.float64).view(1, w)
    ax, ay = int(w * 0.7), int(h * 0.45)
    breast = (((xx - (w - 1)) / ax) ** 2 + ((yy - h // 2) / ay) ** 2) <= 1.0
    tissue = (top * 0.45 + top * 0.1 * torch.randn((h, w), generator=gen, device=dev))
    tissue = tissue.clamp(top * 0.15, top * 0.75).to(torch.int32)
    img = torch.where(breast, tissue, torch.zeros((), dtype=torch.int32, device=dev))
    wedge = ((w - 1 - xx) / w + yy / h) < 0.25
    return torch.where(wedge, img.clamp_min(int(top * 0.9)), img)

"""Model FLOPs of Ronneberger's U-Net, from its configuration: 2 FLOPs a
multiply-add; a SAME k x k conv over (H, W) makes 2 H W Cin Cout k^2, a 2x2
stride-2 up-convolution to (2h, 2w) makes 2 (2h)(2w) Cin Cout (each output
sees one tap of Cin channels). Pools, ReLUs, the concatenations, the
sigmoid and the loss are not model FLOPs. At the published widths
(64-1024) and 512^2 one sample's forward is 384.7 GFLOP.
"""

from __future__ import annotations


def forward_flops(cfg: dict) -> float:
    """FLOPs of one sample's forward at `image_hw`^2."""
    feats = cfg["features"]
    h = w = cfg["image_hw"]
    total, c = 0.0, cfg["in_channels"]

    def double(h, w, cin, f):
        return 2.0 * h * w * 9 * (cin * f + f * f)

    for f in feats[:-1]:
        total += double(h, w, c, f)
        h, w, c = h // 2, w // 2, f
    total += double(h, w, c, feats[-1])
    c = feats[-1]
    for f in reversed(feats[:-1]):
        h, w = 2 * h, 2 * w
        total += 2.0 * h * w * c * f + double(h, w, 2 * f, f)
        c = f
    return total + 2.0 * h * w * c * cfg["out_channels"]


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one training step, by the convention 3 x forward (the
    forward, and a backward of twice its work)."""
    return 3.0 * forward_flops(cfg) * batch

"""Model FLOPs of a bottleneck ResNet classifier and the bytes of its
training batch norms, from its configuration.

FLOPs: 2 a multiply-add; a k x k conv of stride s and padding k // 2 (the
stem 3, the projections 0) over (H, W) makes 2 oh ow Cin Cout k^2, the fc 2
C classes. Batch norms, ReLUs, the max pool, the residual adds, the
average pool and the loss are not model FLOPs. At ResNet-50's widths, one
gray channel, 1152x896 and 2 classes, one image's forward is 164.9 GFLOP.

Batch-norm bytes (the kernel table's rule, each input read once and each
output written once, at the HBM rate): a training batch norm's forward
reads x and writes y (8 bytes an element), its backward reads dy and x
and writes dx (12 bytes). `BN_KERNELS` are the base names of the training
batch norm's kernels (`csrc/batchnorm.cu`), whose device time the
per-layer readers sum.
"""

from __future__ import annotations

from harness.counting import F32, HBM_BYTES_PER_S

BN_KERNELS = ("bn_stats_partial", "bn_stats_finalize", "bn_grad_partial", "bn_grad_finalize",
              "bn_train_map")
BN_FWD_BYTES = 2 * F32
BN_BWD_BYTES = 3 * F32


def _out(h: int, k: int, s: int) -> int:
    return (h + 2 * (k // 2) - k) // s + 1


def conv_layers(cfg: dict) -> list[tuple[int, int, int, int, int]]:
    """(oh, ow, cin, cout, k) of every conv of one image's forward, each
    followed by a batch norm over its (cout, oh, ow) output."""
    h, w = cfg["image_hw"]
    h, w = _out(h, 7, 2), _out(w, 7, 2)
    out = [(h, w, cfg["in_channels"], 64, 7)]
    h, w = _out(h, 3, 2), _out(w, 3, 2)          # the stem's max pool
    cin = 64
    for si, (n_blocks, width) in enumerate(zip(cfg["layers"], cfg["widths"])):
        for bi in range(n_blocks):
            s = 2 if (si > 0 and bi == 0) else 1
            oh, ow = _out(h, 3, s), _out(w, 3, s)
            cout = 4 * width
            out += [(h, w, cin, width, 1), (oh, ow, width, width, 3), (oh, ow, width, cout, 1)]
            if s != 1 or cin != cout:
                out.append((oh, ow, cin, cout, 1))
            h, w, cin = oh, ow, cout
    return out


def forward_flops(cfg: dict) -> float:
    """FLOPs of one image's forward at `image_hw`."""
    convs = sum(2.0 * oh * ow * cin * cout * k * k for oh, ow, cin, cout, k in conv_layers(cfg))
    return convs + 2.0 * conv_layers(cfg)[-1][3] * cfg["num_classes"]


def train_step_flops(cfg: dict, batch: int) -> float:
    """Model FLOPs of one training step, by the convention 3 x forward (the
    forward, and a backward of twice its work)."""
    return 3.0 * forward_flops(cfg) * batch


def bn_elements(cfg: dict) -> int:
    """Elements one image sends through its batch norms (every conv's
    output)."""
    return sum(oh * ow * cout for oh, ow, _, cout, _ in conv_layers(cfg))


def bn_train_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one training step's batch norms, forward and
    backward: their bytes over the HBM rate."""
    return bn_elements(cfg) * batch * (BN_FWD_BYTES + BN_BWD_BYTES) / HBM_BYTES_PER_S

"""The yardstick: peaks of the card, and the operations and bytes that a
kernel or a model step must at the least do, as functions of shapes (and
of the inputs, where the work depends on them).

Rules:
- bytes: each input byte read once, each output byte written once;
- float32 products (conv_leaky, the model FLOPs of `mfu`) are bounded by
  495 TFLOP/s, dense TF32 on tensor cores: the highest rate at which the
  card forms products of float32 operands, so an exact-float32 kernel on
  tensor cores stays under it;
- integer and elementwise float arithmetic (the watershed's sweeps) is
  bounded by 67 TFLOP/s, float32 outside the tensor cores;
- the pair-form watershed is counted at the sweeps its inputs need to
  reach the fixpoint, capped at JAX's 256 (`reference.cleaner.
  pair_sweeps_needed`), never at the kernel's own loop count: a kernel
  that stops early does the same work for the same output.

Peaks are NVIDIA's published H100 SXM figures at its 700 W limit; each
run prints the card's power limit beside the shares.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12

F32 = 4
PAIR_OPS_PER_PX_SWEEP = 56   # four passes: d -/+ s, three doubling steps, relax
PAIR_IO_BYTES_PER_PX = 13    # image and markers in, labels and boundary out


def roofline_s(ops: float, nbytes: float, peak_ops: float) -> float:
    """The least time the card could take: the larger of operations over
    the peak rate and bytes over the HBM rate."""
    return max(ops / peak_ops, nbytes / HBM_BYTES_PER_S)


def conv_out_hw(h: int, w: int, k: int, padding: str) -> tuple[int, int]:
    return (h, w) if padding == "SAME" else (h - k + 1, w - k + 1)


def conv_leaky_work(b: int, h: int, w: int, c: int, f: int, k: int,
                    padding: str) -> tuple[float, float]:
    """(FLOPs, bytes) of one stride-1 conv + bias + LeakyReLU, float32:
    2 FLOPs a multiply-add; input, weights and bias read, output written."""
    oh, ow = conv_out_hw(h, w, k, padding)
    flops = 2.0 * b * oh * ow * f * c * k * k
    nbytes = F32 * (b * h * w * c + f * c * k * k + f + b * oh * ow * f)
    return flops, nbytes


def classifier_layers(cfg: dict) -> list[tuple]:
    """[("conv", h, w, c, f, k), ..., ("dense", n_in, n_out), ...] of the
    CNN's forward at batch 1."""
    h, w, c = cfg["input_shape"]
    out = []
    for f, k in cfg["conv_layers"]:
        out.append(("conv", h, w, c, f, k))
        h, w = conv_out_hw(h, w, k, cfg["conv_padding"])
        h, w, c = h // 2, w // 2, f
    n = h * w * c
    for units in list(cfg["hidden_units"]) + [cfg["num_classes"]]:
        out.append(("dense", n, units))
        n = units
    return out


def conv_leaky_calls(cfg: dict, b: int) -> list[tuple[float, float]]:
    """(FLOPs, bytes) of each conv_leaky call of one forward of the conv
    stack at batch b."""
    return [conv_leaky_work(b, h, w, c, f, k, cfg["conv_padding"])
            for kind, *dims in classifier_layers(cfg) if kind == "conv"
            for h, w, c, f, k in [dims]]


def conv_leaky_bound_s(cfg: dict, b: int) -> float:
    """The least time of one forward's conv_leaky calls at batch b: each
    call's roofline time, summed."""
    return sum(roofline_s(f, nb, TF32_FLOPS) for f, nb in conv_leaky_calls(cfg, b))


def classifier_forward_flops(cfg: dict) -> float:
    """FLOPs of one sample's forward: every conv and dense product."""
    total = 0.0
    for kind, *dims in classifier_layers(cfg):
        if kind == "conv":
            h, w, c, f, k = dims
            total += conv_leaky_work(1, h, w, c, f, k, cfg["conv_padding"])[0]
        else:
            total += 2.0 * dims[0] * dims[1]
    return total


def head_backward_flops(cfg: dict) -> float:
    """FLOPs of one sample's Grad-CAM backward through the dense head to
    the conv stack's output (the input gradients of every dense layer)."""
    return sum(2.0 * d[0] * d[1] for kind, *d in classifier_layers(cfg) if kind == "dense")


def conv1_flops(h: int, w: int, filters: int = 64, k: int = 7, stride: int = 2) -> float:
    """FLOPs of the encoder's conv1 over one (h, w) gray image."""
    return 2.0 * (h // stride) * (w // stride) * filters * k * k


def bulk_model_flops(cfg: dict, image_hw: int, n_explained: int) -> float:
    """Model FLOPs of one image of the bulk pipeline: conv1, the
    classifier's forward, one head backward a class explained."""
    return (conv1_flops(image_hw, image_hw) + classifier_forward_flops(cfg)
            + n_explained * head_backward_flops(cfg))


def train_model_flops(cfg: dict) -> float:
    """Model FLOPs of one training sample, by the convention 3 x forward
    (the forward, and a backward of twice its work)."""
    return 3.0 * classifier_forward_flops(cfg)


def watershed_pair_work(h: int, w: int, sweeps: int) -> tuple[float, float]:
    """(operations, bytes) of the pair-form watershed on one (h, w) image
    that needs `sweeps` sweeps to its fixpoint."""
    return (float(PAIR_OPS_PER_PX_SWEEP) * h * w * sweeps,
            float(PAIR_IO_BYTES_PER_PX) * h * w)


def watershed_pair_bound_s(h: int, w: int, sweeps: int) -> float:
    """The least time of the pair-form watershed on one (h, w) image."""
    return roofline_s(*watershed_pair_work(h, w, sweeps), FP32_FLOPS)

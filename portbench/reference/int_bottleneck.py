"""The INT8 Monte-Carlo predictive of the Bayes-by-backprop ResNet-50 v1.5
(bottleneck blocks), written down plainly, one sample at a time, from the
quantised network's definition; the benchmark's copy of the program's
plain reference (qbn_tpu_torch/reference/resnet50.py), so that nothing
here imports the program:

* codes are zero-point-removed (u = q - zp, dequant u * scale);
* input quant: clip(round(x / s) + zp, a_lo, a_hi) - zp;
* a conv's integer sums are exact (float64 library convs); K = kh kw cin
  <= 520 takes the weights centred, acc * (sx sw), deeper convs
  (acc - zw winsum(u)) * (sx sw) in float32; then + bias, / s_out, round
  half to even, + zp, clip to 0..255, ReLU as max(q, zp), clip to the
  activation bounds, - zp;
* the stem's 3x3/2 max pool, padded 1 with the lowest code, takes the
  largest code of each window;
* a residual add dequantises both operands (main path first), adds,
  requantises on the add's grid, ReLU;
* the global pool rounds each channel's mean code half to even; the
  head's sums are exact, the softmax of the dequantised logits is
  averaged over the samples.

The architecture (`arch` of the configuration): "widths", "blocks",
"strides", "expansion", "stem" and "stem_pool" ([kernel or window,
stride, padding]), "input", "classes". On the card a sample's float64
stem output is 1.6 GB at B=256: the samples run one after another, each
freed before the next. `weight_bits=4` is the control: every weight's
centred code put on a 4-bit grid (steps of 16).

Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_CENTERED_K = (1 << 24) // (254 * 127)           # 520
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_INV_STD = (np.float32(1.0)
                    / np.array([0.229, 0.224, 0.225], np.float32)
                    ).astype(np.float32)


def normalize_imagenet(x: torch.Tensor) -> torch.Tensor:
    """torchvision's normalisation: (x - mean) times the float32
    reciprocal of the per-channel std."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    inv_std = torch.from_numpy(IMAGENET_INV_STD).to(x.device)
    return (x - mean) * inv_std


def blocks(arch):
    """[(name, planes, stride, has_shortcut)] of the bottleneck blocks."""
    out, cin, e = [], arch["widths"][0], arch["expansion"]
    for s, (planes, n, stride) in enumerate(zip(arch["widths"],
                                                 arch["blocks"],
                                                 arch["strides"])):
        for b in range(n):
            st = stride if b == 0 else 1
            out.append((f"stage{s}_block{b}", planes, st,
                        st != 1 or cin != planes * e))
            cin = planes * e
    return out


def block_convs(stride):
    """[(name, kernel, stride, padding, relu)] of a block's main path."""
    return [("conv_0", 1, 1, 0, True), ("conv_1", 3, stride, 1, True),
            ("conv_2", 1, 1, 0, False)]


def quantize(x, scale, zp, lo, hi):
    q = torch.clamp(torch.round(x / scale) + zp.to(torch.float32), lo, hi)
    return (q.to(torch.int32) - zp).to(torch.int8)


def requant(acc_f, bias, scale, zp, relu, lo, hi):
    y = acc_f + bias if bias is not None else acc_f
    zf = zp.to(torch.float32)
    q = torch.clamp(torch.round(y / scale) + zf, 0, 255)
    if relu:
        q = torch.maximum(q, zf)
    q = torch.clamp(q, lo, hi)
    return (q - zf).to(torch.int8)


def _conv64(x_codes, w, stride, pad):
    """Exact sums of NHWC codes and (cout, cin, kh, kw) float64 weights."""
    y = F.conv2d(x_codes.to(torch.float64).permute(0, 3, 1, 2), w,
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _regrid4(centred):
    return torch.clamp(torch.round(centred / 16.0), -8, 7) * 16.0


def accumulate(x, x_scale, w_codes, w_scale, w_zp, stride, pad,
               weight_bits=8):
    """A conv's float32 accumulator before its bias: x (B, H, W, cin)
    codes, w (kh, kw, cin, cout) codes with zero point w_zp."""
    kh, kw, cin, _cout = w_codes.shape
    w = w_codes.to(torch.float64).permute(3, 2, 0, 1)
    scale = x_scale * w_scale
    if kh * kw * cin <= _CENTERED_K or weight_bits != 8:
        wc = w - w_zp.to(torch.float64)
        if weight_bits != 8:
            wc = _regrid4(wc)
        return _conv64(x, wc, stride, pad).to(torch.float32) * scale
    acc = _conv64(x, w, stride, pad).to(torch.float32)
    ones = torch.ones((1, cin, kh, kw), dtype=torch.float64, device=x.device)
    win = _conv64(x, ones, stride, pad).to(torch.float32)
    return (acc - w_zp.to(torch.float32) * win) * scale


def max_pool(codes, window, stride, pad):
    """Max of each window of (B, H, W, C) codes, padded with -128."""
    c = F.pad(codes, (0, 0, pad, pad, pad, pad), value=-128)
    ho = (c.shape[1] - window) // stride + 1
    wo = (c.shape[2] - window) // stride + 1
    out = None
    for i in range(window):
        for j in range(window):
            v = c[:, i:i + (ho - 1) * stride + 1:stride,
                  j:j + (wo - 1) * stride + 1:stride, :]
            out = v if out is None else torch.maximum(out, v)
    return out


def global_pool(codes):
    """(B, H, W, C) codes -> (B, C): the mean code, rounded half to even."""
    _b, hh, ww, _c = codes.shape
    summed = codes.to(torch.int32).sum(dim=(1, 2))
    return torch.round(summed.to(torch.float32) / (hh * ww)).to(torch.int8)


def dense_acc(x, x_scale, w_codes, w_scale, w_zp, weight_bits=8):
    """A dense layer's float32 accumulator: x (B, F) codes, w (F, O)."""
    wc = w_codes.to(torch.float64) - w_zp.to(torch.float64)
    if weight_bits != 8:
        wc = _regrid4(wc)
    return (x.to(torch.float64) @ wc).to(torch.float32) * (x_scale * w_scale)


def add(o, o_scale, r, r_scale, q, bounds):
    """The residual add and its ReLU on the add's grid q."""
    total = o.to(torch.float32) * o_scale + r.to(torch.float32) * r_scale
    return torch.clamp(quantize(total, q["scale"], q["zp"], *bounds), min=0)


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def sample_logits(qc, x, arch, bounds, weights, weight_bits=8):
    """One sample's dequantised logits (B, classes). qc: the qconst tree
    (tensors on x's device); weights(path) -> (codes, scale, zp) of the
    conv or dense at `path`."""
    def run_conv(path, inp, inp_scale, stride, pad, relu):
        q = _node(qc, path)["q"]
        w, ws, wz = weights(path)
        acc = accumulate(inp, inp_scale, w, ws, wz, stride, pad, weight_bits)
        return (requant(acc, q["bias_f"], q["act_scale"], q["act_zp"], relu,
                        *bounds), q["act_scale"])

    iq = qc["input_quant"]["q"]
    h, s = quantize(x, iq["scale"], iq["zp"], *bounds), iq["scale"]
    _k, st, pad = arch["stem"]
    h, s = run_conv(("stem",), h, s, st, pad, True)
    h = max_pool(h, *arch["stem_pool"])
    for name, _planes, stride, has_sc in blocks(arch):
        o, os_ = h, s
        for cname, _k, cst, cpad, relu in block_convs(stride):
            o, os_ = run_conv((name, cname), o, os_, cst, cpad, relu)
        r, rs = h, s
        if has_sc:
            r, rs = run_conv((name, "shortcut"), h, s, stride, 0, False)
        q = qc[name]["add"]["q"]
        h, s = add(o, os_, r, rs, q, bounds), q["scale"]
    h = global_pool(h)
    fq = qc["fc"]["q"]
    w, ws, wz = weights(("fc",))
    out = requant(dense_acc(h, s, w, ws, wz, weight_bits), None,
                  fq["act_scale"], fq["act_zp"], False, *bounds)
    return out.to(torch.float32) * fq["act_scale"]


def predictive(qc, x, arch, bounds, samples, sampled, weight_bits=8):
    """(B, classes) mean over `samples` of the softmax probabilities;
    sampled {path: (S, *shape) codes} on each layer's add grid."""
    probs = []
    for i in range(samples):
        def weights(path, i=i):
            q = _node(qc, path)["q"]
            return sampled[path][i], q["add_scale"], q["add_zp"]
        logits = sample_logits(qc, x, arch, bounds, weights, weight_bits)
        probs.append(torch.softmax(logits, dim=-1))
    return torch.mean(torch.stack(probs).contiguous(), dim=0)

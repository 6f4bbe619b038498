"""The Bayes-by-backprop ResNet-50 v1.5, written down plainly from its
published description, for holding the port's ImageNetResNet to.

The network (torchvision's resnet50, the "v1.5" variant with the stride
on the 3x3; He et al., arXiv:1512.03385, Table 1): a 7x7/2 stem of 64
channels with batch norm and ReLU, a 3x3/2 max pool, bottleneck stages
[3, 4, 6, 3] at widths 64/128/256/512 with expansion 4 (1x1 to the
width, 3x3 carrying the stage's stride, 1x1 to 4 x the width, a strided
1x1 projection shortcut on each stage's first block, the add and ReLU),
a global average pool and a dense head. As a Bayesian net every conv and
the head draw their weights from a mean-field Gaussian posterior
(IntelLabs/bayesian-torch, resnet_variational_large.py). `arch` gives
the widths, the blocks per stage, the input (H, W, C) and the classes.

Departures from that description:
* batch norm runs on its running statistics (evaluation) in the float
  forward, and is folded into each conv's weights and bias in the INT8
  one (the converted state's `bias_f`);
* every pad is symmetric, as torchvision pads (the max pool pads 1 on
  each side, with the lowest code in INT8, so that it never wins);
* INT8 is A7/W8: unsigned 7-bit activations (codes 0..127 with a zero
  point) and 8-bit weights, on one grid per tensor;
* the head has no bias (as the repository's CIFAR ResNet-18's).

The float32 forward (`float_forward`) runs one weight sample w +
softplus(std) * eps, eps from a noise source called layer by layer in
the order stem; each block's conv_0, conv_1, conv_2, shortcut; fc. The
INT8 predictive (`predictive`) runs on drawn weight codes, one sample at
a time:
* codes are zero-point-removed (u = q - zp, dequant u * scale);
* input quant: clip(round(x / s) + zp, a_lo, a_hi) - zp;
* a conv's integer sums are exact (float64 library convs); K = kh kw cin
  <= 520 takes the weights centred, acc * (sx sw), deeper convs
  (acc - zw winsum(u)) * (sx sw) in float32; then + bias, / s_out, round
  half to even, + zp, clip to 0..255, ReLU as max(q, zp), clip to the
  activation bounds, - zp;
* the max pool takes the largest code of each window;
* a residual add dequantises both operands (main path first), adds,
  requantises on the add's grid, ReLU;
* the global pool sums each channel's codes and rounds the mean half to
  even; the head's sums are exact, the softmax of the dequantised logits
  is averaged over the samples.

Plain PyTorch; imports nothing of the program. Float32 products are kept
full (TF32 off) for the float forward on a card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STEM = (7, 2, 3)            # kernel, stride, padding
POOL = (3, 2, 1)            # window, stride, padding
STRIDES = (1, 2, 2, 2)
EXPANSION = 4
CUTS = ("stem", "stage0", "stage1", "stage2", "stage3", "pool")
_CENTERED_K = (1 << 24) // (254 * 127)           # 520


def blocks(arch):
    """[(name, planes, stride, has_shortcut)] of the bottleneck blocks."""
    out, cin = [], arch["widths"][0]
    for s, (planes, n) in enumerate(zip(arch["widths"], arch["blocks"])):
        for b in range(n):
            st = STRIDES[s] if b == 0 else 1
            out.append((f"stage{s}_block{b}", planes, st,
                        st != 1 or cin != planes * EXPANSION))
            cin = planes * EXPANSION
    return out


def block_convs(stride):
    """[(name, kernel, stride, padding, relu)] of a block's main path."""
    return [("conv_0", 1, 1, 0, True), ("conv_1", 3, stride, 1, True),
            ("conv_2", 1, 1, 0, False)]


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# -- float32 --------------------------------------------------------------

def _float_conv(x, w, stride, pad):
    """NHWC x HWIO -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def float_forward(params, stats, x, arch, noise, bn_eps: float = 1e-5):
    """(B, classes) probabilities of one weight sample of the float
    network. params: {path: {'kernel' (kh, kw, cin, cout), 'std',
    'bn_scale', 'bn_bias'}} nested by block name ('fc': kernel and std,
    (features, classes)); stats: the running {'mean', 'var'} likewise;
    noise(shape): a standard normal draw of a layer's weight shape."""
    def weight(path):
        p = _node(params, path)
        return p["kernel"] + F.softplus(p["std"], threshold=1e30) \
            * noise(p["kernel"].shape)

    def conv_bn(path, h, stride, pad, relu):
        y = _float_conv(h, weight(path), stride, pad)
        p, st = _node(params, path), _node(stats, path)
        y = (y - st["mean"]) / torch.sqrt(st["var"] + bn_eps) \
            * p["bn_scale"] + p["bn_bias"]
        return torch.relu(y) if relu else y

    k, st, pad = STEM
    h = conv_bn(("stem",), x, st, pad, True)
    win, pst, ppad = POOL
    h = F.max_pool2d(h.permute(0, 3, 1, 2), win, pst, ppad).permute(
        0, 2, 3, 1)
    for name, planes, stride, has_sc in blocks(arch):
        o = h
        for conv, _k, cst, cpad, relu in block_convs(stride):
            o = conv_bn((name, conv), o, cst, cpad, relu)
        r = conv_bn((name, "shortcut"), h, stride, 0, False) if has_sc \
            else h
        h = torch.relu(o + r)
    pooled = h.mean(dim=(1, 2))
    return torch.softmax(pooled @ weight(("fc",)), dim=-1)


# -- INT8 -----------------------------------------------------------------

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


def conv(x, x_scale, w_codes, w_scale, w_zp, bias, out_scale, out_zp, stride,
         pad, relu, bounds):
    """One quantised conv: x (B, H, W, cin) codes, w (kh, kw, cin, cout)."""
    kh, kw, cin, _cout = w_codes.shape
    w = w_codes.to(torch.float64).permute(3, 2, 0, 1)
    scale = x_scale * w_scale
    if kh * kw * cin <= _CENTERED_K:
        acc_f = _conv64(x, w - w_zp.to(torch.float64), stride, pad).to(
            torch.float32) * scale
    else:
        acc = _conv64(x, w, stride, pad).to(torch.float32)
        ones = torch.ones((1, cin, kh, kw), dtype=torch.float64,
                          device=x.device)
        win = _conv64(x, ones, stride, pad).to(torch.float32)
        acc_f = (acc - w_zp.to(torch.float32) * win) * scale
    return requant(acc_f, bias, out_scale, out_zp, relu, *bounds)


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


def dense(x, x_scale, w_codes, w_scale, w_zp, out_scale, out_zp, bounds):
    """Quantised dense: x (B, F) codes, w (F, O); exact integer sums."""
    wc = w_codes.to(torch.float64) - w_zp.to(torch.float64)
    acc = x.to(torch.float64) @ wc
    return requant(acc.to(torch.float32) * (x_scale * w_scale), None,
                   out_scale, out_zp, False, *bounds)


def sample_codes(qc, x, arch, bounds, weights, up_to=None):
    """One sample's codes at the cut `up_to` (one of CUTS: the stem's after
    its pool), or its dequantised logits (B, classes). qc: the converted
    state's qconst tree; weights(path) -> (codes, scale, zp) of the conv or
    dense at `path`."""
    def run_conv(path, inp, inp_scale, stride, pad, relu):
        q = _node(qc, path)["q"]
        w, ws, wz = weights(path)
        return (conv(inp, inp_scale, w, ws, wz, q["bias_f"], q["act_scale"],
                     q["act_zp"], stride, pad, relu, bounds), q["act_scale"])

    iq = qc["input_quant"]["q"]
    h, s = quantize(x, iq["scale"], iq["zp"], *bounds), iq["scale"]
    _k, st, pad = STEM
    h, s = run_conv(("stem",), h, s, st, pad, True)
    h = max_pool(h, *POOL)
    if up_to == "stem":
        return h
    stage = 0
    for name, planes, stride, has_sc in blocks(arch):
        if int(name[5]) != stage:
            if up_to == f"stage{stage}":
                return h
            stage = int(name[5])
        o, os_ = h, s
        for cname, _k, cst, cpad, relu in block_convs(stride):
            o, os_ = run_conv((name, cname), o, os_, cst, cpad, relu)
        r, rs = h, s
        if has_sc:
            r, rs = run_conv((name, "shortcut"), h, s, stride, 0, False)
        add = qc[name]["add"]["q"]
        total = o.to(torch.float32) * os_ + r.to(torch.float32) * rs
        h = torch.clamp(quantize(total, add["scale"], add["zp"], *bounds),
                        min=0)
        s = add["scale"]
    if up_to == f"stage{stage}":
        return h
    b, hh, ww, c = h.shape
    summed = h.to(torch.int32).sum(dim=(1, 2))
    h = torch.round(summed.to(torch.float32) / (hh * ww)).to(torch.int8)
    if up_to == "pool":
        return h
    fq = qc["fc"]["q"]
    w, ws, wz = weights(("fc",))
    out = dense(h, s, w, ws, wz, fq["act_scale"], fq["act_zp"], bounds)
    return out.to(torch.float32) * fq["act_scale"]


def predictive(qc, x, arch, bounds, sampled, samples):
    """(B, classes) mean over the samples of the softmax probabilities;
    sampled {path: (S, *shape) codes} on each layer's add grid."""
    probs = []
    for i in range(samples):
        def weights(path, i=i):
            q = _node(qc, path)["q"]
            return sampled[path][i], q["add_scale"], q["add_zp"]
        probs.append(torch.softmax(
            sample_codes(qc, x, arch, bounds, weights), dim=-1))
    return torch.mean(torch.stack(probs).contiguous(), dim=0)

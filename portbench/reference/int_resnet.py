"""The INT8 Monte-Carlo predictive of the CIFAR ResNet-18 (Bayes-by-backprop
or MC-Dropout), written down plainly, one sample at a time, from the
quantised network's definition (qbn_tpu's INT inference, the reference's
int8 modules):

* codes are zero-point-removed (u = q - zp, dequant u * scale);
* input quant: clip(round(x / s) + zp, a_lo, a_hi) - zp;
* a conv's integer sums are exact (float64 library convs); K = kh kw cin
  <= 520 takes the weights centred, acc * (sx sw), deeper convs
  (acc - zw winsum(u)) * (sx sw) in float32; then + bias, / s_out, round
  half to even, + zp, clip to 0..255, ReLU as max(q, zp), clip to the
  activation bounds, - zp;
* a dropout site (MC-Dropout, p) multiplies by the keep mask quantised on
  its own grid, requantises there and leaves at scale s_mul / (1 - p);
* a residual add dequantises both operands, adds, requantises, ReLU;
* the pool averages 4 x 4 codes (round half to even), the dense head's
  sums are exact, the softmax of the dequantised logits is averaged over
  the samples.

Plain PyTorch; imports nothing of the program. `weight_bits=4` is the
control: every weight's centred code put on a 4-bit grid (steps of 16).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_CENTERED_K = (1 << 24) // (254 * 127)           # 520


def blocks(arch):
    """[(name, stride, has_shortcut)] of the ResNet's basic blocks."""
    out, cin = [], arch["widths"][0]
    for s, (planes, n, stride) in enumerate(zip(arch["widths"],
                                                 arch["blocks"],
                                                 arch["strides"])):
        for b in range(n):
            st = stride if b == 0 else 1
            out.append((f"stage{s}_block{b}", st, st != 1 or cin != planes))
            cin = planes
    return out


def sites(arch):
    """The dropout sites in call order (the order their masks are drawn)."""
    out = [("drop_stem",)]
    for name, _st, sc in blocks(arch):
        out += [(name, "drop_0"), (name, "drop_1")]
        if sc:
            out.append((name, "drop_sc"))
    return out


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


def conv(x, x_scale, w_codes, w_scale, w_zp, bias, out_scale, out_zp, stride,
         pad, relu, bounds, weight_bits=8):
    """One quantised conv: x (B, H, W, cin) codes, w (kh, kw, cin, cout)."""
    kh, kw, cin, _cout = w_codes.shape
    w = w_codes.to(torch.float64).permute(3, 2, 0, 1)
    zw = w_zp.to(torch.float64)
    scale = x_scale * w_scale
    if kh * kw * cin <= _CENTERED_K or weight_bits != 8:
        wc = w - zw
        if weight_bits != 8:
            wc = _regrid4(wc)
        acc_f = _conv64(x, wc, stride, pad).to(torch.float32) * scale
    else:
        acc = _conv64(x, w, stride, pad).to(torch.float32)
        ones = torch.ones((1, cin, kh, kw), dtype=torch.float64,
                          device=x.device)
        win = _conv64(x, ones, stride, pad).to(torch.float32)
        acc_f = (acc - w_zp.to(torch.float32) * win) * scale
    return requant(acc_f, bias, out_scale, out_zp, relu, *bounds)


def dense(x, x_scale, w_codes, w_scale, w_zp, out_scale, out_zp, bounds,
          weight_bits=8):
    """Quantised dense: x (B, F) codes, w (F, O); exact integer sums."""
    wc = w_codes.to(torch.float64) - w_zp.to(torch.float64)
    if weight_bits != 8:
        wc = _regrid4(wc)
    acc = x.to(torch.float64) @ wc
    return requant(acc.to(torch.float32) * (x_scale * w_scale), None,
                   out_scale, out_zp, False, *bounds)


def site(x, x_scale, q, mask, p, bounds):
    """A dropout site: x codes times the (B, 1, 1, C) keep mask."""
    ms, mz = q["mul_scale"], q["mul_zp"]
    mzf = mz.to(torch.float32)
    mask_q = torch.clamp(torch.round(mask / ms) + mzf, 0, 255)
    mask_deq = (mask_q.to(torch.int32).to(torch.float32) - mzf) * ms
    prod = x.to(torch.float32) * x_scale * mask_deq
    codes = quantize(prod, ms, mz, *bounds)
    keep = torch.tensor(1.0 / (1.0 - p), dtype=torch.float32,
                        device=ms.device)
    return codes, ms * keep


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def sample_logits(qc, x, arch, bounds, weights, mask=None, p=0.0,
                  weight_bits=8):
    """One sample's dequantised logits (B, classes).

    qc: the qconst tree (tensors on x's device); weights(path) -> (codes,
    scale, zp) of a conv or dense block at `path`; mask(site) -> the
    site's (B, 1, 1, C) float mask (MC-Dropout) or None."""
    def run_conv(path, inp, inp_scale, stride, pad, relu):
        q = _node(qc, path)["q"]
        w, ws, wz = weights(path)
        out = conv(inp, inp_scale, w, ws, wz, q["bias_f"], q["act_scale"],
                   q["act_zp"], stride, pad, relu, bounds, weight_bits)
        return out, q["act_scale"]

    def drop(path, inp, inp_scale):
        if mask is None:
            return inp, inp_scale
        return site(inp, inp_scale, _node(qc, path)["q"], mask(path), p,
                    bounds)

    iq = qc["input_quant"]["q"]
    h, s = quantize(x, iq["scale"], iq["zp"], *bounds), iq["scale"]
    h, s = run_conv(("stem",), h, s, 1, 1, True)
    h, s = drop(("drop_stem",), h, s)
    for name, stride, has_sc in blocks(arch):
        o, os_ = run_conv((name, "conv_bn_relu"), h, s, stride, 1, True)
        o, os_ = drop((name, "drop_0"), o, os_)
        o, os_ = run_conv((name, "conv_bn"), o, os_, 1, 1, False)
        o, os_ = drop((name, "drop_1"), o, os_)
        r, rs = h, s
        if has_sc:
            r, rs = run_conv((name, "shortcut"), h, s, stride, 0, False)
            r, rs = drop((name, "drop_sc"), r, rs)
        add = qc[name]["add"]["q"]
        total = o.to(torch.float32) * os_ + r.to(torch.float32) * rs
        h = torch.clamp(quantize(total, add["scale"], add["zp"], *bounds),
                        min=0)
        s = add["scale"]
    b, hh, ww, c = h.shape
    pooled = h.to(torch.int32).reshape(b, hh // 4, 4, ww // 4, 4, c).sum(
        dim=(2, 4))
    h = torch.round(pooled.to(torch.float32) / 16).to(torch.int8)
    h = h.reshape(b, -1)
    fq = qc["fc"]["q"]
    w, ws, wz = weights(("fc",))
    out = dense(h, s, w, ws, wz, fq["act_scale"], fq["act_zp"], bounds,
                weight_bits)
    return out.to(torch.float32) * fq["act_scale"]


def predictive(qc, x, arch, bounds, samples, *, method, sampled=None,
               masks=None, p=0.0, weight_bits=8):
    """(B, classes) mean over `samples` of the softmax probabilities.

    Bayes-by-backprop: sampled {path: (S, *shape) codes} on the add grid.
    MC-Dropout: masks {site path: (S, B, 1, 1, C)} keep masks."""
    probs = []
    for i in range(samples):
        if method == "bbb":
            def weights(path, i=i):
                q = _node(qc, path)["q"]
                return sampled[path][i], q["add_scale"], q["add_zp"]
            mask = None
        else:
            def weights(path):
                q = _node(qc, path)["q"]
                return q["w_codes"], q["w_scale"], q["w_zp"]

            def mask(path, i=i):
                return masks[path][i]
        logits = sample_logits(qc, x, arch, bounds, weights, mask, p,
                               weight_bits)
        probs.append(torch.softmax(logits, dim=-1))
    return torch.mean(torch.stack(probs).contiguous(), dim=0)

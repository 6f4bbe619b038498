"""The INT state of a configuration whose state rule is "seeded": a
converted Bayes-by-backprop bottleneck ResNet's qconst tree, made by the
benchmark from the seed in plain PyTorch, independent of the program, and
handed as the same tree to the program and to the reference.

For each conv (kh, kw, cin, cout) and the head (features, classes):
* mean weights w ~ U(-b, b), b = sqrt(6 / fan_in) (Kaiming-uniform),
  coded on an 8-bit grid fitted to their range;
* posterior stds sigma = std_to_bound * b * U(0.5, 1.5), coded on their
  own grid, so that most drawn codes move off the mean's (as the
  committed flagship's do);
* the multiply's and the add's grids (the draw's) fitted to the range of
  sigma * eps and of w + sigma * eps over one seeded eps;
* grids are fitted as the port's observers fit them: the range widened
  to include 0, scale = range / levels, zero point = qmin - round(min /
  scale).
Then the plain reference's mean network (the mean codes on their own
grid) runs INT8 on `calibration_images` seeded images, layer by layer:
each conv's bias is its folded batch norm, bias_c = -mean_c + beta_c
std_c over the images (mean and std of the channel's accumulator, beta_c
~ N(0, beta_std) from the seed), and each output grid (convs, adds, the
input quantiser, the logits) is fitted to the quantiles that leave
clip_share of the values outside (the input and the logits: their whole
range; ReLU outputs: from 0). The head has no bias: before it is coded,
its mean weights are made orthogonal to the images' mean pooled feature,
which a bias would take out, so that the logits follow what tells the
images apart; then the head (means and stds) is scaled so that the
mean network's float top-1 probability averages head_top_prob over the
images, as a trained classifier's predictive is far from uniform (without
it the 1000-class predictive is nearly flat, and one logit code flipped
in one sample moves a probability by about 1e-6).

`qconst` raises if the state is degenerate: a layer whose codes take
fewer than 16 values on the calibration images, one top-1 class for every
image, a coded mean network whose top-1 probability averages under half
of head_top_prob, or identical predictives for every drawn sample (two
samples of the draw, on the same images).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import inputs
from portbench.reference import int_bottleneck as R, states
from portbench.reference.draw import draw

STATE_SALT, CALIB_SALT, DRAW_SALT = 11, 12, 13
MIN_CODES = 16


def _fit(lo, hi, qmin, qmax):
    """(scale, zero point) 0-d float32 / int32 of the range [lo, hi], as
    the port's observers fit them."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    scale = np.float32(max((np.float32(hi) - np.float32(lo))
                           / np.float32(qmax - qmin),
                           np.finfo(np.float32).eps))
    zp = int(np.clip(qmin - np.round(np.float32(lo) / scale), qmin, qmax))
    return (torch.tensor(scale, dtype=torch.float32),
            torch.tensor(zp, dtype=torch.int32))


def _codes(v, scale, zp, qmin, qmax):
    q = torch.clamp(torch.round(v / scale) + zp.to(torch.float32), qmin, qmax)
    return q.to(torch.int8)


def _quantile(t, q):
    flat = t.reshape(-1).to(torch.float32)
    k = min(max(int(round(q * (flat.numel() - 1))), 0), flat.numel() - 1)
    return float(flat.kthvalue(k + 1).values)


def layer_shapes(arch):
    """[(path, kernel shape)] of every stochastic layer, in the converted
    tree's order: the stem, each block's conv_0, conv_1, conv_2 and
    shortcut, the head."""
    k = arch["stem"][0]
    out = [(("stem",), (k, k, arch["input"][2], arch["widths"][0]))]
    cin, e = arch["widths"][0], arch["expansion"]
    for name, planes, _st, has_sc in R.blocks(arch):
        out += [((name, "conv_0"), (1, 1, cin, planes)),
                ((name, "conv_1"), (3, 3, planes, planes)),
                ((name, "conv_2"), (1, 1, planes, planes * e))]
        if has_sc:
            out.append(((name, "shortcut"), (1, 1, cin, planes * e)))
        cin = planes * e
    return out + [(("fc",), (cin, arch["classes"]))]


def _draw(shape, rule, rng):
    """A layer's mean weights, posterior stds and one draw's noise."""
    b = math.sqrt(6.0 / math.prod(shape[:-1]))
    w = rng.uniform(-b, b, shape).astype(np.float32)
    sigma = (rule["std_to_bound"] * b * rng.uniform(0.5, 1.5, shape)
             ).astype(np.float32)
    eps = rng.standard_normal(shape).astype(np.float32)
    return tuple(torch.from_numpy(v) for v in (w, sigma, eps))


def _coded(w, sigma, eps, w_bits):
    """A layer's q entry without its bias and output grid."""
    qmin, qmax = -(1 << (w_bits - 1)), (1 << (w_bits - 1)) - 1
    q = {}
    for key, v in (("w", w), ("std", sigma), ("mul", sigma * eps),
                   ("add", w + sigma * eps)):
        q[f"{key}_scale"], q[f"{key}_zp"] = _fit(v.min(), v.max(), qmin,
                                                 qmax)
    q["w_codes"] = _codes(w, q["w_scale"], q["w_zp"], qmin, qmax)
    q["std_codes"] = _codes(sigma, q["std_scale"], q["std_zp"], qmin, qmax)
    q["is_stoch"] = torch.tensor(1, dtype=torch.int32)
    q["w_lo"] = torch.tensor(qmin, dtype=torch.int32)
    q["w_hi"] = torch.tensor(qmax, dtype=torch.int32)
    return q


def _grid(y, relu, clip, bounds):
    lo = 0.0 if relu else _quantile(y, clip / 2)
    hi = _quantile(y, 1.0 - (clip if relu else clip / 2))
    scale, zp = _fit(lo, hi, *bounds)
    return scale.to(y.device), zp.to(y.device)


def _temperature(z, top):
    """The factor c > 0 at which softmax(c z)'s top-1 probability averages
    `top` over the rows of z (bisection in log c; it grows with c)."""
    z = z.to(torch.float64)
    lo, hi = -12.0, 12.0
    for _ in range(80):
        mid = (lo + hi) / 2
        p = float(torch.softmax(math.exp(mid) * z, -1).max(-1).values.mean())
        lo, hi = (mid, hi) if p < top else (lo, mid)
    return math.exp((lo + hi) / 2)


def _calibrate(qc, arch, x, rule, rng, bounds, seen, head, w_bits):
    """Fills each conv's bias_f and act grid, each add's grid and the
    input's, and codes the head from its float draw `head` (w, sigma,
    eps), running the mean network on the images x; seen[path] takes
    each layer's output codes. Returns the logits (B, classes)."""
    clip = float(rule["clip_share"])
    scale, zp = (t.to(x.device) for t in _fit(x.min(), x.max(), *bounds))
    qc["input_quant"] = {"q": {"scale": scale, "zp": zp}}
    h, s = R.quantize(x, scale, zp, *bounds), scale

    def conv(path, inp, inp_scale, stride, pad, relu):
        q = R._node(qc, path)["q"]
        acc = R.accumulate(inp, inp_scale, q["w_codes"], q["w_scale"],
                           q["w_zp"], stride, pad)
        mean = acc.mean(dim=(0, 1, 2))
        std = acc.std(dim=(0, 1, 2))
        beta = torch.from_numpy(rng.normal(
            0.0, rule["beta_std"], mean.shape).astype(np.float32))
        q["bias_f"] = beta.to(acc.device) * std - mean
        q["act_scale"], q["act_zp"] = _grid(acc + q["bias_f"], relu, clip,
                                            bounds)
        out = R.requant(acc, q["bias_f"], q["act_scale"], q["act_zp"], relu,
                        *bounds)
        seen[path] = out
        return out, q["act_scale"]

    _k, st, pad = arch["stem"]
    h, s = conv(("stem",), h, s, st, pad, True)
    h = R.max_pool(h, *arch["stem_pool"])
    for name, _planes, stride, has_sc in R.blocks(arch):
        o, os_ = h, s
        for cname, _k, cst, cpad, relu in R.block_convs(stride):
            o, os_ = conv((name, cname), o, os_, cst, cpad, relu)
        r, rs = h, s
        if has_sc:
            r, rs = conv((name, "shortcut"), h, s, stride, 0, False)
        total = o.to(torch.float32) * os_ + r.to(torch.float32) * rs
        scale, zp = _grid(total, False, clip, bounds)
        qc[name]["add"] = {"q": {"scale": scale, "zp": zp}}
        h, s = R.add(o, os_, r, rs, qc[name]["add"]["q"], bounds), scale
        seen[(name, "add")] = h
    h = R.global_pool(h)
    # the head without a bias: its mean weights made orthogonal to the
    # images' mean pooled feature, whose common part would otherwise give
    # every image one top-1 class (a bias would take it out), then scaled
    # to the rule's confidence
    f = h.to(torch.float32) * s
    unit = f.mean(dim=0) / f.mean(dim=0).norm()
    w, sigma, eps = (t.to(x.device) for t in head)
    w = w - unit[:, None] * (unit @ w)[None, :]
    c = _temperature(f @ w, float(rule["head_top_prob"]))
    w, sigma = c * w, c * sigma
    qc["fc"] = {"q": states.to_device(
        _coded(w.cpu(), sigma.cpu(), eps.cpu(), w_bits), x.device)}
    fq = qc["fc"]["q"]
    acc = R.dense_acc(h, s, fq["w_codes"], fq["w_scale"], fq["w_zp"])
    fq["act_scale"], fq["act_zp"] = _grid(acc, False, 0.0, bounds)
    out = R.requant(acc, None, fq["act_scale"], fq["act_zp"], False, *bounds)
    seen[("fc",)] = out
    return out.to(torch.float32) * fq["act_scale"]


def degenerate(seen, logits, sample_probs, top=0.0):
    """Why a calibrated state is degenerate, or None: `seen` each layer's
    output codes on the calibration images, `logits` the mean network's,
    `sample_probs` the probabilities of two drawn samples, `top` the
    rule's head_top_prob."""
    for path, codes in seen.items():
        n = len(torch.unique(codes))
        if n < MIN_CODES:
            return f"{'/'.join(path)}'s codes take {n} values"
    if len(torch.unique(logits.argmax(dim=-1))) < 2:
        return "every calibration image has the same top-1 class"
    p = float(torch.softmax(logits, -1).max(-1).values.mean())
    if p < top / 2:
        return (f"the mean network's top-1 probability averages {p:.4f}, "
                f"under half of {top}")
    if torch.equal(sample_probs[0], sample_probs[1]):
        return "the drawn samples' predictives are identical"
    return None


def qconst(config: dict, seed: int, device) -> dict:
    """The qconst tree (tensors on `device`) of a seeded state; raises
    RuntimeError if it is degenerate."""
    arch, rule = config["architecture"], config["state"]
    prec = config["precision"]
    bounds = (0, (1 << prec["activation_bits"]) - 1)
    rng = inputs.rng(seed, STATE_SALT)
    qc: dict = {}
    for path, shape in layer_shapes(arch):
        drawn = _draw(shape, rule, rng)
        if path == ("fc",):
            head = drawn            # coded in calibration
            continue
        node = qc
        for k in path:
            node = node.setdefault(k, {})
        node["q"] = _coded(*drawn, prec["weight_bits"])
    qc = states.to_device(qc, device)
    x, _y = inputs.images(int(rule["calibration_images"]), arch["input"],
                          arch["classes"], seed, CALIB_SALT)
    x = R.normalize_imagenet(torch.from_numpy(x).to(device))
    seen: dict = {}
    with torch.no_grad():
        logits = _calibrate(qc, arch, x, rule, rng, bounds, seen, head,
                            prec["weight_bits"])
        key = inputs.rng(seed, DRAW_SALT).integers(0, 2 ** 62, 2)
        sampled = draw(qc, 2, int(key[0]), int(key[1]), device)
        probs = [R.predictive(qc, x, arch, bounds, 1,
                              {p: c[i:i + 1] for p, c in sampled.items()})
                 for i in range(2)]
    why = degenerate(seen, logits, probs, float(rule["head_top_prob"]))
    if why is not None:
        raise RuntimeError(f"the seeded state is degenerate: {why}")
    return _order(qc, arch)


def _order(qc, arch):
    """The tree in the converted state's order: input quant, stem, each
    block's convs then its add, head."""
    out = {"input_quant": qc["input_quant"], "stem": qc["stem"]}
    for name, *_r in R.blocks(arch):
        blk = qc[name]
        out[name] = {k: blk[k] for k in ("conv_0", "conv_1", "conv_2",
                                          "shortcut", "add") if k in blk}
    out["fc"] = qc["fc"]
    return out

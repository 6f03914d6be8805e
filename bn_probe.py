"""What BatchNorm takes in a ResNet-50 training step on one NVIDIA GPU:
the port's kernels (K6a, K6b) against the eager PyTorch BatchNorm they
replaced, at every BatchNorm shape of the step.

    python3 bn_probe.py [--dtype bfloat16|float16|float32]

At each BatchNorm input of resnet50_v1 at batch 128 (NHWC, gamma and beta
in the data's type, as GluonTrainStep's casts make them), one train-mode
forward with the running-statistics update and one backward to x, gamma
and beta, captured in a CUDA graph and replayed (device time, no host
work between launches, as in the captured step; chip_smoke.graph_ms):

- "eager": ops/batch_norm.py batch_norm_fwd_plain on the (M, C) view
  (plain PyTorch ops, in the arithmetic of the port's BatchNorm before
  K6: float32 statistics over the data, the scale and shift applied in
  the data's type, the running-statistics update) and PyTorch's autograd
  backward through those ops;
- "K6": ops/batch_norm.py batch_norm (K6a forward, K6b backward) through
  its autograd Function.

Each shape's times and their sums over the 53 BatchNorms of a step are
printed beside the card's name and power limit, with the bound of the
step's BatchNorm (x read and y written once forward; x and dy read and
dx written once backward).  Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import argparse

import torch

import chip_smoke as cs
from mxnet_tpu_torch.ops import batch_norm as B


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args()
    dt = getattr(torch, args.dtype)
    smi = cs.environment()
    counts = {}
    for shape in cs.resnet_bns():
        counts[shape] = counts.get(shape, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {"eager": 0.0, "K6": 0.0}
    bound_total = 0.0
    for shape, n in counts.items():
        c = shape[-1]
        x = (torch.randn(shape, device="cuda", generator=gen) * 2 + 0.5).to(
            dt).requires_grad_()
        dy = torch.randn(shape, device="cuda", generator=gen).to(dt)
        gamma = (1 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(
            dt).requires_grad_()
        beta = (0.1 * torch.randn(c, device="cuda", generator=gen)).to(
            dt).requires_grad_()
        rm = torch.zeros(c, device="cuda")
        rv = torch.ones(c, device="cuda")

        def eager():
            with torch.enable_grad():
                out = B.batch_norm_fwd_plain(
                    x.reshape(-1, c), gamma, beta, rm, rv, cs.BN_EPS,
                    fix_gamma=False, use_global_stats=False,
                    momentum=cs.BN_MOMENTUM)[0].view(shape)
                return torch.autograd.grad(out, (x, gamma, beta), dy)

        def k6():
            with torch.enable_grad():
                out = B.batch_norm(x, gamma, beta, rm, rv, eps=cs.BN_EPS,
                                   fix_gamma=False, axis=-1,
                                   momentum=cs.BN_MOMENTUM)[0]
                return torch.autograd.grad(out, (x, gamma, beta), dy)

        ms = {"eager": cs.graph_ms(eager, iters=5),
              "K6": cs.graph_ms(k6, iters=5)}
        m = x.numel() // c
        bound = cs.bn_bound_ms(m, c, dt, 2)[0] + cs.bn_bound_ms(m, c, dt,
                                                                 3)[0]
        for k, v in ms.items():
            totals[k] += n * v
        bound_total += n * bound
        cs.log("bn_probe [%s %s, %d a step]: forward and backward in graph "
               "replays: eager BatchNorm %.4f ms, K6a + K6b %.4f ms (%.2fx), "
               "bound %.4f ms" % (shape, args.dtype, n, ms["eager"],
                                  ms["K6"], ms["eager"] / ms["K6"], bound))
        del x, dy, gamma, beta
        torch.cuda.empty_cache()
    cs.log("bn_probe on %s: the %d BatchNorms of a ResNet-50 step at batch "
           "%d in %s, forward and backward: eager BatchNorm %.3f ms, K6a + "
           "K6b %.3f ms, bound %.3f ms" % (
               smi, sum(counts.values()), cs.RESNET_BATCH, args.dtype,
               totals["eager"], totals["K6"], bound_total))


if __name__ == "__main__":
    main()

"""Where the conv weight-gradient kernels (K1a, K1b) spend their time on
one NVIDIA GPU.

    python3 conv_dw_probe.py [--parts] [--splits]

--parts: every bf16 ResNet-50 shape with the committed kernel and with
variants of csrc/conv_dw.cu built beside it that leave out the tensor-core
products, the operand loads, or both (their results are wrong; only their
times are read).  --splits: every shape at a range of split-K counts
around the one ops/conv_dw.py's plan picks.  Times are CUDA-event means
(chip_smoke.time_ms), printed beside the card's name and power limit.
Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

import chip_smoke as cs
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.ops import conv_dw as C

# text of csrc/conv_dw.cu that each variant takes out
PRODUCTS = ("      wgmma<kF16>(acc, desc(slot + a_off + kk * 2048), "
            "desc(slot + b_off + kk * 2048));")
LOADS = ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" '
         '::"r"(dst),\n               "l"(src), "r"(ok ? 16 : 0)\n'
         '               : "memory");')
NO_LOADS = "  (void)dst; (void)src; (void)ok;"


def _shapes():
    counts = {}
    for c in cs.resnet_convs():
        counts[c] = counts.get(c, 0) + 1
    return counts


def _inputs(xs, k, s, p, o, gen):
    n, h, w, _ = xs
    dys = (n, cs._out_size(h, k[0], s[0], p[0]),
           cs._out_size(w, k[1], s[1], p[1]), o)
    return (torch.randn(xs, device="cuda", generator=gen).bfloat16(),
            torch.randn(dys, device="cuda", generator=gen).bfloat16(), dys)


def _variants(out_dir):
    """Build the variants of conv_dw.cu into ``out_dir``, one nvcc each,
    all started together; return their loaded libraries by name."""
    src = open(os.path.join(_kernels.CSRC, "conv_dw.cu")).read()
    if PRODUCTS not in src or LOADS not in src:
        raise SystemExit("conv_dw_probe: csrc/conv_dw.cu no longer holds "
                         "the lines its variants take out")
    texts = {"no products": src.replace(PRODUCTS, "      ;"),
             "no loads": src.replace(LOADS, NO_LOADS),
             "neither": src.replace(PRODUCTS, "      ;").replace(
                 LOADS, NO_LOADS)}
    procs = {}
    for i, (name, text) in enumerate(texts.items()):
        d = os.path.join(out_dir, "variant%d" % i)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "conv_dw.cu"), "w") as f:
            f.write(text)
        so = os.path.join(d, "libconv_dw.so")
        procs[name] = (so, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", so,
             os.path.join(d, "conv_dw.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit("conv_dw_probe: building %s failed:\n%s"
                             % (name, log))
        libs[name] = _kernels._load("conv_dw", so)
    return libs


def parts(smi, gen):
    libs = {"kernel": _kernels.library("conv_dw")}
    libs.update(_variants(os.path.join(_kernels.BUILD_ROOT, "probe")))
    order = ["kernel", "no products", "no loads", "neither", "kernel"]
    sums = [dict(pertap=0.0, im2col=0.0) for _ in order]
    for (xs, k, s, p, o), n in _shapes().items():
        form = C.formulation(xs[3])
        x, dy, _ = _inputs(xs, k, s, p, o, gen)
        row = []
        for i, name in enumerate(order):
            _kernels._libs["conv_dw"] = libs[name]
            t = cs.time_ms(lambda: C.conv_dw(x, dy, k, s, p))
            sums[i][form] += n * t
            row.append("%s %.4f" % (name, t))
        _kernels._libs["conv_dw"] = libs["kernel"]
        print("parts %s x %s k %s s %s O %d (%d a step), ms: %s"
              % (form, xs, k, s, o, n, "; ".join(row)), flush=True)
    for name, t in zip(order, sums):
        print("parts over one ResNet-50 step on %s: %s K1a %.3f ms, K1b "
              "%.3f ms" % (smi, name, t["pertap"], t["im2col"]))


def splits(smi, gen):
    plan = C.split_plan
    for (xs, k, s, p, o), n in _shapes().items():
        form = C.formulation(xs[3])
        x, dy, dys = _inputs(xs, k, s, p, o, gen)
        stages = -(-dys[0] * dys[1] * dys[2] // C.TC_STAGE)
        picked, _ = plan(form, k, xs[3], o, dys[0] * dys[1] * dys[2],
                         torch.bfloat16)
        row = []
        for cut in sorted({1, 2, 3, 4, 6, 8, 16, 33, 66, 132, 264, picked}):
            per = -(-stages // cut)
            if per * C.TC_STAGE < C._TC_MIN_CHUNK:
                continue
            count = -(-stages // per)
            C.split_plan = lambda *a, _s=count, _c=per * C.TC_STAGE: (_s, _c)
            C.launch_plan.cache_clear()
            row.append((count, cs.time_ms(
                lambda: C.conv_dw(x, dy, k, s, p), iters=10)))
        C.split_plan = plan
        C.launch_plan.cache_clear()
        best = min(row, key=lambda r: r[1])
        print("splits %s x %s k %s s %s O %d on %s: plan %d; %s; fastest "
              "%d" % (form, xs, k, s, o, smi, picked, " ".join(
                  "%d:%.4f" % r for r in row), best[0]), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--splits", action="store_true")
    args = ap.parse_args()
    smi = cs.environment()
    gen = torch.Generator(device="cuda").manual_seed(3)
    if args.parts:
        parts(smi, gen)
    if args.splits:
        splits(smi, gen)


if __name__ == "__main__":
    sys.exit(main())

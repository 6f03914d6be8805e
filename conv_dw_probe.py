"""Where the conv weight-gradient kernels (K1a, K1b) spend their time on
one NVIDIA GPU.

    python3 conv_dw_probe.py [--parts] [--splits] [--ssd]
                             [--variant FILE.cu ...] [--rounds N]

--parts: every bf16 ResNet-50 shape with the committed kernel and with
variants of csrc/conv_dw.cu built beside it that leave out the tensor-core
products, the operand loads, or both (their results are wrong; only their
times are read).  --splits: every shape at a range of split-K counts
around the one ops/conv_dw.py's plan picks; with --ssd, SSD300's float32
shapes at batch 32 (the tf32x3 route) instead of ResNet-50's bf16 ones.
--variant: another source of csrc/conv_dw.cu's C interface (a copy with
one design changed), built beside the committed one (one nvcc each, csrc
on the include path), checked against the plain version at every
ResNet-50 bf16 shape (with --ssd: every SSD300 float32 shape) within
chip_smoke.DW_TOL of its largest magnitude, and timed there in turns with
the committed build (committed, variants, variants, committed; --rounds
times), with the sums over one step.
Times are CUDA-event means (chip_smoke.time_ms), printed beside the card's
name and power limit.  Without a CUDA device the script exits 1.
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


def _shapes(ssd=False):
    """{(x shape, kernel, stride, pad, O, dilate): convolutions a step}:
    ResNet-50's at batch 128, or SSD300's at batch 32."""
    counts = {}
    convs = cs.ssd_convs() if ssd else [c + ((1, 1),)
                                        for c in cs.resnet_convs()]
    for c in convs:
        counts[c] = counts.get(c, 0) + 1
    return counts


def _inputs(xs, k, s, p, o, gen, d=(1, 1), dtype=torch.bfloat16):
    n, h, w, _ = xs
    dys = (n, cs._out_size(h, k[0], s[0], p[0], d[0]),
           cs._out_size(w, k[1], s[1], p[1], d[1]), o)
    return (torch.randn(xs, device="cuda", generator=gen).to(dtype),
            torch.randn(dys, device="cuda", generator=gen).to(dtype), dys)


def _variants(out_dir):
    """Build the variants of conv_dw.cu into ``out_dir``, one nvcc each,
    all started together; return their loaded libraries by name."""
    src = open(os.path.join(_kernels.CSRC, "conv_dw.cu")).read()
    hopper = open(os.path.join(_kernels.CSRC, "hopper.cuh")).read()
    if PRODUCTS not in src or LOADS not in hopper:
        raise SystemExit("conv_dw_probe: csrc/conv_dw.cu or csrc/hopper.cuh "
                         "no longer holds the lines its variants take out")
    no_loads = hopper.replace(LOADS, NO_LOADS)
    texts = {"no products": (src.replace(PRODUCTS, "      ;"), hopper),
             "no loads": (src, no_loads),
             "neither": (src.replace(PRODUCTS, "      ;"), no_loads)}
    procs = {}
    for i, (name, (text, header)) in enumerate(texts.items()):
        d = os.path.join(out_dir, "variant%d" % i)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "conv_dw.cu"), "w") as f:
            f.write(text)
        with open(os.path.join(d, "hopper.cuh"), "w") as f:
            f.write(header)
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
    for (xs, k, s, p, o, _), n in _shapes().items():
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


def splits(smi, gen, ssd=False):
    plan = C.split_plan
    dtype = torch.float32 if ssd else torch.bfloat16
    stage = C.TF32_STAGE if ssd else C.TC_STAGE
    for (xs, k, s, p, o, d), n in _shapes(ssd).items():
        form = C.formulation(xs[3])
        x, dy, dys = _inputs(xs, k, s, p, o, gen, d, dtype)
        stages = -(-dys[0] * dys[1] * dys[2] // stage)
        picked, _ = plan(form, k, xs[3], o, dys[0] * dys[1] * dys[2], dtype)
        row = []
        for cut in sorted({1, 2, 3, 4, 6, 8, 16, 33, 66, 132, 264, picked}):
            per = -(-stages // cut)
            if per < C._MIN_CHUNK_STAGES and cut > 1:
                continue
            count = -(-stages // per)
            C.split_plan = lambda *a, _s=count, _c=per * stage: (_s, _c)
            C.launch_plan.cache_clear()
            row.append((count, cs.time_ms(
                lambda: C.conv_dw(x, dy, k, s, p, d), iters=10)))
        C.split_plan = plan
        C.launch_plan.cache_clear()
        best = min(row, key=lambda r: r[1])
        print("splits %s x %s k %s s %s d %s O %d (%d a step) on %s: plan "
              "%d; %s; fastest %d" % (form, xs, k, s, d, o, n, smi, picked,
                                      " ".join("%d:%.4f" % r for r in row),
                                      best[0]), flush=True)


def variants(smi, gen, paths, rounds, ssd):
    libs = {"committed": _kernels.library("conv_dw"),
            **_kernels.build_variants("conv_dw", paths)}
    names = [n for n in libs if n != "committed"]
    order = ["committed"] + names + names[::-1] + ["committed"]
    sums = {n: dict(pertap=0.0, im2col=0.0) for n in libs}
    dtype = torch.float32 if ssd else torch.bfloat16
    for (xs, k, s, p, o, d), n in _shapes(ssd).items():
        form = C.formulation(xs[3])
        x, dy, _ = _inputs(xs, k, s, p, o, gen, d, dtype)
        ref = C.conv_dw_reference(x, dy, k, s, p, d)
        scale = ref.abs().max().item()
        times = {name: [] for name in libs}
        for _ in range(rounds):
            for name in order:
                _kernels._libs["conv_dw"] = libs[name]
                err = (C.conv_dw(x, dy, k, s, p, d) - ref).abs().max().item()
                if not err <= cs.DW_TOL * scale:
                    raise SystemExit("conv_dw_probe: %s disagrees with the "
                                     "plain version at x %s O %d: %.3g of "
                                     "%.3g" % (name, xs, o, err, scale))
                times[name].append(cs.time_ms(
                    lambda: C.conv_dw(x, dy, k, s, p, d), iters=10))
        _kernels._libs["conv_dw"] = libs["committed"]
        row = {name: sum(t) / len(t) for name, t in times.items()}
        for name, t in row.items():
            sums[name][form] += n * t
        print("variants %s x %s k %s d %s O %d %s (%d a step) on %s, ms: %s"
              % (form, xs, k, d, o, str(dtype)[6:], n, smi, "; ".join(
                  "%s %.4f" % kv for kv in row.items())), flush=True)
        del x, dy, ref
    for name, t in sums.items():
        print("variants over one %s step on %s: %s K1a %.3f ms, K1b %.3f ms"
              % ("SSD300" if ssd else "ResNet-50", smi, name, t["pertap"],
                 t["im2col"]), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parts", action="store_true")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--ssd", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = cs.environment()
    gen = torch.Generator(device="cuda").manual_seed(3)
    if args.parts:
        parts(smi, gen)
    if args.splits:
        splits(smi, gen, args.ssd)
    if args.variant:
        variants(smi, gen, args.variant, args.rounds, args.ssd)


if __name__ == "__main__":
    sys.exit(main())

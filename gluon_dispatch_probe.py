"""What a dropped ResNet-50 leaves on the card and what its eager step
costs, for the tree this runs from, on one NVIDIA GPU: chip_smoke.py
phase 6's net and step (resnet50_v1 NHWC, GluonTrainStep(lr 0.1,
momentum 0.9, wd 1e-4, bf16 compute), one fixed (128, 224, 224, 3) batch
from seed 0).

    python3 gluon_dispatch_probe.py [TAG] [--eager N] [--phases 6,11]
    python3 gluon_dispatch_probe.py [TAG] --calls

``--calls`` needs no card: it counts the Python function calls (cProfile)
of 20 eager steps of a small ResNet v1 (BottleneckV1 [3, 4, 6, 3], widths
4-64, NCHW, batch 2 at 8 x 8) through GluonTrainStep on the CPU, after 5
untimed ones, and exits: the host work of the layers' dispatch, whatever
the host's load.

(1) It builds the net and its step, takes one eager step, drops both and
prints the card memory still allocated (a reference cycle among a
block's objects keeps a dropped net's memory until Python's collector
runs).  (2) On a second such net it times the eager step
(``step._eager``, the code the captured graph runs) in 3 windows of N
steps (default 10) after 3 warm-up steps, by CUDA events.  (3) With
``--phases``, chip_smoke.py's phase 6 (``resnet_train``: the captured
main path's step and peak memory, the eager step) and phase 11 (``ssd``:
the SSD300 step) run afterwards, in that order.  Each line names TAG and
the card's name and power limit.  To compare commits on one card, copy
this file into a checkout of each and run them in turns (parent, change,
change, parent) in one call.  Without a CUDA device it exits 1.
"""

import argparse
import cProfile
import os
import pstats
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch import _kernels  # noqa: E402
from mxnet_tpu_torch import gluon  # noqa: E402
from mxnet_tpu_torch.parallel import GluonTrainStep  # noqa: E402


def _step(x, y):
    step = GluonTrainStep(cs._resnet("cuda", 0),
                          gluon.loss.SoftmaxCrossEntropyLoss(), lr=0.1,
                          momentum=0.9, wd=1e-4, compute_dtype="bfloat16")
    xs, ys = step.put_batch(x, y)
    return step, xs, ys


def count_calls(tag):
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (BottleneckV1,
                                                              ResNetV1)

    torch.set_num_threads(1)
    net = ResNetV1(BottleneckV1, [3, 4, 6, 3], [4, 8, 16, 32, 64],
                   classes=10, layout="NCHW", device="cpu")
    net.initialize()
    step = GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          lr=0.1, momentum=0.9, wd=1e-4, device="cpu")
    rng = np.random.RandomState(0)
    xs, ys = step.put_batch(rng.rand(2, 3, 8, 8).astype(np.float32),
                            np.array([1, 2], np.int32))
    for _ in range(5):
        step._eager(xs, ys)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(20):
        step._eager(xs, ys)
    prof.disable()
    stats = pstats.Stats(prof)
    print("dispatch %s: %d Python function calls (%d primitive) in 20 eager "
          "steps of a small ResNet v1 on the CPU" % (
              tag, stats.total_calls, stats.prim_calls))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tag", nargs="?", default="tree")
    ap.add_argument("--eager", type=int, default=10)
    ap.add_argument("--phases", default="")
    ap.add_argument("--calls", action="store_true")
    args = ap.parse_args()
    if args.calls:
        count_calls(args.tag)
        return
    smi = cs.environment()
    with _kernels._lock:
        _kernels._build_locked({"conv_dw", "maxpool_bwd", "batch_norm",
                                "box_nms"})
    rng = np.random.RandomState(0)
    x = rng.rand(cs.RESNET_BATCH, cs.RESNET_SIZE, cs.RESNET_SIZE,
                 3).astype(np.float32)
    y = rng.randint(0, cs.RESNET_CLASSES, (cs.RESNET_BATCH,)).astype(np.int32)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    step, xs, ys = _step(x, y)
    step._eager(xs, ys)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del step, xs, ys
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    cs.log("dispatch %s on %s: a net with its step and one eager step held "
           "%.3f GB; dropped, %.3f GB stay allocated" % (
               args.tag, smi, held / 1e9, left / 1e9))

    step, xs, ys = _step(x, y)
    for _ in range(3):
        step._eager(xs, ys)
    ms = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(args.eager):
            step._eager(xs, ys)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]) / args.eager)
    cs.log("dispatch %s on %s: the eager step in 3 windows of %d steps %s "
           "ms, median %.2f ms" % (args.tag, smi, args.eager,
                                   " ".join("%.2f" % t for t in ms),
                                   float(np.median(ms))))
    del step, xs, ys
    torch.cuda.empty_cache()

    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        {"6": cs.resnet_train, "11": cs.ssd}[p](0, smi)


if __name__ == "__main__":
    main()

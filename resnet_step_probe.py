"""The captured ResNet-50 training step of the tree this runs from, on one
NVIDIA GPU: chip_smoke.py phase 6's main path (resnet50_v1 NHWC,
GluonTrainStep(lr 0.1, momentum 0.9, wd 1e-4, bf16 compute), one fixed
(128, 224, 224, 3) batch from seed 0).

    python3 resnet_step_probe.py [TAG]

After 3 steps (warm-up, capture, replays) it prints the ms of a step in 3
windows of 10 graph replays (CUDA events), their median and images per
second, the first three losses, then phase 6's profile of 3 replays
(device time by kernel group, device kernels, each wrapper's launches),
each beside the card's name and power limit.  To compare two commits on
one card, copy this file into a checkout of each and run them in turns
(parent, change, change, parent) in one call, TAG naming each run.
Without a CUDA device it exits 1.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch import gluon  # noqa: E402
from mxnet_tpu_torch.parallel import GluonTrainStep  # noqa: E402


def main():
    tag = sys.argv[1] if len(sys.argv) > 1 else "tree"
    smi = cs.environment()
    cs.build()
    rng = np.random.RandomState(0)
    x = rng.rand(cs.RESNET_BATCH, cs.RESNET_SIZE, cs.RESNET_SIZE,
                 3).astype(np.float32)
    y = rng.randint(0, cs.RESNET_CLASSES, (cs.RESNET_BATCH,)).astype(np.int32)
    step = GluonTrainStep(cs._resnet("cuda", 0),
                          gluon.loss.SoftmaxCrossEntropyLoss(), lr=0.1,
                          momentum=0.9, wd=1e-4, compute_dtype="bfloat16")
    xs, ys = step.put_batch(x, y)
    losses = [step(xs, ys).float().item() for _ in range(3)]
    ms = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            step(xs, ys)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]) / 10)
    med = float(np.median(ms))
    cs.log("step_time %s on %s: ms a step in 3 windows of 10 replays %s, "
           "median %.3f ms, %.1f images/s; first losses %s" % (
               tag, smi, " ".join("%.3f" % t for t in ms), med,
               cs.RESNET_BATCH / med * 1e3, losses))
    cs.profile_steps(lambda: step(xs, ys), smi, med, groups=cs.RESNET_GROUPS,
                     tag="step_time " + tag, count=cs.RESNET_LAUNCH_KERNELS)


if __name__ == "__main__":
    main()

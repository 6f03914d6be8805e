"""What the max-pool backward kernel (K2) takes at ResNet-50's stem pool on
one NVIDIA GPU, by tile shape.

    python3 pool_bwd_probe.py [--dtype bfloat16|float16|float32]
                              [--variant FILE.cu ...]

Times csrc/maxpool_bwd.cu at 3x3/s2/p1 on (128, 112, 112, 64) with the
tile that ops/pool_bwd.py's launch_plan picks and with other tile heights,
widths and channel chunks, each held bitwise to the plain version first;
beside them PyTorch's max_pool2d_with_indices_backward and the bound.
--variant builds another source of the same C interface (an earlier
version of the kernel, say) beside it and times it at the same tiles, in
turns with the committed one.
Times are CUDA-event means (chip_smoke.time_ms), printed beside the card's
name and power limit.  Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

import chip_smoke as cs
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import pool_bwd as P

STEM = (cs.RESNET_BATCH, 112, 112, 64)
K, S, PAD = (3, 3), (2, 2), (1, 1)
# (tile rows, tile columns, tile channels in units of the plan's)
TILES = [(16, 16, 1), (16, 8, 1), (8, 16, 1), (8, 8, 1), (32, 16, 1),
         (16, 32, 1), (32, 32, 1), (4, 32, 1), (16, 16, 2), (8, 8, 2)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--variant", action="append", default=[])
    args = ap.parse_args()
    dt = getattr(torch, args.dtype)
    smi = cs.environment()
    libs = {"committed": _kernels.library("maxpool_bwd")}
    libs.update(_kernels.build_variants("maxpool_bwd", args.variant))
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, h, w, c = STEM
    dys = (n, cs._out_size(h, 3, 2, 1), cs._out_size(w, 3, 2, 1), c)
    x = torch.randn(STEM, device="cuda", generator=gen).to(dt)
    dy = torch.randn(dys, device="cuda", generator=gen).to(dt)
    ref = P.maxpool_bwd_reference(x, dy, K, S, PAD)
    plan = P.launch_plan(STEM, dys, K, S, dt)
    bound, _ = cs.maxpool_bound_ms(STEM, dys, dt)
    _, idx = F.max_pool2d(cs._nchw(x), K, S, PAD, return_indices=True)
    lib_ms = cs.time_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        cs._nchw(dy), cs._nchw(x), K, S, PAD, (1, 1), False, idx))
    cs.log("pool_bwd_probe on %s: stem %s %s, bound %.4f ms, "
           "max_pool2d_with_indices_backward %.4f ms; the plan's tile %dx%dx%d"
           % (smi, STEM, args.dtype, bound, lib_ms, plan.tile_h, plan.tile_w,
              plan.tile_c))
    code = P._DTYPE_CODES[dt]
    dx = torch.empty_like(x)
    for th, tw, split in TILES:
        tc = plan.tile_c // split
        smem = P._staging(th, tw, tc, K, S, dys[1:3], x.element_size())[-1]
        # in turns: committed, variants, variants again, committed
        order = list(libs) + list(libs)[::-1]
        times = {name: [] for name in libs}
        for name in order:
            lib = libs[name]

            def run():
                _kernels.launch(lib, lib.mxt_maxpool_bwd, x, dy, dx, n, h, w,
                                c, dys[1], dys[2], 3, 3, 2, 2, 1, 1, th, tw,
                                tc, plan.vec, code)

            try:
                dx.fill_(float("nan"))
                run()
            except MXNetError as e:
                times[name].append(str(e).split(": ")[-1])
                continue
            torch.cuda.synchronize()
            if not torch.equal(dx, ref):
                raise AssertionError("%s at tile %dx%dx%d differs from the "
                                     "plain version" % (name, th, tw, tc))
            times[name].append(cs.time_ms(run))
        cs.log("  tile %2dx%2dx%2d (%6d bytes of shared memory committed): %s"
               % (th, tw, tc, smem, "; ".join(
                   "%s %s" % (name, ", ".join(
                       "%.4f ms (%.1f %% of the bound)" % (t, 100 * bound / t)
                       if isinstance(t, float) else t for t in ts))
                   for name, ts in times.items())))


if __name__ == "__main__":
    main()

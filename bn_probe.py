"""K6b, the port's BatchNorm backward, by design on one NVIDIA GPU, at
every BatchNorm shape of a ResNet-50 training step.

    python3 bn_probe.py [--dtype bfloat16|float16|float32]
                        [--variant PATH ...] [--part PATH ...]
                        [--rounds N] [--step]

At each BatchNorm input of resnet50_v1 at batch 128 (NHWC, gamma and beta
in the data's type, as GluonTrainStep's casts make them), the backward to
x, gamma and beta of each build of csrc/batch_norm.cu, launched through
its C entry mxt_bn_bwd and captured in a CUDA graph and replayed (device
time, no host work between launches, as in the captured step;
chip_smoke.graph_ms), in turns:

- "committed": the source as it is, on the route that
  ops/batch_norm.py launch_plan chooses from the shapes ("resident" or
  "streamed");
- each ``--variant``: another version of the source, with the committed
  C interface or with the earlier one that takes no launch plan (a
  source without mxt_bn_bwd_occupancy; say, the three-launch design:
  ``git show 0ab0f4f:mxnet_tpu_torch/csrc/batch_norm.cu`` gives it); a
  design is compared as such a copy of the source, never as a build
  option; each ``--part`` the same, timed without the check (say, a copy
  without its grid barriers, to see what the rest costs);
- "aten": ``native_batch_norm_backward`` on the same tensors (float32
  weights; a yardstick of time only).

Every build is held against ops/batch_norm.py batch_norm_bwd_plain first
(chip_smoke.BN_TOL), and the builds whose results equal the committed
one's bit for bit are named.  Each shape's times, their sums over the 53
BatchNorms of a step and the bound (x and dy read and dx written once)
are printed beside the card's name and power limit; ``--rounds`` repeats
the turns, so that a difference can be told from run-to-run noise.
Variant builds go to mxnet_tpu_torch/_build/.

``--step`` then times the captured ResNet-50 training step end to end
(chip_smoke phase 6's step: GluonTrainStep, bf16 compute, one fixed
batch) with K6b's routes as launch_plan chooses them ("planned") and
with the streamed route at every shape ("streamed"): two nets of one
seed, each step captured with its plan, replayed in turns (planned,
streamed, streamed, planned, ``--rounds`` times, 10 steps a turn, CUDA
events); the first two losses of the two must be equal bit for bit,
since K6b's results do not depend on the route.  Without a CUDA device the
script exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import os

import numpy as np
import torch

import chip_smoke as cs
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.ops import batch_norm as B

# the fields of a LaunchPlan that K6b's route sets
ROUTE_FIELDS = B.LaunchPlan._fields[-7:]
PLANNED = B.launch_plan  # --step replaces B.launch_plan while it captures


def _call(lib, x, dy, stats, gamma, plan):
    """K6b of ``lib`` through mxt_bn_bwd: (dx, dgamma, dbeta)."""
    m, c = x.shape
    code = B._DTYPE_CODES[x.dtype]
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=gamma.dtype, device=x.device)
    dbeta = torch.empty_like(dgamma)
    ws = torch.empty(plan.bwd_ws, dtype=torch.float32, device=x.device)
    route = ()
    if hasattr(lib, "mxt_bn_bwd_occupancy"):
        route = (int(plan.route == "resident"), plan.bwd_grid, plan.bwd_smem,
                 plan.splits_per_block, plan.kept_rounds)
    _kernels.launch(lib, lib.mxt_bn_bwd, x, dy, stats, gamma, dx, dgamma,
                    dbeta, ws, m, c, plan.vec, plan.tpr, plan.splits,
                    plan.rows, code, code, code, 1, 0, *route)
    return dx, dgamma, dbeta


def _earlier_interface(lib):
    """A variant without mxt_bn_bwd_occupancy: its mxt_bn_bwd takes the
    geometry and no launch plan."""
    if not hasattr(lib, "mxt_bn_bwd_occupancy"):
        lib.mxt_bn_bwd.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 11
                                   + [ctypes.c_void_p])
    return lib


def _streamed(m, c, dtype, aligned=True, sms=B._SMS):
    """launch_plan's plan with K6b's streamed route at every shape."""
    plan = PLANNED(m, c, dtype, aligned, sms)
    rps = -(-plan.rows // plan.rows_at_once)
    return plan._replace(**dict(zip(ROUTE_FIELDS, B._streamed_route(
        plan.splits, rps, plan.vec, plan.channel_tiles, sms))))


def step_routes(rounds, smi):
    """``--step``: the captured ResNet-50 step on the planned routes and on
    the streamed route alone, replayed in turns."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import GluonTrainStep

    rng = np.random.RandomState(6)
    x = rng.rand(cs.RESNET_BATCH, cs.RESNET_SIZE, cs.RESNET_SIZE,
                 3).astype(np.float32)
    y = rng.randint(0, cs.RESNET_CLASSES, (cs.RESNET_BATCH,)).astype(np.int32)
    steps, first, routes = {}, {}, {}
    for name, plan_fn in (("planned", PLANNED), ("streamed", _streamed)):
        seen = set()

        def plan_of(*args, plan_fn=plan_fn, seen=seen):
            plan = plan_fn(*args)
            seen.add((args[0], args[1], plan.route))
            return plan

        step = GluonTrainStep(cs._resnet("cuda", 0),
                              gluon.loss.SoftmaxCrossEntropyLoss(), lr=0.1,
                              momentum=0.9, wd=1e-4, compute_dtype="bfloat16")
        xs, ys = step.put_batch(x, y)
        B.launch_plan = plan_of
        try:  # the first call warms up eagerly, captures and replays
            first[name] = [step(xs, ys).float().item()]
        finally:
            B.launch_plan = PLANNED
        first[name].append(step(xs, ys).float().item())  # after one update
        steps[name] = lambda step=step, xs=xs, ys=ys: step(xs, ys)
        routes[name] = sorted(r for r in seen if r[2] == "resident")
    ms = {k: [] for k in steps}
    for _ in range(rounds):
        for k in ("planned", "streamed", "streamed", "planned"):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            steps[k]()
            ev[0].record()
            for _ in range(10):
                steps[k]()
            ev[1].record()
            torch.cuda.synchronize()
            ms[k].append(ev[0].elapsed_time(ev[1]) / 10)
    cs.log("bn_probe --step on %s: the captured ResNet-50 step (batch %d, "
           "bf16), ms a step in turns of 10: %s; the shapes on the resident "
           "route: planned %s, streamed %s; the first two losses %r" % (
               smi, cs.RESNET_BATCH, "; ".join(
                   "%s %s (best %.3f, median %.3f)" % (
                       k, "/".join("%.3f" % t for t in v), min(v),
                       float(np.median(v))) for k, v in ms.items()),
               routes["planned"], routes["streamed"], first))
    if first["planned"] != first["streamed"]:
        raise AssertionError("the first two losses differ: %s" % first)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--part", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--step", action="store_true")
    args = ap.parse_args()
    dt = getattr(torch, args.dtype)
    smi = cs.environment()
    built = _kernels.build_variants("batch_norm", args.variant + args.part)
    # name -> (library, checked)
    designs = {"committed": (_kernels.library("batch_norm"), True)}
    for path in args.variant + args.part:
        designs[os.path.basename(path)] = (
            _earlier_interface(built[os.path.basename(path)]),
            path in args.variant)
    counts = {}
    for n, h, w, c in cs.resnet_bns():
        counts[(n * h * w, c)] = counts.get((n * h * w, c), 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {k: 0.0 for k in list(designs) + ["aten", "bound"]}
    for (m, c), n in counts.items():
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 0.5).to(dt)
        dy = torch.randn(m, c, device="cuda", generator=gen).to(dt)
        gamma = (1 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(dt)
        beta = (0.1 * torch.randn(c, device="cuda", generator=gen)).to(dt)
        stats = B.batch_norm_fwd(x, gamma, beta, torch.zeros(c, device="cuda"),
                                 torch.ones(c, device="cuda"), cs.BN_EPS,
                                 False, False)[3]
        plan = B.launch_plan(m, c, dt)
        ref = B.batch_norm_bwd_plain(x, dy, stats, gamma, beta, False, True)
        calls, first, same_as = {}, None, {}
        for name, (lib, checked) in designs.items():
            def call(lib=lib):
                return _call(lib, x, dy, stats, gamma, plan)

            got, again = call(), call()
            errs = [cs._bn_err(g, r)[1] for g, r in zip(got, ref)]
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            if checked and (max(errs) > cs.BN_TOL[dt] or not same):
                raise AssertionError(
                    "%s at M %d C %d: errs %s, repeatable %s" % (
                        name, m, c, errs, same))
            calls[name] = call
            if first is None:
                first = got
            same_as[name] = all(torch.equal(a, b) for a, b in zip(got, first))
        w32 = gamma.float()
        _, mean, invstd = torch.ops.aten.native_batch_norm(
            x, w32, beta.float(), None, None, True, 0.1, cs.BN_EPS)
        calls["aten"] = lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, w32, None, None, mean, invstd, True, cs.BN_EPS,
            [True, True, True])
        order = list(calls) + list(calls)[::-1]
        ms = {k: [] for k in calls}
        for _ in range(args.rounds):
            for k in order:
                ms[k].append(cs.graph_ms(calls[k], iters=10))
        best = {k: min(v) for k, v in ms.items()}
        bound = cs.bn_bound_ms(m, c, dt, 3)[0]
        for k, v in best.items():
            totals[k] += n * v
        totals["bound"] += n * bound
        cs.log("bn_probe [M %d C %d %s, %d a step; committed route %s, %d "
               "splits a block, grid %d; bitwise equal to the committed "
               "build: %s]: K6b in graph replays (each turn, ms): %s; bound "
               "%.4f ms" % (
                   m, c, args.dtype, n, plan.route, plan.splits_per_block,
                   plan.bwd_grid, ", ".join(k for k, v in same_as.items()
                                            if v), ", ".join(
                       "%s %s (%.1f %% of the bound)" % (
                           k, "/".join("%.4f" % t for t in v),
                           100.0 * bound / best[k]) for k, v in ms.items()),
                   bound))
        del x, dy, ref, calls
        torch.cuda.empty_cache()
    cs.log("bn_probe on %s: K6b over the %d BatchNorms of a ResNet-50 step "
           "at batch %d in %s, the best turn of each: %s" % (
               smi, sum(counts.values()), cs.RESNET_BATCH, args.dtype,
               ", ".join("%s %.3f ms" % kv for kv in totals.items())))
    if args.step:
        step_routes(args.rounds, smi)


if __name__ == "__main__":
    main()

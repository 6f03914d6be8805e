"""K6a and K6b, the port's BatchNorm forward and backward, by design on
one NVIDIA GPU, at every BatchNorm shape of a ResNet-50 training step.

    python3 bn_probe.py [--dtype bfloat16|float16|float32]
                        [--kernel fwd|bwd|both]
                        [--variant PATH ...] [--part PATH ...]
                        [--rounds N] [--streamed] [--step]

At each BatchNorm input of resnet50_v1 at batch 128 (NHWC, gamma and beta
in the data's type, as GluonTrainStep's casts make them), the forward in
train mode with the running statistics' update (K6a, through its C entry
mxt_bn_fwd) and the backward to x, gamma and beta (K6b, mxt_bn_bwd) of
each build of csrc/batch_norm.cu, captured in a CUDA graph and replayed
(device time, no host work between launches, as in the captured step;
chip_smoke.graph_ms), in turns:

- "committed": the source as it is, on the plans that
  ops/batch_norm.py launch_plan makes from the shapes (K6a streamed at
  every shape; K6b "resident" or "streamed");
- each ``--variant``: another version of the source, with the committed
  C interface or with an earlier one that takes no launch plan (a source
  without mxt_bn_fwd_occupancy, or without mxt_bn_bwd_occupancy: say,
  the three-launch designs, ``git show 647e5e1:mxnet_tpu_torch/csrc/
  batch_norm.cu`` for K6a, ``git show 0ab0f4f:...`` for both); a design
  is compared as such a copy of the source, never as a build option;
  each ``--part`` the same, timed without the check (say, a copy without
  its grid barriers, to see what the rest costs);
- with ``--streamed``, "streamed": the committed K6b on its streamed
  route at every shape;
- "aten": ``native_batch_norm`` and its backward on the same tensors
  (float32 weights; a yardstick of time only).

Every build is held against ops/batch_norm.py's plain versions first
(chip_smoke.BN_TOL): y, the mean and var, the running statistics, and
dx, dgamma and dbeta; the builds whose results (y, mean, var, ``stats``
and the running statistics; dx, dgamma and dbeta) equal the committed
one's bit for bit are named.  Each shape's times, their sums over the 53
BatchNorms of a step and the bound (K6a: x read and y written once; K6b:
x and dy read and dx written once) are printed beside the card's name
and power limit; ``--rounds`` repeats the turns, so that a difference can
be told from run-to-run noise.  Variant builds go to
mxnet_tpu_torch/_build/.

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
ROUTE_FIELDS = ("route", "splits_per_block", "rounds", "kept_rounds",
                "bwd_grid", "bwd_smem", "blocks_per_sm")
PLANNED = B.launch_plan  # --step replaces B.launch_plan while it captures
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _call_fwd(lib, x, gamma, beta, rm, rv, plan):
    """K6a of ``lib`` through mxt_bn_fwd in train mode, moving the running
    statistics ``rm`` and ``rv`` in place: (y, mean, var, stats, rm,
    rv)."""
    m, c = x.shape
    code = B._DTYPE_CODES[x.dtype]
    y = torch.empty_like(x)
    mean = torch.empty(c, dtype=x.dtype, device=x.device)
    var = torch.empty_like(mean)
    stats = torch.empty((4, c), dtype=torch.float32, device=x.device)
    ws = torch.empty(plan.fwd_ws, dtype=torch.float32, device=x.device)
    route = ()
    if hasattr(lib, "mxt_bn_fwd_occupancy"):
        route = (plan.fwd_grid, plan.fwd_smem, plan.fwd_kept_rounds)
    _kernels.launch(lib, lib.mxt_bn_fwd, x, gamma, beta, rm, rv, y, mean,
                    var, stats, ws, m, c, plan.vec, plan.tpr, plan.splits,
                    plan.rows, code, code, code, 1, 0, cs.BN_EPS,
                    cs.BN_MOMENTUM, 1.0 - cs.BN_MOMENTUM, *route)
    return y, mean, var, stats, rm, rv


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
    """A variant without mxt_bn_bwd_occupancy (mxt_bn_fwd_occupancy): its
    mxt_bn_bwd (mxt_bn_fwd) takes the geometry and no launch plan."""
    if not hasattr(lib, "mxt_bn_bwd_occupancy"):
        lib.mxt_bn_bwd.argtypes = [_P] * 8 + [_I] * 11 + [_P]
    if not hasattr(lib, "mxt_bn_fwd_occupancy"):
        lib.mxt_bn_fwd.argtypes = [_P] * 10 + [_I] * 11 + [_F] * 3 + [_P]
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
                              gluon.loss.SoftmaxCrossEntropyLoss(), mesh=None,
                              lr=0.1, momentum=0.9, wd=1e-4,
                              compute_dtype="bfloat16")
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


def _shape_calls(kernel, designs, x, dy, gamma, beta, plan, dt):
    """For one shape: each design's call of ``kernel`` (checked against the
    plain version and for repeatability where the design is checked), the
    designs whose results equal the committed build's bit for bit, and
    aten's call."""
    c = x.shape[1]
    rm0 = torch.zeros(c, device="cuda")
    rv0 = torch.ones(c, device="cuda")
    stats = B.batch_norm_fwd(x, gamma, beta, rm0.clone(), rv0.clone(),
                             cs.BN_EPS, False, False)[3]
    if kernel == "fwd":
        rmp, rvp = rm0.clone(), rv0.clone()
        ref = B.batch_norm_fwd_plain(x, gamma, beta, rmp, rvp, cs.BN_EPS,
                                     False, False, cs.BN_MOMENTUM)[:3]
        ref += (rmp, rvp)
    else:
        ref = B.batch_norm_bwd_plain(x, dy, stats, gamma, beta, False, True)
    calls, first, same_as = {}, None, {}
    m = x.shape[0]
    for name, (lib, checked, streamed) in designs.items():
        if streamed and kernel == "fwd":  # K6a has the one route
            continue
        p = _streamed(m, c, dt) if streamed else plan
        if kernel == "fwd":
            def call(lib=lib, p=p, rm=rm0.clone(), rv=rv0.clone()):
                return _call_fwd(lib, x, gamma, beta, rm, rv, p)

            def fresh(lib=lib, p=p):
                return _call_fwd(lib, x, gamma, beta, rm0.clone(),
                                 rv0.clone(), p)
            got, again = fresh(), fresh()
            checked_parts = [got[i] for i in (0, 1, 2, 4, 5)]
        else:
            def call(lib=lib, p=p):
                return _call(lib, x, dy, stats, gamma, p)
            got, again = call(), call()
            checked_parts = list(got)
        errs = [cs._bn_err(g, r)[1] for g, r in zip(checked_parts, ref)]
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        if checked and (max(errs) > cs.BN_TOL[dt] or not same):
            raise AssertionError("%s %s at M %d C %d: errs %s, repeatable %s"
                                 % (name, kernel, x.shape[0], c, errs, same))
        calls[name] = call
        if first is None:
            first = got
        same_as[name] = all(torch.equal(a, b) for a, b in zip(got, first))
    w32, b32 = gamma.float(), beta.float()
    if kernel == "fwd":
        lrm, lrv = rm0.clone(), rv0.clone()
        calls["aten"] = lambda: torch.ops.aten.native_batch_norm(
            x, w32, b32, lrm, lrv, True, 1 - cs.BN_MOMENTUM, cs.BN_EPS)
    else:
        _, mean, invstd = torch.ops.aten.native_batch_norm(
            x, w32, b32, None, None, True, 0.1, cs.BN_EPS)
        calls["aten"] = lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, w32, None, None, mean, invstd, True, cs.BN_EPS,
            [True, True, True])
    return calls, same_as


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--kernel", default="both", choices=("fwd", "bwd",
                                                          "both"))
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--part", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--step", action="store_true")
    ap.add_argument("--streamed", action="store_true")
    args = ap.parse_args()
    dt = getattr(torch, args.dtype)
    kernels = ("fwd", "bwd") if args.kernel == "both" else (args.kernel,)
    smi = cs.environment()
    built = _kernels.build_variants("batch_norm", args.variant + args.part)
    # name -> (library, checked, on the streamed route at every shape)
    committed = _kernels.library("batch_norm")
    designs = {"committed": (committed, True, False)}
    if args.streamed:
        designs["streamed"] = (committed, True, True)
    for path in args.variant + args.part:
        designs[os.path.basename(path)] = (
            _earlier_interface(built[os.path.basename(path)]),
            path in args.variant, False)
    counts = {}
    for n, h, w, c in cs.resnet_bns():
        counts[(n * h * w, c)] = counts.get((n * h * w, c), 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    totals = {k: {} for k in kernels}
    for (m, c), n in counts.items():
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 0.5).to(dt)
        dy = torch.randn(m, c, device="cuda", generator=gen).to(dt)
        gamma = (1 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(dt)
        beta = (0.1 * torch.randn(c, device="cuda", generator=gen)).to(dt)
        plan = B.launch_plan(m, c, dt)
        for kernel in kernels:
            calls, same_as = _shape_calls(kernel, designs, x, dy, gamma,
                                          beta, plan, dt)
            order = list(calls) + list(calls)[::-1]
            ms = {k: [] for k in calls}
            for _ in range(args.rounds):
                for k in order:
                    ms[k].append(cs.graph_ms(calls[k], iters=10))
            best = {k: min(v) for k, v in ms.items()}
            bound = cs.bn_bound_ms(m, c, dt, 2 if kernel == "fwd" else 3)[0]
            for k, v in best.items():
                totals[kernel][k] = totals[kernel].get(k, 0.0) + n * v
            totals[kernel]["bound"] = (totals[kernel].get("bound", 0.0)
                                       + n * bound)
            if kernel == "fwd":
                route = "route streamed, %d rounds kept, grid %d" % (
                    plan.fwd_kept_rounds, plan.fwd_grid)
            else:
                route = "route %s, %d splits a block, grid %d" % (
                    plan.route, plan.splits_per_block, plan.bwd_grid)
            cs.log("bn_probe %s [M %d C %d %s, %d a step; committed %s; "
                   "bitwise equal to the committed build: %s]: in graph "
                   "replays (each turn, ms): %s; bound %.4f ms" % (
                       kernel, m, c, args.dtype, n, route,
                       ", ".join(k for k, v in same_as.items() if v),
                       ", ".join("%s %s (%.1f %% of the bound)" % (
                           k, "/".join("%.4f" % t for t in v),
                           100.0 * bound / best[k]) for k, v in ms.items()),
                       bound))
            del calls
        del x, dy
        torch.cuda.empty_cache()
    for kernel in kernels:
        cs.log("bn_probe on %s: %s over the %d BatchNorms of a ResNet-50 "
               "step at batch %d in %s, the best turn of each: %s" % (
                   smi, {"fwd": "K6a", "bwd": "K6b"}[kernel],
                   sum(counts.values()), cs.RESNET_BATCH, args.dtype,
                   ", ".join("%s %.3f ms" % kv
                             for kv in totals[kernel].items())))
    if args.step:
        step_routes(args.rounds, smi)


if __name__ == "__main__":
    main()

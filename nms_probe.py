"""K7, box_nms's greedy keep set, by part on one NVIDIA GPU, beside
earlier designs of it.

    python3 nms_probe.py [--variant FILE.cu ...] [--part FILE.cu ...]
                         [--mask-design FILE.cu ...] [--skip-committed]
                         [--rounds N]

Four cases at MultiBoxDetection's shape, 32 images of 8,732 rows made as
chip_smoke.py phase 3e makes them (boxes around 24 centres an image, 30 %
of the scores -1): "detect" (20 classes, by class), "force_suppress"
(every row one class), "skewed" (80 % of the rows one class of the 20)
and "80 classes".  For each build of csrc/box_nms.cu -- the committed one
(ops/box_nms.py nms_keep: the scan, which sorts by class, and the walk),
each ``--variant`` (another version of the source with the committed C
interface, run through nms_keep) and each ``--mask-design`` (a source
of the earlier mask design's interface, ``git show
898d599:mxnet_tpu_torch/csrc/box_nms.cu``, run through its one entry
with the B x limit x ceil(limit/64)-word mask it takes):

- its keep set against the plain version (bitwise; a build that differs
  fails the run);
- its time a call, CUDA events around 10 calls (chip_smoke.time_ms), in
  turns (committed, the others, the others, committed), ``--rounds``
  times;
- the device time a call of each of its kernels, from one torch.profiler
  session over all builds and cases, a marker kernel (torch.cuda._sleep)
  before each: the scan and the walk (the mask design's mask pass and
  walk),
  and any other kernel of the call;
- the scratch bytes it allocates (launch_plan's; the mask design's
  mask), the
  peak memory a call adds (torch.cuda.max_memory_allocated), the kept
  rows an image and, for the committed build, the plan's route and walk
  grid.

Each ``--part`` is a variant timed without the check (say, a copy
without its divisions, to see what the rest costs).  ``--skip-committed``
checks the committed build but neither times nor profiles it (say, to
time the mask design alone first).  Every time is printed beside the
card's name and power limit and the bound (chip_smoke.nms_bound_ms).
Without a CUDA device the script exits 1.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

import chip_smoke as cs
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.ops import box_nms as K
from mxnet_tpu_torch.ops import contrib as Cb

B, N = cs.SSD_BATCH, cs.SSD_ANCHORS
# (name, box_nms keywords, classes, share of the rows given class 0)
CASES = [("detect", dict(id_index=0), cs.SSD_CLASSES, 0.0),
         ("force_suppress", dict(id_index=0, force_suppress=True),
          cs.SSD_CLASSES, 0.0),
         ("skewed", dict(id_index=0), cs.SSD_CLASSES, 0.8),
         ("80 classes", dict(id_index=0), 80, 0.0)]
# a device kernel's part, by the first key its name holds
PARTS = (("scan", "nms_scan_kernel"), ("walk", "nms_walk_kernel"),
         ("mask", "nms_mask_kernel"))


def _mask_entry(lib):
    """The one entry of a build of the mask design: it takes a mask."""
    fn = lib.mxt_box_nms
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    return fn


def _caller(lib, mask_design, boxes, n_valid, ids):
    """(the call, its scratch bytes) of a build (``mask_design``: of the
    mask design's C interface)."""
    b, n = boxes.shape[:2]
    if not mask_design:
        def call():
            saved = _kernels._libs["box_nms"]
            _kernels._libs["box_nms"] = lib
            try:
                return K.nms_keep(boxes, n_valid, cs.SSD_NMS, ids)
            finally:
                _kernels._libs["box_nms"] = saved

        plan = K.launch_plan(b, n, -1, ids is not None,
                             K._sm_count(boxes.device.index))
        return call, plan.scratch_bytes
    fn = _mask_entry(lib)
    words = -(-n // 64)
    mask = torch.empty(b * n * words, dtype=torch.int64, device="cuda")

    def call():
        keep = torch.empty((b, n), dtype=torch.bool, device="cuda")
        _kernels.launch(lib, fn, boxes, ids, n_valid, mask, keep, b, n, n,
                        float(cs.SSD_NMS))
        return keep

    return call, mask.numel() * 8


def _parts(runs):
    """Device us a call of each part of each (label, call, calls) run,
    from one profiler session; None where the trace lost the markers."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)  # the session's first events can be lost
        for _label, call, calls in runs:
            torch.cuda._sleep(1000)
            for _ in range(calls):
                call()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [i for i, (_, _, name) in enumerate(spans)
             if "spin_kernel" in name]
    if len(marks) < len(runs) + 1:
        return None
    marks = marks[-(len(runs) + 1):]
    out = {}
    for (label, _call, calls), lo, hi in zip(runs, marks, marks[1:]):
        parts = {}
        for t0, t1, name in spans[lo + 1:hi]:
            part = next((p for p, key in PARTS if key in name), "other")
            parts[part] = parts.get(part, 0.0) + (t1 - t0) / calls
        out[label] = parts
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--part", action="append", default=[])
    ap.add_argument("--mask-design", action="append", default=[])
    ap.add_argument("--skip-committed", action="store_true")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = cs.environment()
    libs = {"committed": _kernels.library("box_nms")}
    libs.update(_kernels.build_variants(
        "box_nms", args.variant + args.part + args.mask_design))
    parts = {p.rsplit("/", 1)[-1] for p in args.part}
    masks = {p.rsplit("/", 1)[-1] for p in args.mask_design}
    timed = [k for k in libs if not (args.skip_committed
                                     and k == "committed")]
    gen = torch.Generator(device="cuda").manual_seed(12)
    runs = []
    for case, kw, classes, skew in CASES:
        data = cs._nms_rows(gen, B, N, classes=classes)
        if skew:
            one = torch.rand((B, N), device="cuda", generator=gen) < skew
            data[:, :, 0] = torch.where(one, torch.zeros_like(data[:, :, 0]),
                                        data[:, :, 0])
        _, boxes, n_valid, ids = Cb.nms_inputs(data, **kw)
        ref = K.nms_keep_plain(boxes, n_valid, cs.SSD_NMS, ids)
        bound, bound_by = cs.nms_bound_ms(B, N, n_valid, ref, ids)
        plan = K.launch_plan(B, N, -1, ids is not None,
                             K._sm_count(boxes.device.index))
        calls, rows = {}, []
        for name, lib in libs.items():
            call, scratch = _caller(lib, name in masks, boxes, n_valid, ids)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            if name not in parts and not torch.equal(got, ref):
                raise AssertionError("%s's keep set differs from the plain "
                                     "version at %s" % (name, case))
            kept = got.sum(1)
            rows.append("%s: %s, kept %d-%d an image, scratch %d bytes, peak "
                        "%d bytes a call" % (
                            name, "unchecked" if name in parts else
                            "bitwise equal to the plain version",
                            int(kept.min()), int(kept.max()), scratch, peak))
            if name in timed:
                calls[name] = call
                runs.append(("%s / %s" % (case, name), call, 3))
        cs.log("nms_probe %s on %s: (%d, %d), %d-%d valid rows an image, "
               "%s route, walk grid %s of %d threads; bound %.4f ms (%s)"
               % (case, smi, B, N, int(n_valid.min()), int(n_valid.max()),
                  plan.route, plan.grid, plan.threads, bound, bound_by))
        for line in rows:
            cs.log("  " + line)
        order = list(calls) + list(calls)[::-1]
        times = {name: [] for name in calls}
        for _ in range(args.rounds):
            for name in order:
                times[name].append(cs.time_ms(calls[name], iters=10))
        for name, ts in times.items():
            cs.log("  %s: %s ms a call (CUDA events, in turns), %.2f %% of "
                   "the bound" % (name, ", ".join("%.4f" % t for t in ts),
                                  100 * bound / min(ts)))
    by_part = _parts(runs)
    if by_part is None:
        cs.log("nms_probe: the profiler trace lost its markers: parts not "
               "measured")
        return
    for label, p in by_part.items():
        cs.log("nms_probe parts, %s: %s; device %.1f us a call" % (
            label, ", ".join("%s %.1f us" % kv for kv in sorted(p.items())),
            sum(p.values())))


if __name__ == "__main__":
    main()

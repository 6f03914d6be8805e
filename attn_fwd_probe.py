"""What the attention forward kernel K3 takes on one NVIDIA GPU, beside
variant builds of it.

    python3 attn_fwd_probe.py [--dtype float32|bfloat16|float16 ...]
                              [--head-dim D] [--non-causal]
                              [--variant FILE.cu ...] [--part FILE.cu ...]
                              [--rounds N]

Times csrc/flash_attn_fwd.cu at the TransformerLM's serving and training
shape (B=8, H=8, S=1024, causal unless --non-causal; D=64 unless
--head-dim says otherwise) in
each dtype (all three by default) beside the plain version, SDPA and the
bound.  --variant builds another source of the same C interface (a copy
of the committed one with a design changed, compiled with csrc on the
include path).  Every build is first held to the plain version within
chip_smoke.py's TOL (lse within 1e-4), then timed in turns with the
committed one (committed, variants, variants, committed), --rounds times
over (1 by default).
--part does the same without the check, for a source that leaves work
out on purpose (the exponentials, say) to show what the rest costs.
A time is the mean of a run of launches between CUDA events, each launch
the C entry point called directly (the wrapper's host work left out), and
the same launches' mean kernel time from torch.profiler; both are printed
beside the card's name and power limit.  Without a CUDA device the script
exits 1.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.nn.functional as F

import chip_smoke as cs
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.ops import attention as A


def device_ms(fn, iters):
    """The mean device time of the K3 kernels torch.profiler kept over
    ``iters`` calls of ``fn`` (a trace may drop some of a run of short
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "flash_fwd" in e.name]
    if not spans:
        raise AssertionError("the profiler saw no K3 kernel")
    return sum(spans) / len(spans) / 1e3


def kernel_ms(fn, iters=50):
    """(events, device): the mean time of a launch between CUDA events,
    and the mean time of the kernels torch.profiler saw in those launches."""
    return cs.time_ms(fn, iters=iters), device_ms(fn, iters)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", action="append", default=[])
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--non-causal", action="store_true")
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--part", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    smi = cs.environment()
    committed = _kernels.library("flash_attn_fwd")
    variants = _kernels.build_variants("flash_attn_fwd",
                                       args.variant + args.part)
    unchecked = {os.path.basename(p) for p in args.part}
    libs = {"committed": committed, **variants}
    b, h, s, d = cs.TRAIN_BATCH, cs.HEADS, cs.SEQ, args.head_dim
    causal = not args.non_causal
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.dtype or ("float32", "bfloat16", "float16"):
        dt = getattr(torch, name)
        q, k, v = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                   .to(dt) for _ in range(3))
        ref, ref_lse = A.mha_reference(q, k, v, causal=causal,
                                       return_lse=True)
        plan = A.fwd_launch_plan(d, dt)
        bound, bound_by = cs.attention_bound_ms(b, h, s, s, d, causal, dt)
        lib_ms = cs.time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        wrapper_ms = cs.time_ms(lambda: A.flash_attention(q, k, v,
                                                          causal=causal))
        cs.log("attn_fwd_probe on %s: B=%d H=%d S=%d D=%d causal=%s %s, "
               "plan %s; bound %.4f ms (%s); flash_attention (wrapper) %.4f "
               "ms, sdpa %.4f ms" % (smi, b, h, s, d, causal, name,
                                     tuple(plan), bound, bound_by,
                                     wrapper_ms, lib_ms))
        times = {lib: [] for lib in libs}
        for lib_name in (list(libs) + list(libs)[::-1]) * args.rounds:
            run = cs.fwd_launch(q, k, v, causal, libs[lib_name])
            out, lse = run.outputs
            run()
            torch.cuda.synchronize()
            tol = cs.TOL[dt]
            if lib_name not in unchecked and not (
                    torch.allclose(out.float(), ref.float(), rtol=tol,
                                   atol=tol)
                    and (lse - ref_lse).abs().max().item() <= 1e-4):
                raise AssertionError("%s disagrees with the plain version in "
                                     "%s" % (lib_name, name))
            times[lib_name].append(kernel_ms(run))
        for lib_name, t in times.items():
            best = min(dev for _, dev in t)
            cs.log("  %s%s: events %s ms, kernel (profiler) %s ms; %.1f %% "
                   "of the bound, %.2fx sdpa" % (
                       lib_name,
                       " (unchecked)" if lib_name in unchecked else "",
                       " ".join("%.4f" % e for e, _ in t),
                       " ".join("%.4f" % x for _, x in t), 100 * bound / best,
                       best / lib_ms))
        del q, k, v, ref, ref_lse, run, out, lse
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

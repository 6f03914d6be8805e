"""What the attention backward kernels K4a (dQ) and K4b (dK/dV) take on one
NVIDIA GPU, beside variant sources of the same C interface.

    python3 attn_bwd_probe.py [--dtype float32|bfloat16|float16 ...]
                              [--head-dim D] [--variant FILE.cu ...]
                              [--part FILE.cu ...]

Times csrc/flash_attn_bwd.cu at the TransformerLM's training shape (B=8,
H=8, S=1024, causal; D=64 unless --head-dim says otherwise) in each dtype
(all three by default), each kernel held to the plain backward within
chip_smoke.py's BWD_TOL first; beside them the plain backward, SDPA's
backward and each kernel's bound.  --variant builds another source of the
same C interface (an earlier version, another tiling) beside it, checks it
the same way and times it in turns with the committed one (committed,
variants, variants, committed).  --part does the same without the check,
for a source that leaves work out on purpose (the second products, say) to
show what the rest costs.  Times are CUDA-event means (chip_smoke.time_ms),
printed beside the card's name and power limit.  Without a CUDA device the
script exits 1.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.nn.functional as F

import chip_smoke as cs
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.ops import attention as A


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", action="append", default=[])
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--part", action="append", default=[])
    args = ap.parse_args()
    smi = cs.environment()
    committed = _kernels.library("flash_attn_bwd")
    variants = _kernels.build_variants("flash_attn_bwd",
                                       args.variant + args.part)
    unchecked = {os.path.basename(p) for p in args.part}
    libs = {"committed": committed, **variants}
    b, h, s, d = cs.TRAIN_BATCH, cs.HEADS, cs.SEQ, args.head_dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name in args.dtype or ("float32", "bfloat16", "float16"):
        dt = getattr(torch, name)
        q, k, v, do = (torch.randn(b, h, s, d, device="cuda", generator=gen)
                       .to(dt) for _ in range(4))
        o, lse = A.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = A._bwd_delta(o, do)
        ref = A.flash_attention_bwd_reference(q, k, v, o, lse, do, True)
        plan = A.bwd_launch_plan(d, dt)
        bounds = {kern: cs.attention_bwd_bound_ms(kern, b, h, s, s, d, True,
                                                  dt)[0]
                  for kern in ("dq", "dkv")}
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_ms = cs.time_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
        plain_ms = cs.time_ms(lambda: A.flash_attention_bwd_reference(
            q, k, v, o, lse, do, True), iters=5)
        cs.log("attn_bwd_probe on %s: B=%d H=%d S=%d D=%d causal %s, plan %s;"
               " bounds dq %.4f dkv %.4f ms; plain backward %.4f ms, sdpa "
               "backward %.4f ms" % (smi, b, h, s, d, name, tuple(plan),
                                     bounds["dq"], bounds["dkv"], plain_ms,
                                     lib_ms))
        scale = 1.0 / d ** 0.5
        code = A._DTYPE_CODES[dt]
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        times = {lib: {"dq": [], "dkv": []} for lib in libs}
        for lib_name in list(libs) + list(libs)[::-1]:
            lib = libs[lib_name]

            def run_dq():
                _kernels.launch(lib, lib.mxt_flash_attn_bwd_dq, q, k, v, do,
                                lse, delta, dq, b * h, s, s, d, scale, 1,
                                code)

            def run_dkv():
                _kernels.launch(lib, lib.mxt_flash_attn_bwd_dkv, q, k, v, do,
                                lse, delta, dk, dv, b * h, s, s, d, scale, 1,
                                code)

            run_dq()
            run_dkv()
            torch.cuda.synchronize()
            tol = cs.BWD_TOL[dt]
            if lib_name not in unchecked and not all(
                    torch.allclose(g.float(), r.float(), rtol=tol, atol=tol)
                    for g, r in zip((dq, dk, dv), ref)):
                raise AssertionError("%s disagrees with the plain backward in "
                                     "%s" % (lib_name, name))
            times[lib_name]["dq"].append(cs.time_ms(run_dq))
            times[lib_name]["dkv"].append(cs.time_ms(run_dkv))
        for lib_name, t in times.items():
            cs.log("  %s%s: dq %s ms, dkv %s ms; the pair %.4f ms (%.1f %% of "
                   "its bound)" % (
                       lib_name, " (unchecked)" if lib_name in unchecked else "",
                       " ".join("%.4f" % x for x in t["dq"]),
                       " ".join("%.4f" % x for x in t["dkv"]),
                       min(t["dq"]) + min(t["dkv"]),
                       100 * (bounds["dq"] + bounds["dkv"])
                       / (min(t["dq"]) + min(t["dkv"]))))
        del q, k, v, do, o, lse, delta, ref, dq, dk, dv, ql, kl, vl, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

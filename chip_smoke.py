"""Drive the PyTorch port's serving path on one NVIDIA GPU and hold its
kernels against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the script exits non-zero):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under mxnet_tpu_torch/csrc, compiled by nvcc;
3. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the serving path gives it and at edge shapes, with its time,
   the plain version's, one PyTorch library call's, and the bound;
4. serve: the full-width TransformerLM (vocab 32000, units 512, 4 layers,
   8 heads, S=1024) behind the InferenceServer (buckets 1/2/4/8), a dozen
   concurrent requests of 1-8 samples plus one with an out-of-range token;
   every served row is held against an unbatched forward, and the logits
   of a short input against the same weights run by the plain path on the
   CPU; the kernel's launch count must match the batches served.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its numbers.  Without a CUDA device the script
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 tensor cores
PEAK_BYTES = 3.35e12            # HBM3

VOCAB, UNITS, LAYERS, HEADS, SEQ = 32000, 512, 4, 8, 1024
BUCKETS = (1, 2, 4, 8)
REQUEST_SAMPLES = (1, 2, 3, 4, 5, 6, 7, 8, 3, 5, 2, 7)

# kernel vs plain: float32 sums run in another order (~1e-6 at S=1024);
# bf16 output is rounded in both and the plain version also rounds the
# probabilities to bf16, so they may differ by about two bf16 steps
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# served rows vs an unbatched forward, and card vs CPU plain path: the
# matrix products pick other algorithms per batch size and device
SERVE_TOL = 1e-4


def log(*args):
    print(*args, flush=True)


def environment():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("nvidia-smi:", smi)
    log("python %s  torch %s  cuda %s  device %s  count %d" % (
        sys.version.split()[0], torch.__version__, torch.version.cuda,
        torch.cuda.get_device_name(0), torch.cuda.device_count()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build():
    from mxnet_tpu_torch import _kernels

    t0 = time.perf_counter()
    names = _kernels.build_all()
    log("build: %s in %.1f s" % (names, time.perf_counter() - t0))
    for name in names:
        for line in (_kernels.build_log(name) or "").splitlines():
            if "registers" in line or "spill" in line:
                log("  %s: %s" % (name, line.strip()))


def time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, h, sq, sk, d, causal, dtype):
    """Least time for the work: each of q, k, v, o read or written once
    (and lse), against 4*D flops per unmasked (row, col) pair at the
    card's rate for the kernel's arithmetic (float32 on the CUDA cores;
    bf16 inputs could run on the tensor cores)."""
    pairs = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    flops = 4.0 * b * h * d * pairs
    esize = torch.finfo(dtype).bits // 8
    nbytes = b * h * d * (2 * sq + 2 * sk) * esize + b * h * sq * 4
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernels(seed):
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.attention import flash_attention, mha_reference

    cases = [  # (name, B, H, Sq, Sk, D, causal, dtype)
        ("bucket 1", 1, 8, SEQ, SEQ, 64, True, torch.float32),
        ("bucket 2", 2, 8, SEQ, SEQ, 64, True, torch.float32),
        ("bucket 4", 4, 8, SEQ, SEQ, 64, True, torch.float32),
        ("bucket 8", 8, 8, SEQ, SEQ, 64, True, torch.float32),
        ("non-causal", 8, 8, SEQ, SEQ, 64, False, torch.float32),
        ("ragged S=1000", 8, 8, 1000, 1000, 64, True, torch.float32),
        ("Sq=256 Sk=512", 8, 8, 256, 512, 64, True, torch.float32),
        ("bf16", 8, 8, SEQ, SEQ, 64, True, torch.bfloat16),
        ("D=128", 8, 4, SEQ, SEQ, 128, True, torch.float32),
    ]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    slice_row = None
    for name, b, h, sq, sk, d, causal, dt in cases:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dt)
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = mha_reference(q, k, v, causal=causal, return_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL[dt]
        ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol) \
            and lse_err <= 1e-4
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        plain_ms = time_ms(lambda: mha_reference(q, k, v, causal=causal))
        # SDPA's causal mask is top-left aligned too
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        bound, bound_by = attention_bound_ms(b, h, sq, sk, d, causal, dt)
        log("kernel flash_attn_fwd [%s] B=%d H=%d Sq=%d Sk=%d D=%d causal=%s "
            "%s: max_abs_err %.3g (tol %.0e abs+rel), lse err %.3g; "
            "kernel %.4f ms, plain %.4f ms, sdpa %.4f ms, bound %.4f ms (%s)"
            % (name, b, h, sq, sk, d, causal, str(dt).split(".")[1], err,
               tol, lse_err, ms, plain_ms, lib_ms, bound, bound_by))
        if not ok:
            raise AssertionError("flash_attn_fwd disagrees with its plain "
                                 "version at %s" % name)
        if name == "bucket 8":  # the slice's largest attention shape
            slice_row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": bound_by,
                         "library_ms": lib_ms}
        del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()
    return slice_row


def serve(seed, smi):
    from mxnet_tpu_torch.convert import load_mxnet_tpu_params
    from mxnet_tpu_torch.gluon.nn import TransformerLM
    from mxnet_tpu_torch.ops.attention import flash_attention
    from mxnet_tpu_torch.serving import InferenceServer, RequestRejected

    t0 = time.perf_counter()
    net = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                        num_heads=HEADS, device="cuda").initialize(seed=seed)
    torch.cuda.synchronize()
    log("serve: TransformerLM vocab %d units %d layers %d heads %d, %d "
        "parameters, built in %.1f s" % (
            VOCAB, UNITS, LAYERS, HEADS,
            sum(p.numel() for p in net.parameters()),
            time.perf_counter() - t0))
    rng = np.random.RandomState(seed)
    requests = [rng.randint(0, VOCAB, size=(n, SEQ)).astype(np.float32)
                for n in REQUEST_SAMPLES]
    bad = rng.randint(0, VOCAB, size=(2, SEQ)).astype(np.float32)
    bad[1, 17] = VOCAB + 5  # out of range: a NaN row, then the sentinel

    # ---- the main path: the counts run from 0 over warmup and serving
    flash_attention.launches = 0
    srv = InferenceServer(net, {"data": (SEQ,)}, buckets=BUCKETS,
                          device="cuda").start()
    t0 = time.perf_counter()
    srv.warmup()
    log("serve: warmup of buckets %s in %.2f s" % (BUCKETS,
                                                  time.perf_counter() - t0))
    results = [None] * len(requests)
    futures = [None] * len(requests)
    bad_outcome = []

    def client(i):
        futures[i] = srv.submit(requests[i])
        results[i] = futures[i].result(600)

    def bad_client():
        try:
            srv.infer(bad, timeout=600)
            bad_outcome.append("served")
        except RequestRejected as e:
            bad_outcome.append("rejected: %s" % e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(requests))]
    threads.append(threading.Thread(target=bad_client))
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t_start
    srv.stop()
    launches = flash_attention.launches
    snap = srv.snapshot()
    # ---- end of the main path
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("not every request was served")
    if not (bad_outcome and bad_outcome[0].startswith("rejected")):
        raise AssertionError("the out-of-range token was not rejected: %s"
                             % bad_outcome)
    expected = LAYERS * (len(BUCKETS) + snap["batches"])
    log("serve: %s" % json.dumps(snap))
    log("serve: flash_attn_fwd launches %d, expected %d (layers x (warmup "
        "buckets + batches))" % (launches, expected))
    if launches != expected:
        raise AssertionError("the serving path did not run the kernel once "
                             "per layer per batch")

    e2e = sorted((f.t_done - f.t_submit) * 1e3 for f in futures)
    served_tokens = sum(REQUEST_SAMPLES) * SEQ
    log("serve: %d requests (%d samples, %d tokens) in %.3f s on %s: "
        "latency p50 %.1f ms p99 %.1f ms, %.0f tokens/s" % (
            len(requests), sum(REQUEST_SAMPLES), served_tokens, wall, smi,
            float(np.percentile(e2e, 50)), float(np.percentile(e2e, 99)),
            served_tokens / wall))

    worst = 0.0
    with torch.inference_mode():
        for x, out in zip(requests, results):
            ref = net(torch.from_numpy(x).cuda()).cpu().numpy()
            got = out[0]
            if got.shape != (x.shape[0], SEQ, VOCAB) \
                    or not np.isfinite(got).all():
                raise AssertionError("served output has shape %s or "
                                     "non-finite values" % (got.shape,))
            worst = max(worst, float(np.abs(got - ref).max()))
            np.testing.assert_allclose(got, ref, rtol=SERVE_TOL,
                                       atol=SERVE_TOL)
    log("serve: every served row matches an unbatched forward (max abs "
        "err %.3g, tol %.0e)" % (worst, SERVE_TOL))

    # where a bucket-8 batch spends its time: the forward on the card
    # (CUDA events) and the one host sync, the logits' copy to the host
    x8 = torch.from_numpy(requests[REQUEST_SAMPLES.index(8)]).cuda()
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: net(x8), iters=5)
        logits = net(x8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits.cpu()
        copy_ms = (time.perf_counter() - t0) * 1e3
    log("serve: bucket 8 on %s: forward %.2f ms (%d attention launches), "
        "logits host copy %.1f ms for %.2f GB" % (
            smi, fwd_ms, LAYERS, copy_ms, logits.numel() * 4 / 1e9))
    del logits

    # the same weights through the plain path on the CPU, at a short input
    cpu_net = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                            num_heads=HEADS, device="cpu")
    load_mxnet_tpu_params(cpu_net, {k: v.detach().cpu().numpy() for k, v
                                    in net.state_dict().items()})
    x = torch.from_numpy(requests[1][:, :128].copy())
    with torch.inference_mode():
        got = net(x.cuda()).cpu()
        ref = cpu_net(x)
    err = (got - ref).abs().max().item()
    log("serve: card vs CPU plain path on a (2, 128) input: max abs err "
        "%.3g (tol %.0e)" % (err, SERVE_TOL))
    torch.testing.assert_close(got, ref, rtol=SERVE_TOL, atol=SERVE_TOL)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = environment()
    build()
    row = kernels(args.seed)
    launches = serve(args.seed, smi)
    entry = {"name": "flash_attn_fwd", "route": "cuda",
             "source": "mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
             "replaces": "mxnet_tpu/ops/attention.py:63",
             "launches": launches}
    entry.update(row)
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

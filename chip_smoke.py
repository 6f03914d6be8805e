"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and hold its kernels against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the script exits non-zero):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under mxnet_tpu_torch/csrc, compiled by nvcc;
3. kernels: the attention forward (K3) against its plain PyTorch version
   on the card at the shapes the serving path gives it and at edge shapes,
   with its time, the plain version's, one PyTorch library call's, and the
   bound;
3b. backward kernels: dQ (K4a) and dK/dV (K4b) against the plain backward
   at the training shape and the same edge shapes, bitwise equal across
   two launches, with their times, the plain backward's, SDPA's backward
   and the bounds;
4. serve: the full-width TransformerLM (vocab 32000, units 512, 4 layers,
   8 heads, S=1024) behind the InferenceServer (buckets 1/2/4/8), a dozen
   concurrent requests of 1-8 samples plus one with an out-of-range token;
   every served row is held against an unbatched forward, and the logits
   of a short input against the same weights run by the plain path on the
   CPU; the kernel's launch count must match the batches served;
5. train: the same model on the card, first one record/backward on a
   (2, 128) batch whose every parameter gradient is held against the same
   weights' gradients on the CPU plain path, then 10 Adam steps on one
   fixed (8, 1024) batch through autograd.record, SoftmaxCrossEntropyLoss,
   autograd.backward and gluon.Trainer: a finite loss that falls, and K3,
   K4a and K4b each launched once per layer per step; the step time, split
   into forward, backward and optimizer; then 3 more steps under
   torch.profiler for the device's busy share and its time by kernel group.

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
# backward kernels vs the plain backward: f32 as tests/test_attention.py
# holds JAX's backward kernels; bf16 gradients are rounded in both, so a
# float32 sum in another order may land one bf16 step (2**-8 relative)
# away (measured on the H100: 0 at the training shape, 2.4e-4 at a small
# one)
BWD_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2}
# served rows vs an unbatched forward, and card vs CPU plain path: the
# matrix products pick other algorithms per batch size and device
SERVE_TOL = 1e-4
# every parameter gradient on the card within this share of that
# gradient's largest magnitude on the CPU plain path
GRAD_TOL = 1e-3
TRAIN_BATCH, TRAIN_STEPS, WARMUP_STEPS = 8, 10, 2


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


def attention_bwd_bound_ms(kernel, b, h, sq, sk, d, causal, dtype):
    """Least time for one backward kernel: q, k, v, dO, lse and delta
    read once and its gradients written once, against its flops per
    unmasked (row, col) pair: 6*D for dQ (s, dp, dQ), 8*D for dK/dV (s,
    dV, dp, dK)."""
    pairs = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    flops = (6.0 if kernel == "dq" else 8.0) * b * h * d * pairs
    esize = torch.finfo(dtype).bits // 8
    written = sq if kernel == "dq" else 2 * sk
    nbytes = b * h * (d * (2 * sq + 2 * sk + written) * esize + 2 * sq * 4)
    peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# the shapes at which the attention kernels are held against their plain
# versions: (name, B, H, Sq, Sk, D, causal, dtype)
EDGE_CASES = [
    ("non-causal", 8, 8, SEQ, SEQ, 64, False, torch.float32),
    ("ragged S=1000", 8, 8, 1000, 1000, 64, True, torch.float32),
    ("Sq=256 Sk=512", 8, 8, 256, 512, 64, True, torch.float32),
    ("bf16", 8, 8, SEQ, SEQ, 64, True, torch.bfloat16),
    ("D=128", 8, 4, SEQ, SEQ, 128, True, torch.float32),
]


def kernels(seed):
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.attention import flash_attention, mha_reference

    cases = [("bucket %d" % b, b, 8, SEQ, SEQ, 64, True, torch.float32)
             for b in BUCKETS] + EDGE_CASES
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


def backward_kernels(seed):
    """Phase 3b: K4a and K4b against the plain backward; returns the
    training shape's row for each kernel."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import attention as A

    cases = [("train", TRAIN_BATCH, HEADS, SEQ, SEQ, 64, True,
              torch.float32)] + EDGE_CASES
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = {}
    for name, b, h, sq, sk, d, causal, dt in cases:
        q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen)
                   .to(dt) for n in (sq, sk, sk))
        do = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dt)
        o, lse = A.flash_attention(q, k, v, causal=causal, return_lse=True)
        delta = A._bwd_delta(o, do)

        def dq_fn():
            return A.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal)

        def dkv_fn():
            return A.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal)

        got = (dq_fn(),) + dkv_fn()
        again = (dq_fn(),) + dkv_fn()
        torch.cuda.synchronize()
        ref = A.flash_attention_bwd_reference(q, k, v, o, lse, do, causal)
        tol = BWD_TOL[dt]
        errs = [(g.float() - r.float()).abs().max().item()
                for g, r in zip(got, ref)]
        ok = all(torch.allclose(g.float(), r.float(), rtol=tol, atol=tol)
                 for g, r in zip(got, ref))
        same = all(torch.equal(a, b_) for a, b_ in zip(got, again))
        del got, again, ref
        dq_ms, dkv_ms = time_ms(dq_fn), time_ms(dkv_fn)
        plain_ms = time_ms(lambda: A.flash_attention_bwd_reference(
            q, k, v, o, lse, do, causal), iters=5)
        # SDPA's backward alone, timed only: the port never calls it;
        # autograd.grad returns the gradients and adds into no .grad
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            out, (ql, kl, vl), do, retain_graph=True))
        del ql, kl, vl, out
        bounds = {kern: attention_bwd_bound_ms(kern, b, h, sq, sk, d, causal,
                                               dt) for kern in ("dq", "dkv")}
        log("kernel flash_attn_bwd [%s] B=%d H=%d Sq=%d Sk=%d D=%d causal=%s "
            "%s: max_abs_err dq %.3g dk %.3g dv %.3g (tol %.0e abs+rel), "
            "bitwise repeatable %s; dq %.4f ms (bound %.4f, %s), dkv %.4f ms "
            "(bound %.4f, %s), plain backward %.4f ms, sdpa backward %.4f ms"
            % (name, b, h, sq, sk, d, causal, str(dt).split(".")[1],
               errs[0], errs[1], errs[2], tol, same, dq_ms, bounds["dq"][0],
               bounds["dq"][1], dkv_ms, bounds["dkv"][0], bounds["dkv"][1],
               plain_ms, lib_ms))
        if not ok:
            raise AssertionError("the backward kernels disagree with the "
                                 "plain backward at %s" % name)
        if not same:
            raise AssertionError("two launches of the backward kernels gave "
                                 "different gradients at %s" % name)
        if name == "train":
            for kern, ms, err in (("dq", dq_ms, errs[0]),
                                  ("dkv", dkv_ms, max(errs[1:]))):
                rows[kern] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms,
                              "bound_ms": bounds[kern][0],
                              "bound_by": bounds[kern][1],
                              "library_ms": lib_ms}
        del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()
    return rows


def _lm(device, seed=None):
    from mxnet_tpu_torch.gluon.nn import TransformerLM

    net = TransformerLM(VOCAB, units=UNITS, num_layers=LAYERS,
                        num_heads=HEADS, device=device)
    return net if seed is None else net.initialize(seed=seed)


def _cpu_copy(net):
    """The same weights in a model on the CPU (the plain path)."""
    from mxnet_tpu_torch.convert import load_mxnet_tpu_params

    return load_mxnet_tpu_params(_lm("cpu"), {
        k: v.detach().cpu().numpy() for k, v in net.state_dict().items()})


def serve(seed, smi):
    from mxnet_tpu_torch.ops.attention import flash_attention
    from mxnet_tpu_torch.serving import InferenceServer, RequestRejected

    t0 = time.perf_counter()
    net = _lm("cuda", seed)
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
    cpu_net = _cpu_copy(net)
    x = torch.from_numpy(requests[1][:, :128].copy())
    with torch.inference_mode():
        got = net(x.cuda()).cpu()
        ref = cpu_net(x)
    err = (got - ref).abs().max().item()
    log("serve: card vs CPU plain path on a (2, 128) input: max abs err "
        "%.3g (tol %.0e)" % (err, SERVE_TOL))
    torch.testing.assert_close(got, ref, rtol=SERVE_TOL, atol=SERVE_TOL)
    return launches


def _grads(net, x, y):
    from mxnet_tpu_torch import autograd, gluon

    with autograd.record():
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    autograd.backward(loss)
    return {k: p.grad for k, p in net.collect_params().items()}


def train(seed, smi):
    """Phase 5: the gradient check against the CPU plain path, then the
    main path, 10 Adam steps, then a profiled window of 3 more; returns
    the kernels' launch counts on the main path."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.ops import attention as A

    net = _lm("cuda", seed)
    rng = np.random.RandomState(seed + 2)

    # 1. every parameter's gradient on the card against the CPU plain path
    cpu_net = _cpu_copy(net)
    x = torch.from_numpy(rng.randint(0, VOCAB, (2, 128)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, VOCAB, (2, 128)).astype(np.float32))
    got = _grads(net, x.cuda(), y.cuda())
    want = _grads(cpu_net, x, y)
    worst, worst_name = 0.0, None
    for name, g in want.items():
        if got[name] is None:
            raise AssertionError("no gradient on the card for %s" % name)
        scale = g.abs().max().item()
        rel = (got[name].cpu() - g).abs().max().item() / max(scale, 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    qkv = got["encoder.layers.0.attn.qkv.weight"].abs().max().item()
    log("train: gradients of %d parameters on the card vs the CPU plain "
        "path on a (2, 128) batch: worst %.3g of the gradient's largest "
        "magnitude (%s; tol %.0e); |d qkv.weight| max %.3g" % (
            len(want), worst, worst_name, GRAD_TOL, qkv))
    if worst > GRAD_TOL or qkv == 0:
        raise AssertionError("the card's gradients disagree with the CPU "
                             "plain path")
    del cpu_net, got, want
    net.zero_grad()

    # 2. the main path: 10 Adam steps on one fixed batch
    x = torch.from_numpy(rng.randint(0, VOCAB, (TRAIN_BATCH, SEQ))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, VOCAB, (TRAIN_BATCH, SEQ))
                         .astype(np.float32)).cuda()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
              for _ in range(TRAIN_STEPS)]
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    A.flash_attention.launches = 0
    A.flash_attention_bwd_dq.launches = 0
    A.flash_attention_bwd_dkv.launches = 0
    t0 = time.perf_counter()
    for ev in events:
        ev[0].record()
        with autograd.record():
            loss = loss_fn(net(x), y)
        ev[1].record()
        autograd.backward(loss)
        ev[2].record()
        trainer.step(TRAIN_BATCH)
        ev[3].record()
        losses.append(loss.detach().mean())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fwd": A.flash_attention.launches,
                "dq": A.flash_attention_bwd_dq.launches,
                "dkv": A.flash_attention_bwd_dkv.launches}
    # ---- end of the main path
    losses = [v.item() for v in losses]
    log("train: %d Adam steps (lr 1e-3) on one (%d, %d) batch: loss %s" % (
        TRAIN_STEPS, TRAIN_BATCH, SEQ, " ".join("%.4f" % v for v in losses)))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("the loss is not finite or did not fall")
    expected = LAYERS * TRAIN_STEPS
    log("train: launches fwd %d, dq %d, dkv %d; expected %d each (layers x "
        "steps)" % (launches["fwd"], launches["dq"], launches["dkv"],
                    expected))
    if any(n != expected for n in launches.values()):
        raise AssertionError("the training path did not run each attention "
                             "kernel once per layer per step")

    # 3. where a step's time goes (CUDA events, after the warmup steps)
    split = np.array([[a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
                      for ev in events[WARMUP_STEPS:]])
    fwd_ms, bwd_ms, opt_ms = split.mean(axis=0)
    step_ms = split.sum(axis=1).mean()
    log("train: step %.2f ms on %s (mean of %d after %d warmup): forward "
        "%.2f ms, backward %.2f ms, optimizer %.2f ms; %.0f tokens/s; %d "
        "steps in %.2f s wall; peak memory %.2f GB" % (
            step_ms, smi, TRAIN_STEPS - WARMUP_STEPS, WARMUP_STEPS, fwd_ms,
            bwd_ms, opt_ms, TRAIN_BATCH * SEQ / step_ms * 1e3, TRAIN_STEPS,
            wall, torch.cuda.max_memory_allocated() / 1e9))
    profile_steps(lambda: _train_step(net, loss_fn, trainer, x, y), smi,
                  step_ms)
    return launches


def _train_step(net, loss_fn, trainer, x, y):
    from mxnet_tpu_torch import autograd

    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)
    trainer.step(x.shape[0])


# device kernels by what they do, matched on the kernel's name
KERNEL_GROUPS = (("K4b flash_bwd_dkv", "flash_bwd_dkv"),
                 ("K4a flash_bwd_dq", "flash_bwd_dq"),
                 ("K3 flash_fwd", "flash_fwd"),
                 ("matrix products", "gemm"),
                 ("softmax", "softmax"))


def profile_steps(step, smi, step_ms, steps=3):
    """Device time by kernel group and the device's busy share over a
    window of training steps, from a torch.profiler trace.  The profiler
    slows the host, so the device time per step is also given as a share
    of ``step_ms``, the step time measured without it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError("the profiler saw no device kernel")
    groups = dict.fromkeys([g for g, _ in KERNEL_GROUPS] + ["other"], 0.0)
    busy, end = 0.0, None
    for t_start, t_end, name in spans:
        group = next((g for g, key in KERNEL_GROUPS if key in name.lower()),
                     "other")
        groups[group] += t_end - t_start
        if end is None or t_start > end:
            busy += t_end - t_start
            end = t_end
        elif t_end > end:
            busy += t_end - end
            end = t_end
    total = sum(groups.values())
    log("train: profiled %d steps on %s: %.2f ms of wall, device busy "
        "%.1f %% of it (%d kernels); device time per step %.2f ms, %.1f %% "
        "of the unprofiled step (%.2f ms); by group: %s" % (
            steps, smi, wall_us / 1e3, 100.0 * busy / wall_us, len(spans),
            total / steps / 1e3, 100.0 * total / steps / 1e3 / step_ms,
            step_ms, ", ".join("%s %.2f ms (%.1f %%)" % (
                g, t / steps / 1e3, 100.0 * t / total)
                for g, t in groups.items())))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    smi = environment()
    build()
    fwd_row = kernels(args.seed)
    bwd_rows = backward_kernels(args.seed)
    serve_launches = serve(args.seed, smi)
    train_launches = train(args.seed, smi)
    # one entry per kernel per main path, each with that path's own count
    entries = [dict(name="flash_attn_fwd", path=path, route="cuda",
                    source="mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
                    replaces="mxnet_tpu/ops/attention.py:63",
                    launches=n, **fwd_row)
               for path, n in (("serve", serve_launches),
                               ("train", train_launches["fwd"]))]
    for kern, line in (("dq", 163), ("dkv", 206)):
        entries.append(dict(name="flash_attn_bwd_" + kern, path="train",
                            route="cuda",
                            source="mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
                            replaces="mxnet_tpu/ops/attention.py:%d" % line,
                            launches=train_launches[kern], **bwd_rows[kern]))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and hold its kernels against their plain versions.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the script exits non-zero):

1. environment: the card's name and power limit, torch and CUDA versions;
2. build: every kernel under mxnet_tpu_torch/csrc, compiled by nvcc, with
   ptxas's report (registers, spills; the instances that spill are
   listed; a wgmma-serialization warning C7518 fails) and, where
   cuobjdump exists, the count of tensor-core instructions in the SASS of
   each tensor-core kernel, which must not be 0: HGMMA in each bf16 and
   float16 conv dW kernel (16 instances of each type) and in each wgmma
   instance of the attention backward (12), HMMA in each of its 3xTF32
   instances (6); HGMMA in each wgmma instance of the attention forward
   (6) and in each of its 3xTF32 instances on tf32 wgmma (2), HMMA in
   its 3xTF32 instance on mma.sync (1); and the forward's launch plan at
   every head-dim bucket and type, as its C dispatch reports it, equal to
   ops/attention.py fwd_launch_plan;
3. kernels: the attention forward (K3) against its plain PyTorch version
   on the card at the shapes the serving path gives it and at edge shapes
   (float16, head dims 96, 128 and 256 in float32 and float16), bitwise
   equal across two launches, with its launch plan (ops/attention.py
   fwd_launch_plan: route, tiles, ring stages, shared memory; each row's
   equal to the plan its C dispatch reports), its time
   (and launched alone through its C entry point), the plain version's, one
   PyTorch library call's, and the bound with the kernel's share of it
   (over 100 % fails: the bound would be wrong); a head dim of 264
   raises;
3b. backward kernels: dQ (K4a) and dK/dV (K4b) against the plain backward
   at the training shape and the same edge shapes, bitwise equal across
   two launches, with their route, tiles and shared memory
   (ops/attention.py bwd_launch_plan), their times, the plain backward's,
   SDPA's backward and the bounds with each kernel's share of its own;
3c. convolution and pooling kernels: the weight-gradient kernels K1a
   (per tap) and K1b (im2col) at every distinct convolution shape of
   ResNet-50 at batch 128 in bf16 (the tensor-core kernel), at two of
   them in float32 too (its 3xTF32 route), at three in float16 (the
   tensor-core kernel's f16 instances) and at a ragged shape in bf16 and
   float32, at LeNet's two convolutions in float32 (phase 8's) and the
   ConvLSTM cell's two (phase 10's); the
   max-pool backward K2 at the stem pool's shape in bf16,
   float32 and float16, at an all-ties input, an odd shape (C = 5, the
   scalar path), 2x2/s2, 3x3/s1/p1 and 7x7 windows, NaN inputs,
   windows wholly in the padding and LeNet's two pools in float32; each against its plain version on the
   card (K1 within 1e-3 of the plain result's largest magnitude, K2
   bitwise), bitwise equal across two launches, with its time, the plain
   version's, cuDNN's (or PyTorch's max-pool backward) and the bound, for
   K1 its launch plan, workspace, TFLOP/s and share of the bound, for K2
   its tile plan; one K2 call at the stem shape launches one kernel and
   allocates only dX; then SSD300's shapes at batch 32 in float32 (phase
   11's): K1 at every distinct convolution (fc6's 3x3 of dilation 6, the
   heads' widths 84, 126, 16 and 24, conv1_1's I = 3 on K1b) beside
   cuDNN's wgrad, and at conv4_3, conv1_1 and conv4_3's loc head (O = 16)
   an error against a float64 dW no larger than 4x the plain float32
   version's, K1's tensor-core route with dilation at fc6's shape in
   bf16 and a ragged dilated shape in bf16 and float16, and K2 at pool1-pool5 (pool3's ceil window reaching
   past its 75 x 75 input, pool5's 3x3/s1/p1); then K1 grouped and with
   the roles swapped, in bf16 and float32, against the plain version:
   a ResNeXt-style 3x3 at (128, 56, 56, 128) in 32 groups, MobileNet's
   depthwise 3x3 at (128, 112, 112, 32) and a 2x transposed convolution
   (kernel 4, stride 2, pad 1) at (32, 56, 56, 64 -> 128), each beside
   aten's weight gradient and the bound; then the three as Gluon layers
   in bf16 through one recorded forward and backward, the wrappers'
   counts over it (the kernels line's path grouped_conv);
3d. BatchNorm kernels: the forward K6a and the backward K6b at every
   distinct BatchNorm shape of ResNet-50 at batch 128 in bf16 (bf16 gamma
   and beta, as the step casts them), at every one in float32 and
   float16 too (timed at the stem's and layer 4's), at C = 5 (the scalar
   path) and at M = 3; each
   against its plain version on the card (y, the statistics, the running
   statistics, dx, dgamma and dbeta within two steps of the type of the
   plain result's largest magnitude, 1e-4 in float32), bitwise equal
   across two launches, with its launch plan, time, the plain version's,
   aten's native_batch_norm (and its backward) on the same tensors, the
   bound and the share of it (over 100 % fails); K6a's grid and shared
   memory (streamed at every shape) and K6b's route ("resident" or
   "streamed"), grid and shared memory, as launch_plan makes them for the
   card's SMs, with the occupancy API allowing the blocks an SM that each
   plan assumes co-resident; one K6a call (in
   train mode at each case, in predict mode in each type) and one K6b
   call at each case is one device kernel each in one profiler trace;
   BatchNorm over axis 1 of NCHW data lying channels_last (SSD300's
   relu4_3 shape) runs one K6a and one K6b on its NHWC view, equal to the
   plain version and bitwise to the NHWC call;
3e. box_nms (K7): the keep set at MultiBoxDetection's shape (32, 8732)
   and at other cases (all ties, all suppressed, topk 400, force_suppress
   at (8, 2000) and at the full shape, id_index -1, 80 % of the rows one
   class, 80 classes, NaN and signed-zero ids, 24,564 rows an image by
   class, 400,000 and 2,000,000 rows an image, and 2,000,000 by class),
   each bitwise equal to the plain version on the card and across two
   launches (and box_nms on the card to the CPU's at (2, 500)), with its
   route, launch shapes and scratch bytes, its time (and the device time
   of the scan -- class keys, sort, segments -- and of the walk, from a
   profiler trace), the plain version's and the bound (the pair tests
   that greedy NMS needs for this run's keep set, in each class);
4. serve: the full-width TransformerLM (vocab 32000, units 512, 4 layers,
   8 heads, S=1024), hybridized, behind the InferenceServer (buckets
   1/2/4/8, one captured CUDA graph a bucket, built by warmup()), a dozen
   concurrent requests of 1-8 samples plus one with an out-of-range token
   (rejected by the sentinel); every served row is held against an
   unbatched eager forward, and the logits of a short input against the
   same weights run by the plain path on the CPU; the bucket builds must
   equal the buckets after warmup and after serving, and the kernel's
   wrapper count the layers x buckets x 2 (each bucket's eager warm-up
   and capture); the net called outside inference_mode at a served
   bucket shape replays the server's graph and equals the served rows;
   latency p50/p99 and tokens/s from the host clock and the serve:e2e
   histogram, and the caching host allocator's pinned bytes; the
   bucket-8 forward as a graph replay against eager, and the bucket-8
   logits' copy to the host pageable (.cpu()) against pinned, in turns;
   a burst of bucket-8 requests under torch.profiler: K3 once a layer a
   replayed batch, and the share of the device-to-host copies' time
   that overlaps kernels; a bucket built (captured) lazily while the
   other worker serves, which must serve requests during the build;
4b. predictor: phase 8's LeNet with seeded weights, written by
   save_checkpoint and loaded by a Predictor on the card; its captured
   predict forward bitwise equal to the eager one; served at buckets
   1-64 (one captured predict forward a bucket) to 6 concurrent clients,
   the workers turned 1 -> 3 -> 1 and the batch wait changed mid-run with
   no request lost, every row within 1e-5 of a batch-1 Predictor
   forward, one JSONL line a batch; the serving, runtime_stats and slo
   snapshots and a reqtrace exemplar printed;
5. train: the same model on the card, first one record/backward on a
   (2, 128) batch whose every parameter gradient is held against the same
   weights' gradients on the CPU plain path, then two record/backward
   calls of a hybridized copy (captured forward and backward graphs, K3,
   K4a and K4b inside them) against the eager ones within 1e-5 of each
   largest magnitude, then 10 Adam steps on one
   fixed (8, 1024) batch through autograd.record, SoftmaxCrossEntropyLoss,
   autograd.backward and gluon.Trainer: a finite loss that falls, and K3,
   K4a and K4b each launched once per layer per step; the step time, split
   into forward, backward and optimizer; then 3 more steps under
   torch.profiler for the device's busy share and its time by kernel group;
5b. compiled LM train: Trainer.compile, the whole step (forward, loss,
   backward, the Trainer's own Updater) as one captured CUDA graph: (1)
   the full-width model in float32 with Adam, 3 compiled steps against the
   same step run eagerly (bitwise) and against the eager record /
   backward / Trainer.step loop (every parameter and Adam state within
   1e-5 of its largest magnitude); (2) the main path: the model cast to
   float16, gluon.Trainer(..., "adam", {"learning_rate": 1e-3,
   "multi_precision": True}), trainer.compile(net,
   SoftmaxCrossEntropyLoss()), 10 steps of cs.step(x, y) on one fixed
   (8, 1024) batch: a finite loss that falls, float16 weights with float32
   masters, one captured graph, K3, K4a and K4b in their float16
   instances at the warm-up and the capture (2 x 4 each); the Trainer's
   states saved after step 5; (3) 3 more replays under torch.profiler: K3,
   K4a and K4b counted (4 each a step), the busy share and the time by
   kernel group; (4) the step time, tokens/s and peak memory, and the
   compiled float16 step beside phase 5's eager float32 step in turns;
   (5) step 5's weights and saved states loaded into a new float16 net,
   Trainer and compiled step, and into the main path's own (whose graph
   the load drops, so the next step captures again): each takes steps
   6-10 with the same losses, weights and masters, bit for bit; (6) SGD,
   NAG, Signum, Adamax,
   FTML, Ftrl, RMSProp (plain and centered), AdaGrad and AdaDelta each
   through 2 compiled steps on an MLP, bitwise the eager Trainer loop;
6. ResNet-50 v1 training (NHWC): float32 gradients at (4, 64, 64, 3)
   held against the same weights' gradients on the CPU plain path (in
   predict mode every parameter's, in train mode all together against
   the CPU's own rounding sensitivity); 3 captured steps against 3 eager
   steps from the same state, bitwise, and the eager step's time; one
   captured step of resnet50_v1() in its default layout, NCHW (BatchNorm
   over axis 1), at batch 8 against an eager one, bitwise; then
   the main path exactly as the JAX package's bench:
   GluonTrainStep(mesh None, lr 0.1, momentum 0.9, wd 1e-4, compute_dtype
   bfloat16),
   captured as a CUDA graph, for 10 steps on one fixed (128, 224, 224, 3)
   batch: a finite loss whose last value lies below the first, and the
   wrappers' counts over the eager warm-up and the capture, K1a 44, K1b
   9, K2 1, K6a 53 and K6b 53 each a step; the step time, images per
   second and peak memory; then 3 more steps (replays) under
   torch.profiler, by kernel group, with each kernel's launches over
   them counted in the trace (3 x a step; these go in the kernels line,
   as null where the trace holds no device kernel); then one
   make_chained(10) launch, timed;
6b. ResNet-50 v2 and the space-to-depth stem: resnet50_v2's float32
   gradients at (4, 64, 64, 3) against the CPU plain path (phase 6's
   criteria); a FactorScheduler halving the rate every 2 steps inside a
   captured GluonTrainStep(optimizer=SGD) on an MLP: one capture, each
   step's rate read from the step's buffer, bitwise equal to the step run
   eagerly, within 1e-5 of the eager Updater loop; the main path,
   resnet50_v2(layout="NHWC") through GluonTrainStep(optimizer=SGD(lr
   0.1, momentum 0.9, wd 1e-4), compute_dtype bfloat16), captured, 10
   steps on one (128, 224, 224, 3) batch: a finite loss, one graph, the
   wrappers' counts (2 x a step; the raw input's BatchNorm runs K6a
   alone), step time, images/s, peak memory, 3 replays under
   torch.profiler (busy share, time by group, launches counted); the
   same step with the fused lr/momentum/wd closure, in turns; K1 summed
   over v2's convolutions (the kernels line's path resnet_v2_train);
   then resnet50_v1(stem_s2d=True) against the 7x7 stem, captured at
   the same batch, in turns, its counts (path resnet_s2d_train), and K1
   over its convolutions, the stem's K1b at (128, 115, 115, 12) 4x4
   among them (the 7x7 stem's is phase 3c's);
7. imperative: (a) every registered op once through mx.nd on the card at a
   small seeded shape, against the same call on the CPU (the RNN op in
   five cases: LSTM, GRU, relu and tanh, bidirectional, two layers, the
   clipped cell state, a batch-1 state; BatchNorm over axis 1 and over
   the last axis, both through K6a; the detection ops, box_nms through
   K7; integers that
   wrap, float-to-integer casts that saturate, NaN, the infinities, an
   integer divisor of 0 and signed zeros among the cases; every optimizer
   update op, the multi_* and mp_* ones included, and the CTC loss), then
   the
   TransformerLM's feed-forward written in mx.nd at full width ((8, 1024,
   512) through FullyConnected, gelu LeakyReLU, FullyConnected, residual
   and LayerNorm) under autograd.record with attach_grad on its weights:
   every gradient within 1e-3 of the CPU run's largest magnitude; (b)
   rtc.CudaModule through NVRTC: MXNet's axpy example verbatim, axpy
   (csrc/rtc/axpy.cu) at the stem activation (128, 112, 112, 64), the main
   path -- a user's sgd_mom kernel (csrc/rtc/sgd_mom.cu) updating all 193
   trainable tensors of resnet50_v1 with real gradients, one launch per
   tensor, 193 launches counted -- then sgd_mom against mx.nd.sgd_mom_update
   over two updates, the update captured in a CUDA graph and replayed
   (bitwise equal to the eager update; its device time against the
   bound), scale<float> (csrc/rtc/scale_tmpl.cu) through
   exports, and the error cases (a compile error with NVRTC's log, a wrong
   dtype, a CPU array); each kernel bitwise repeatable, with its time, the
   plain version's, the library call's, the bound, the host time of a
   launch by part (beside the parts of the earlier launch path that the
   launch template replaced) and NVRTC's compile time, cold and cached;
8. symbolic: train_mnist.py's MLP (784-128-64-10, 2 epochs) and LeNet
   (20 and 50 filters of 5x5, tanh, 2x2 max pools, 500 hidden; 1 epoch,
   NCHW) through mx.sym -> Executor -> mx.mod.Module on the synthetic
   digits at batch 64, with common/fit.py's SGD (lr 0.05, momentum 0.9,
   wd 1e-4, MultiFactorScheduler, rescale_grad 1/batch) from a seeded
   Xavier start: the first batch's gradients and outputs held against the
   CPU plain path within 1e-5 of each largest magnitude; 3 captured
   batches (the executor's fused forward and backward as one CUDA graph)
   against 3 eager ones, bitwise, the eager ones launching K1b and K2
   twice each a LeNet batch; a batch's forward_backward + update timed
   captured and eager (CUDA events); then the main path, Module.fit with
   eval_metric accuracy, Speedometer and do_checkpoint: validation
   accuracy above 0.9, the wrappers' counts over it (LeNet: K1b and K2 at
   the eager warm-up and the capture, 2 x 2 each), the Module loop's host
   time a batch, the last checkpoint read back through Module.load
   predicting bitwise as the trained Module; for LeNet the launches of 3
   replayed batches counted in a profiler trace;
9. word LM: BASELINE config 3, the RNNModel of example/rnn/word_lm at the
   PTB "medium" widths (Zaremba et al. 2014: vocab 10000, embedding and
   hidden 650, 2 LSTM layers, dropout 0.5, bptt 35, batch 20, Uniform(0.05),
   SGD lr 1 with the global norm clipped to 5; mxnet_tpu_torch.gluon.
   model_zoo.word_lm) on the synthetic corpus: (a) the first batch at
   dropout 0 on the card against the CPU plain path (the loss and every
   gradient within 1e-3 of its largest magnitude); (b) two record/backward
   calls of the hybridized model (one captured forward and backward
   graph, the LSTM inside) against eager within 1e-5, the states carried;
   (c) dropout at p = 0.5 inside captured graphs, through the Dropout
   layer and the RNN op's inter-layer dropout: two replays, two masks,
   each keeping 0.5 within 0.01; (d) the main path: 600 hybridized steps
   with the Trainer built before the first forward (deferred widths),
   the states carried and detached, clip_global_norm and SGD: a finite
   loss whose perplexity over the last 20 batches lies below the first
   20's, and no launch of any of the port's hand kernels (the path runs
   none of K1-K6: the JAX recurrence is an XLA scan, no Pallas kernel);
   (e) the step's time eager and hybridized by CUDA events, split into
   forward, backward, clip and update, tokens/s, peak memory, and from
   torch.profiler the device's busy share, the kernels a step and the
   device time by group; (f) a yardstick off the path: the port's LSTM
   layer forward + backward at (35, 20, 650) eager and hybridized beside
   torch.nn.LSTM (cuDNN) with the same weights, times and largest
   differences;
10. bucketing: example/rnn/bucketing/lstm_bucketing.py's model (an
   Embedding, a SequentialRNNCell of 2 LSTMCells of 200 unrolled into the
   symbol, FullyConnected over the vocabulary of 10000, SoftmaxOutput) at
   the upstream example's widths (embedding 200, batch 32, buckets 10 to
   60, SGD lr 0.01, momentum 0, wd 1e-5, Xavier(factor_type "in",
   magnitude 2.34)) through mx.rnn.BucketSentenceIter and
   mx.mod.BucketingModule on a seeded synthetic corpus (noisy ring walks
   of 2-60 tokens, the noise a Zipf law over the ids): (1) the first
   batch at bucket 10 on the card against the CPU plain path (the loss and
   every gradient within 1e-3 of its largest magnitude); (2) at every
   bucket one captured forward_backward + update against the eager
   program from the same state, bitwise, each bucket's bind and first
   (capture) batch timed, then each bucket's step captured and eager by
   CUDA events, and bucket 60 under torch.profiler (busy share, kernels a
   batch); (3) the main path: BucketingModule.fit over one pass with a
   validation iterator and Perplexity(0): 6 buckets, one captured graph
   each, every parameter shared by storage with the default bucket's
   executor, no parameter copied between the host and the card after the
   first, the perplexity of the last 20 batches below the first 20's, no
   hand kernel launched; tokens/s, valid and padded, peak memory and a
   fit batch's host time by call; (4) the FusedRNNCell form (the RNN op,
   upstream's cudnn_rnn_bucketing.py) against its unfuse() stack, weights
   carried through unpack_weights/pack_weights, within 1e-5 over 3
   batches at buckets 10 and 60, both timed; (5) a ConvLSTMCell unrolled
   over 4 steps ((8, 3, 16, 16) maps, 16 hidden channels) through a
   captured executor against the CPU (gradients within 1e-3), its K1b
   launches counted over the main path and in a trace of 3 replays (the
   kernels line's path bucketing_convlstm);
11. SSD300: BASELINE config 4, SSD300 over the reduced VGG16 (upstream
   example/ssd get_config("vgg16_reduced", 300): 20 classes plus
   background, 8,732 anchors; gluon.model_zoo.ssd.SSD300) at its
   published widths, float32, in the Gluon layers' default NCHW layout:
   (a) one step at batch 2 on the card against the CPU plain path (the
   outputs and the loss within 1e-3 of their largest magnitude, the L2
   distance of all gradients within 3 times the CPU's own L2 change
   under the largest of 3 draws of a 1e-6 relative input change); (b) the main path, the JAX example's train() loop
   (example/ssd/train.py): synthetic 300 x 300 scenes of 1-3 boxes, a
   colour a class, through mx.io.NDArrayIter at batch 32, the forward
   under autograd.record, MultiBoxTarget with hard-negative mining, the
   class loss plus 5 x L1Loss of the masked offsets, backward and
   gluon.Trainer's Adam (lr 2e-3): a finite loss whose last 20 batches
   lie below the first 20, K1a, K1b and K2 launched once a convolution
   and pool a step; the step time (CUDA events), images/s, peak memory,
   then 3 steps under torch.profiler (busy share, time by kernel group);
   (c) evaluate(): MultiBoxDetection (NMS 0.45) on 32 held-out scenes,
   one K7 launch, finite rows of (32, 8732, 6), the top-1 class at IoU
   >= 0.5 accuracy, the call's time and its peak memory (the kernels
   line's paths ssd_train and ssd_detect);
12. module family: (a) a Dropout(0.5) Module read before its backward
   (the executor's split graphs: a captured forward that keeps its
   activations, a captured backward over them): one mask for the output
   and the input gradient, one forward run a batch, a new mask each
   batch; train_mnist.py's LeNet as a SequentialModule (the trunk to the
   pools with label_names [], the head from the Flatten taking the
   labels) against phase 8's single Module from the same seeded start on
   the same 20 batches (forward, outputs read, backward, update): every
   parameter within 1e-5 of its largest magnitude, each module's forward
   once a batch; the captured batch's time, the single Module's and the
   SequentialModule's in turns, and the sequential batch's host time by
   call; then the main path, SequentialModule.fit for 1 epoch with
   common/fit.py's SGD and a Monitor(100): validation accuracy above 0.9,
   each module's forward once a batch, the Monitor's syncs (one a toc,
   none on the batches it skips), the wrappers' counts (K1b and K2 at the
   trunk's warm-up and capture, 2 x 2 each) and the launches of 3
   batches counted in a profiler trace (2 each a batch; the kernels
   line's path sequential_lenet); (b) custom_softmax.py's MLP (a softmax
   on the host through mx.operator.CustomOp, need_top_grad False) through
   Module.fit: accuracy above 0.9, its executor never captured, a batch's
   time beside the same MLP with SoftmaxOutput (captured); (c)
   Module.reshape of a trained MLP to 1 and 100 samples: outputs within
   1e-6 of a fresh bind from get_params(), the trained weights kept, and
   back at 64 the first executor's graph replayed; (d) model.FeedForward
   on numpy arrays, 2 epochs: predict and score above 0.9, a save/load
   round trip predicting bitwise equal.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists each kernel with its numbers.  Without a CUDA device the script
exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12        # bf16 tensor cores
# float32-accurate work on the tensor cores: 3xTF32 spends three TF32
# products (495 TFLOP/s) on each float32 one
PEAK_TF32X3_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12            # HBM3

VOCAB, UNITS, LAYERS, HEADS, SEQ = 32000, 512, 4, 8, 1024
BUCKETS = (1, 2, 4, 8)
REQUEST_SAMPLES = (1, 2, 3, 4, 5, 6, 7, 8, 3, 5, 2, 7)

# kernel vs plain: float32 sums run in another order (~1e-6 at S=1024);
# bf16 output is rounded in both and the plain version also rounds the
# probabilities to bf16, so they may differ by about two bf16 steps;
# float16 is held to bf16's tolerance (a finer type, the same rounding
# points)
TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2, torch.float16: 1e-2}
# backward kernels vs the plain backward: f32 as tests/test_attention.py
# holds JAX's backward kernels; bf16 gradients are rounded in both, so a
# float32 sum in another order may land one bf16 step (2**-8 relative)
# away (measured on the H100: 0 at the training shape, 2.4e-4 at a small
# one)
BWD_TOL = {torch.float32: 2e-3, torch.bfloat16: 1e-2, torch.float16: 1e-2}
# served rows vs an unbatched forward, and card vs CPU plain path: the
# matrix products pick other algorithms per batch size and device
SERVE_TOL = 1e-4
# every parameter gradient on the card within this share of that
# gradient's largest magnitude on the CPU plain path
GRAD_TOL = 1e-3
TRAIN_BATCH, TRAIN_STEPS, WARMUP_STEPS = 8, 10, 2
# phase 8: train_mnist.py's batch, and LeNet's convolutions as (NHWC x
# shape, kernel, stride, pad, O), as the NCHW ops hand them to K1b
SYM_BATCH = 64
LENET_CONVS = [((SYM_BATCH, 28, 28, 1), (5, 5), (1, 1), (0, 0), 20),
               ((SYM_BATCH, 12, 12, 20), (5, 5), (1, 1), (0, 0), 50)]


# phase 10: the ConvLSTM cell's unroll (NCHW, float32): batch, input
# channels, map size, hidden channels, steps; its i2h and h2h convolutions
# as (NHWC x, kernel, stride, pad, O) with their launches a backward
CONVLSTM = dict(batch=8, channels=3, size=16, hidden=16, steps=4)
CONVLSTM_CONVS = [
    (((8, 16, 16, c), (3, 3), (1, 1), (1, 1), 64), 4) for c in (3, 16)]


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


# the tensor-core libraries: every line of their ptxas report is logged
TENSOR_CORE_LIBS = ("conv_dw", "flash_attn_bwd", "flash_attn_fwd")
# the attention backward's tensor-core instances by route: the marker in
# the mangled kernel name, the instruction each must hold, and how many
# there are (wgmma: buckets 32, 64, 128 x bf16, float16 x K4a, K4b;
# tf32x3: the same buckets in float32)
BWD_TC_INSTANCES = {"wgmma": ("Wgmma", "HGMMA", 12),
                    "tf32x3": ("Tf32x3", "HMMA", 6)}
# the attention forward's tensor-core instances by the route's type: the
# marker in its mangled name, the instruction each must hold, and how many
# there are (wgmma: buckets 32, 64, 128 x bf16, float16; tf32x3 on tf32
# wgmma: float32 at buckets 32, 64; on mma.sync: float32 at bucket 128)
FWD_TC_INSTANCES = {"wgmma": ("5WgmmaI", "HGMMA", 6),
                    "tf32x3 wgmma": ("11Tf32x3WgmmaI", "HGMMA", 2),
                    "tf32x3 mma.sync": ("6Tf32x3I", "HMMA", 1)}
# conv dW's float32 instances (conv_dw_tf32_kernel): 2 formulations x the
# S operand's 5 widths (16, 24, 32, 64, 128) x 2 register-operand loads
CONV_TF32_INSTANCES = 20
# the route codes of mxt_flash_attn_fwd_plan
FWD_ROUTES = ("cuda_cores", "wgmma", "tf32x3")


def build():
    """Every kernel library, built by nvcc; the ptxas report of each
    (registers, spills), every line of it for the tensor-core libraries
    (none may hold ptxas's wgmma-serialization warning C7518), and the
    count of tensor-core instructions in each kernel's SASS."""
    from mxnet_tpu_torch import _kernels

    t0 = time.perf_counter()
    names = _kernels.build_all()
    log("build: %s in %.1f s" % (names, time.perf_counter() - t0))
    spills, serialized = [], []
    for name in names:
        func = None
        for line in (_kernels.build_log(name) or "").splitlines():
            if "Compiling entry function" in line:
                func = line.split("'")[1] if "'" in line else line
            if name in TENSOR_CORE_LIBS and line.strip() \
                    or "registers" in line or "spill" in line:
                log("  %s: %s" % (name, line.strip()))
            if "spill" in line and not line.strip().endswith(
                    "0 bytes spill stores, 0 bytes spill loads"):
                spills.append("%s %s" % (name, func))
            if "C7518" in line:
                serialized.append("%s %s" % (name, func))
    log("build: %d kernel instances report spills%s" % (
        len(spills), (": " + "; ".join(spills)) if spills else ""))
    if serialized:
        raise AssertionError("ptxas serialized the wgmmas of %s (C7518)"
                             % "; ".join(serialized))
    conv_sass = sass_counts("conv_dw")
    counts = require_opcode(conv_sass, "conv_dw", "conv_dw_wgmma_kernel",
                            "HGMMA")
    # the tensor-core kernel's instances: 2 types (template argument kF16:
    # Lb0 bf16, Lb1 float16) x 2 formulations x 2 x 2 load paths x 2 tiles
    by_type = {t: sum(1 for f in counts if "conv_dw_wgmma_kernelILb%d" % i
                      in f) for i, t in enumerate(("bf16", "float16"))}
    log("build: conv_dw tensor-core instances with HGMMA: %s" % by_type)
    if counts and by_type != {"bf16": 16, "float16": 16}:
        raise AssertionError("expected 16 bf16 and 16 float16 tensor-core "
                             "instances of conv_dw, found %s" % by_type)
    # the float32 route (3xTF32 on tf32 wgmma): 2 formulations x 5 widths
    # of the S operand x 2 load paths of the register operand
    tf32 = require_opcode(conv_sass, "conv_dw", "conv_dw_tf32_kernel",
                          "HGMMA")
    log("build: conv_dw float32 (tf32x3) instances with HGMMA: %d"
        % len(tf32))
    if conv_sass and len(tf32) != CONV_TF32_INSTANCES:
        raise AssertionError("expected %d tf32x3 instances of conv_dw, found "
                             "%d" % (CONV_TF32_INSTANCES, len(tf32)))
    bwd = sass_counts("flash_attn_bwd")
    for route, (marker, opcode, want) in BWD_TC_INSTANCES.items():
        found = require_opcode(bwd, "flash_attn_bwd", marker, opcode)
        log("build: flash_attn_bwd %s instances with %s: %d" % (
            route, opcode, len(found)))
        if bwd and len(found) != want:
            raise AssertionError("expected %d %s instances of flash_attn_bwd,"
                                 " found %d" % (want, route, len(found)))
    fwd = sass_counts("flash_attn_fwd")
    for route, (marker, opcode, want) in FWD_TC_INSTANCES.items():
        found = require_opcode(fwd, "flash_attn_fwd", marker, opcode)
        log("build: flash_attn_fwd %s instances with %s: %d" % (
            route, opcode, len(found)))
        if fwd and len(found) != want:
            raise AssertionError("expected %d %s instances of flash_attn_fwd,"
                                 " found %d" % (want, route, len(found)))
    check_fwd_plans()


def fwd_kernel_plan(d, dtype):
    """The FwdLaunchPlan that the built K3's C dispatch launches at head
    dim ``d`` in ``dtype`` (mxt_flash_attn_fwd_plan)."""
    import ctypes

    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import attention as A

    out = (ctypes.c_int * 7)()
    err = _kernels.library("flash_attn_fwd").mxt_flash_attn_fwd_plan(
        d, A._DTYPE_CODES[dtype], out)
    if err:
        raise AssertionError("mxt_flash_attn_fwd_plan(%d, %s) failed: %d"
                             % (d, dtype, err))
    return A.FwdLaunchPlan(FWD_ROUTES[out[0]], *out[1:])


def check_fwd_plans():
    """ops/attention.py fwd_launch_plan equals what the C dispatch
    launches, at the edges of every head-dim bucket in every type."""
    from mxnet_tpu_torch.ops import attention as A

    dims = sorted({e for b in A.HEAD_DIM_BUCKETS for e in (b // 2 + 1, b)}
                  | {1})
    for dt in A._DTYPE_CODES:
        for d in dims:
            plan, kernel = A.fwd_launch_plan(d, dt), fwd_kernel_plan(d, dt)
            if plan != kernel:
                raise AssertionError(
                    "fwd_launch_plan(%d, %s) is %s, the C dispatch launches "
                    "%s" % (d, dt, tuple(plan), tuple(kernel)))
        log("build: flash_attn_fwd %s plans at head dims %s equal the C "
            "dispatch's: %s" % (str(dt).split(".")[1], dims, sorted(
                {tuple(A.fwd_launch_plan(d, dt)) for d in dims})))


def require_opcode(counts, name, kernel, opcode):
    """Fail if a function of ``counts`` (of library ``name``) whose name
    holds ``kernel`` has no ``opcode`` instruction, or if there is none;
    returns those functions' counts of it.  Empty without a SASS listing."""
    if not counts:
        return {}
    missing = [f for f, c in counts.items() if kernel in f and not c[opcode]]
    if missing or not any(kernel in f for f in counts):
        raise AssertionError("no %s instruction in the SASS of %s %s"
                             % (opcode, name, missing or kernel))
    return {f: c[opcode] for f, c in counts.items() if kernel in f}


def sass_counts(name):
    """Log how many tensor-core instructions (HGMMA, HMMA) the SASS of
    each function of library ``name`` holds (cuobjdump) and return them by
    (mangled) name; without cuobjdump, say so and return {}."""
    import os
    import re
    import shutil

    from mxnet_tpu_torch import _kernels

    tool = shutil.which("cuobjdump") or next(
        (p for p in ("/usr/local/cuda/bin/cuobjdump",) if os.path.exists(p)),
        None)
    if tool is None:
        log("  %s: cuobjdump not found, SASS not inspected" % name)
        return {}
    sass = subprocess.run([tool, "-sass", _kernels.library_path(name)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            counts[func] = {"HGMMA": 0, "HMMA": 0}
        elif func is not None:
            for op in counts[func]:
                counts[func][op] += len(re.findall(r"\b%s\b" % op, line))
    for func, c in sorted(counts.items()):
        log("  %s SASS %s: %s" % (name, func, ", ".join(
            "%s %d" % kv for kv in c.items())))
    return counts


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


def graph_ms(fn, iters=20, replays=3):
    """The device time of one call of ``fn``: ``iters`` calls captured in
    one CUDA graph (after warm-up calls on the capture stream) and
    replayed, so no host work lies between the launches, as in the
    captured step."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def fwd_launch(q, k, v, causal, lib=None):
    """A function that launches K3 on q, k, v through the C entry point of
    ``lib`` (the built ``flash_attn_fwd`` by default) alone, into buffers
    made here (``.outputs``: O and lse): the kernel's time without the
    wrapper's host work, which ``time_ms`` of the wrapper also sees when
    the kernel is shorter than it.  Such launches are not counted."""
    from mxnet_tpu_torch import _kernels
    from mxnet_tpu_torch.ops import attention as A

    lib = lib or _kernels.library("flash_attn_fwd")
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    args = [t.data_ptr() for t in (q, k, v, out, lse)] + [
        b * h, sq, k.shape[2], d, 1.0 / d ** 0.5, int(causal),
        A._DTYPE_CODES[q.dtype], torch.cuda.current_stream().cuda_stream]

    def run():
        err = lib.mxt_flash_attn_fwd(*args)
        if err:
            raise AssertionError("flash_attn_fwd launch failed: %s"
                                 % lib.mxt_error_string(err).decode())

    run.outputs = (out, lse)
    return run


def attention_flops_rate(dtype):
    """The card's least-time rate for attention's products in ``dtype``:
    bf16 and float16 on the tensor cores, float32 at float32 accuracy on
    the tensor cores (3xTF32)."""
    return PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def attention_bound_ms(b, h, sq, sk, d, causal, dtype):
    """Least time for the work: each of q, k, v, o read or written once
    (and lse), against 4*D flops per unmasked (row, col) pair at
    :func:`attention_flops_rate`."""
    pairs = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    flops = 4.0 * b * h * d * pairs
    esize = torch.finfo(dtype).bits // 8
    nbytes = b * h * d * (2 * sq + 2 * sk) * esize + b * h * sq * 4
    t_ops, t_bytes = flops / attention_flops_rate(dtype), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bwd_bound_ms(kernel, b, h, sq, sk, d, causal, dtype):
    """Least time for one backward kernel: q, k, v, dO, lse and delta
    read once and its gradients written once, against its flops per
    unmasked (row, col) pair: 6*D for dQ (s, dp, dQ), 8*D for dK/dV (s,
    dV, dp, dK), at :func:`attention_flops_rate`."""
    pairs = sum(min(r + 1, sk) for r in range(sq)) if causal else sq * sk
    flops = (6.0 if kernel == "dq" else 8.0) * b * h * d * pairs
    esize = torch.finfo(dtype).bits // 8
    written = sq if kernel == "dq" else 2 * sk
    nbytes = b * h * (d * (2 * sq + 2 * sk + written) * esize + 2 * sq * 4)
    t_ops, t_bytes = flops / attention_flops_rate(dtype), nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# the shapes at which the attention kernels are held against their plain
# versions: (name, B, H, Sq, Sk, D, causal, dtype)
EDGE_CASES = [
    ("non-causal", 8, 8, SEQ, SEQ, 64, False, torch.float32),
    ("ragged S=1000", 8, 8, 1000, 1000, 64, True, torch.float32),
    ("Sq=256 Sk=512", 8, 8, 256, 512, 64, True, torch.float32),
    ("bf16", 8, 8, SEQ, SEQ, 64, True, torch.bfloat16),
    ("f16", 8, 8, SEQ, SEQ, 64, True, torch.float16),
    ("D=128", 8, 4, SEQ, SEQ, 128, True, torch.float32),
    # head dims between and at the kernels' buckets (D=96 runs the 128
    # bucket with its last 32 columns zero; D=256 the largest bucket, with
    # 32 x 32 tiles in the backward)
    ("D=96", 4, 4, SEQ, SEQ, 96, True, torch.float32),
    ("D=96 f16", 4, 4, SEQ, SEQ, 96, True, torch.float16),
    ("D=256", 2, 4, SEQ, SEQ, 256, True, torch.float32),
    ("D=256 f16", 2, 4, SEQ, SEQ, 256, True, torch.float16),
]
# a head dim past the largest bucket raises on the card
TOO_WIDE_HEAD_DIM = 264


def kernels(seed):
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops.attention import (flash_attention,
                                               fwd_launch_plan, mha_reference)

    cases = [("bucket %d" % b, b, 8, SEQ, SEQ, 64, True, torch.float32)
             for b in BUCKETS] + EDGE_CASES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}
    for name, b, h, sq, sk, d, causal, dt in cases:
        q = torch.randn(b, h, sq, d, device="cuda", generator=gen).to(dt)
        k = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dt)
        v = torch.randn(b, h, sk, d, device="cuda", generator=gen).to(dt)
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        out2, lse2 = flash_attention(q, k, v, causal=causal, return_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(out, out2) and torch.equal(lse, lse2)
        ref, ref_lse = mha_reference(q, k, v, causal=causal, return_lse=True)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol = TOL[dt]
        ok = torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol) \
            and lse_err <= 1e-4
        ms = time_ms(lambda: flash_attention(q, k, v, causal=causal))
        launch_ms = time_ms(fwd_launch(q, k, v, causal))
        plan = fwd_launch_plan(d, dt)
        if plan != fwd_kernel_plan(d, dt):
            raise AssertionError("fwd_launch_plan(%d, %s) is not the plan "
                                 "the C dispatch launches" % (d, dt))
        plain_ms = time_ms(lambda: mha_reference(q, k, v, causal=causal))
        # SDPA's causal mask is top-left aligned too
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal))
        bound, bound_by = attention_bound_ms(b, h, sq, sk, d, causal, dt)
        log("kernel flash_attn_fwd [%s] B=%d H=%d Sq=%d Sk=%d D=%d causal=%s "
            "%s: route %s (bucket %d, %d threads, q-tile %d, %d keys a step, "
            "%d stages, smem %d B); max_abs_err %.3g (tol %.0e abs+rel), lse "
            "err %.3g, bitwise repeatable %s; kernel %.4f ms (launched "
            "alone %.4f ms), plain %.4f ms, sdpa %.4f ms, bound %.4f ms (%s, "
            "%.1f %%; launched alone %.1f %%)" % (
                name, b, h, sq, sk, d, causal, str(dt).split(".")[1],
                plan.route, plan.bucket, plan.threads, plan.q_tile,
                plan.k_step, plan.stages, plan.smem, err, tol, lse_err, same,
                ms, launch_ms, plain_ms, lib_ms, bound, bound_by,
                100.0 * bound / ms, 100.0 * bound / launch_ms))
        if not ok:
            raise AssertionError("flash_attn_fwd disagrees with its plain "
                                 "version at %s" % name)
        if not same:
            raise AssertionError("two launches of flash_attn_fwd gave "
                                 "different results at %s" % name)
        check_share("flash_attn_fwd", name, ms, bound)
        check_share("flash_attn_fwd", name, launch_ms, bound)
        # the serving path's largest shape, and the float16 training
        # shape of phase 5b's compiled step
        if name in ("bucket 8", "f16"):
            rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound, "bound_by": bound_by,
                          "library_ms": lib_ms}
        del q, k, v, out, lse, out2, lse2, ref, ref_lse
    torch.cuda.empty_cache()
    from mxnet_tpu_torch.base import MXNetError

    q = torch.zeros(1, 1, 8, TOO_WIDE_HEAD_DIM, device="cuda")
    try:
        flash_attention(q, q, q)
    except MXNetError as e:
        log("kernel flash_attn_fwd: D=%d raises MXNetError: %s"
            % (TOO_WIDE_HEAD_DIM, e))
    else:
        raise AssertionError("flash_attention took D=%d on the card"
                             % TOO_WIDE_HEAD_DIM)
    return rows


def check_share(kernel, case, ms, bound):
    """A kernel cannot beat the least time the card needs: a share of the
    bound over 100 % means the bound is wrong."""
    if ms < bound:
        raise AssertionError("%s ran in %.4f ms at %s, under its bound of "
                             "%.4f ms" % (kernel, ms, case, bound))


def backward_kernels(seed):
    """Phase 3b: K4a and K4b against the plain backward; returns each
    kernel's row at the float32 training shape (phase 5's) and at the
    float16 one (phase 5b's): ``{"dq": ..., "dkv": ..., "f16": {"dq":
    ..., "dkv": ...}}``."""
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
        plan = A.bwd_launch_plan(d, dt)
        log("kernel flash_attn_bwd [%s] B=%d H=%d Sq=%d Sk=%d D=%d causal=%s "
            "%s: route %s (bucket %d, tiles dq %s dkv %s, smem %d + %d B); "
            "max_abs_err dq %.3g dk %.3g dv %.3g (tol %.0e abs+rel), "
            "bitwise repeatable %s; dq %.4f ms (bound %.4f, %s, %.1f %%), "
            "dkv %.4f ms (bound %.4f, %s, %.1f %%), plain backward %.4f ms, "
            "sdpa backward %.4f ms"
            % (name, b, h, sq, sk, d, causal, str(dt).split(".")[1],
               plan.route, plan.bucket, plan.dq_tile, plan.dkv_tile,
               plan.dq_smem, plan.dkv_smem, errs[0], errs[1], errs[2], tol,
               same, dq_ms, bounds["dq"][0], bounds["dq"][1],
               100.0 * bounds["dq"][0] / dq_ms, dkv_ms, bounds["dkv"][0],
               bounds["dkv"][1], 100.0 * bounds["dkv"][0] / dkv_ms,
               plain_ms, lib_ms))
        if not ok:
            raise AssertionError("the backward kernels disagree with the "
                                 "plain backward at %s" % name)
        if not same:
            raise AssertionError("two launches of the backward kernels gave "
                                 "different gradients at %s" % name)
        check_share("flash_attn_bwd_dq", name, dq_ms, bounds["dq"][0])
        check_share("flash_attn_bwd_dkv", name, dkv_ms, bounds["dkv"][0])
        if name in ("train", "f16"):
            into = rows if name == "train" else rows.setdefault("f16", {})
            for kern, ms, err in (("dq", dq_ms, errs[0]),
                                  ("dkv", dkv_ms, max(errs[1:]))):
                into[kern] = {"max_abs_err": err, "ms": ms,
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


# phase 4: the burst traced for K3's replays and the copy/compute overlap
# (bucket-8 requests, callers dropping each result), and the lazy bucket
# built while two clients keep the other worker serving
SERVE_TRACE_REQUESTS = 6
# (15 rows cannot share a batch with the clients' 2 and 3 rows, so the
# lazy batch is alone in bucket 16 and the small ones go on serving)
LAZY_BUCKET, LAZY_SAMPLES = 16, 15


def _device_err(host, ref):
    """Max abs difference of a served host array (a view of pinned
    memory) and a device reference, taken on the card."""
    return float((torch.from_numpy(host).to(ref.device) - ref).abs().max())


def _graph_at(net, shape):
    """The hybridized net's cached graph at input ``shape``."""
    return next(g for k, g in net._cached_graphs.items()
                if k[0][0][0] == tuple(shape))


def _host_pinned():
    """The caching host allocator's statistics, as this PyTorch names
    them: pinned bytes and blocks it holds, bytes handed out, blocks made
    and their cudaHostAlloc ms; None where it has no
    ``host_memory_stats``."""
    stats = getattr(torch.cuda, "host_memory_stats", dict)()
    keys = ("allocated_bytes.current", "allocations.current",
            "active_bytes.current", "num_host_alloc",
            "host_alloc_time.total")
    return {k: stats[k] for k in keys if k in stats} or None


def _fmt_pinned(p):
    if p is None:
        return "not measured (no torch.cuda.host_memory_stats)"
    return ", ".join("%s %s" % (k, ("%.3f GB" % (v / 1e9)) if "bytes" in k
                                else ("%.1f ms" % (v / 1e3)) if "time" in k
                                else v) for k, v in p.items())


def _overlap(spans):
    """From a trace's device spans (start, end, name): the device-to-host
    copies' count and time, and the part of that time during which some
    kernel ran (the union of kernel spans), in us."""
    kernels = sorted((s, e) for s, e, n in spans if "memcpy" not in
                     n.lower() and "memset" not in n.lower())
    merged = []
    for s, e in kernels:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    copies = [(s, e) for s, e, n in spans if "dtoh" in n.lower()]
    both = sum(max(0.0, min(e, me) - max(s, ms))
               for s, e in copies for ms, me in merged)
    return len(copies), sum(e - s for s, e in copies), both


def serve(seed, smi):
    """Phase 4: the hybridized TransformerLM behind the InferenceServer,
    one captured graph a bucket.  Returns K3's counts for the kernels
    line."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch import _capture, histogram
    from mxnet_tpu_torch.ops.attention import flash_attention
    from mxnet_tpu_torch.serving import InferenceServer, RequestRejected

    t0 = time.perf_counter()
    net = _lm("cuda", seed)
    net.hybridize()
    torch.cuda.synchronize()
    log("serve: TransformerLM vocab %d units %d layers %d heads %d, %d "
        "parameters, hybridized, built in %.1f s" % (
            VOCAB, UNITS, LAYERS, HEADS,
            sum(p.numel() for p in net.parameters()),
            time.perf_counter() - t0))
    rng = np.random.RandomState(seed)
    requests = [rng.randint(0, VOCAB, size=(n, SEQ)).astype(np.float32)
                for n in REQUEST_SAMPLES]
    bad = rng.randint(0, VOCAB, size=(2, SEQ)).astype(np.float32)
    bad[1, 17] = VOCAB + 5  # out of range: a NaN row, then the sentinel

    # ---- the main path: the counts run from 0 over warmup and serving
    histogram.reset()
    flash_attention.launches = 0
    srv = InferenceServer(net, {"data": (SEQ,)}, buckets=BUCKETS,
                          device="cuda").start()
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    warm_compiles = srv.snapshot()["bucket_compiles"]
    pinned_warm = _host_pinned()
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
    pinned_end = _host_pinned()
    if any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError("not every request was served")
    if not (bad_outcome and bad_outcome[0].startswith("rejected")):
        raise AssertionError("the out-of-range token was not rejected: %s"
                             % bad_outcome)
    log("serve: %s" % json.dumps(snap))
    log("serve: warmup of buckets %s in %.2f s: %d bucket builds, %d "
        "captured graphs in the net; after serving %d builds" % (
            BUCKETS, warm_s, warm_compiles, len(net._cached_graphs),
            snap["bucket_compiles"]))
    if not warm_compiles == snap["bucket_compiles"] == \
            len(net._cached_graphs) == len(BUCKETS):
        raise AssertionError("serving did not run one captured graph a "
                             "bucket")
    # each bucket's graph launches K3 in its eager warm-up and once into
    # the graph at capture; replays pass no wrapper (the burst's trace
    # below counts them)
    expected = 2 * LAYERS * len(BUCKETS)
    log("serve: flash_attn_fwd wrapper launches %d over the main path, "
        "expected %d (layers x buckets x (warm-up + capture))" % (
            launches, expected))
    if launches != expected:
        raise AssertionError("the serving path did not capture the kernel "
                             "once per layer per bucket")

    e2e = sorted((f.t_done - f.t_submit) * 1e3 for f in futures)
    hist = histogram.snapshot()["serve:e2e"]
    served_tokens = sum(REQUEST_SAMPLES) * SEQ
    log("serve: %d requests (%d samples, %d tokens) in %.3f s on %s: "
        "latency p50 %.1f ms p99 %.1f ms (host clock), serve:e2e p50 %.1f "
        "ms p99 %.1f ms over %d requests (the rejected one among them), "
        "%.0f tokens/s; pinned host memory after warmup: %s; at the end, "
        "the callers holding every result: %s" % (
            len(requests), sum(REQUEST_SAMPLES), served_tokens, wall, smi,
            float(np.percentile(e2e, 50)), float(np.percentile(e2e, 99)),
            hist["p50"] * 1e3, hist["p99"] * 1e3, hist["count"],
            served_tokens / wall, _fmt_pinned(pinned_warm),
            _fmt_pinned(pinned_end)))

    worst = 0.0
    with torch.inference_mode(), _capture.staging():
        for x, out in zip(requests, results):
            got = out[0]
            if got.shape != (x.shape[0], SEQ, VOCAB):
                raise AssertionError("served output has shape %s"
                                     % (got.shape,))
            ref = net(torch.from_numpy(x).cuda())  # eager, unbatched
            err = _device_err(got, ref)
            if not err <= SERVE_TOL:  # NaN fails too
                raise AssertionError("a served row is %.3g from the "
                                     "unbatched forward" % err)
            worst = max(worst, err)
            del ref
    log("serve: every served row matches an unbatched eager forward (max "
        "abs err %.3g, tol %.0e)" % (worst, SERVE_TOL))

    # F1: the bucket-8 graph, captured under inference mode by the
    # server, called outside it at the same signature
    i8 = REQUEST_SAMPLES.index(8)
    x8 = torch.from_numpy(requests[i8]).cuda()
    if torch.is_inference_mode_enabled():
        raise AssertionError("phase 4 must call the net outside inference "
                             "mode")
    out8 = net(x8)
    f1_err = _device_err(results[i8][0], out8)
    log("serve: F1: the net called outside inference_mode at (8, %d) "
        "replays the server's graph (%d graphs, unchanged): max abs err "
        "%.3g to the served rows (%s)" % (
            SEQ, len(net._cached_graphs), f1_err,
            "bitwise" if f1_err == 0 else "not bitwise"))
    if not f1_err <= SERVE_TOL or len(net._cached_graphs) != len(BUCKETS):
        raise AssertionError("the F1 call did not replay the served graph")
    del results, futures, out8
    torch.cuda.synchronize()

    # a bucket-8 batch: the graph replay against the eager forward, and
    # the logits' copy to the host, pageable against pinned, in turns
    graph = _graph_at(net, (8, SEQ))

    def replay():
        graph.replay_forward([x8], clone=False)

    def eager():
        with torch.inference_mode(), _capture.staging():
            net(x8)

    fwd = [time_ms(f, iters=5) for f in (eager, replay, replay, eager)]
    replay()
    logits = graph.static_out[0]
    nbytes = logits.numel() * logits.element_size()
    t0 = time.perf_counter()
    pinned = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
    alloc_ms = (time.perf_counter() - t0) * 1e3
    copied = torch.cuda.Event()

    def pageable_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits.cpu()
        return (time.perf_counter() - t) * 1e3

    def pinned_ms():
        torch.cuda.synchronize()
        t = time.perf_counter()
        pinned.copy_(logits, non_blocking=True)
        copied.record()
        copied.synchronize()
        return (time.perf_counter() - t) * 1e3

    copies = [f() for f in (pageable_ms, pinned_ms, pinned_ms, pageable_ms)]
    if not torch.equal(pinned.to(logits.device), logits):
        raise AssertionError("the pinned copy differs from the logits")
    log("serve: bucket 8 on %s: forward as a graph replay %.3f, %.3f ms "
        "against eager %.3f, %.3f ms (in turns; %d attention kernels a "
        "batch); the logits' %.3f GB to the host: pageable .cpu() %.1f, "
        "%.1f ms (%.2f GB/s), pinned %.1f, %.1f ms (%.2f GB/s) in turns, "
        "host clock (the pinned buffer's first allocation %.1f ms)" % (
            smi, fwd[1], fwd[2], fwd[0], fwd[3], LAYERS, nbytes / 1e9,
            copies[0], copies[3], nbytes / 1e6 / max(copies[0], copies[3]),
            copies[1], copies[2], nbytes / 1e6 / max(copies[1], copies[2]),
            alloc_ms))
    del pinned, logits

    # a served burst under torch.profiler: K3 in the replays and the
    # copies' overlap with kernels of other batches
    srv = InferenceServer(net, {"data": (SEQ,)}, buckets=BUCKETS,
                          device="cuda").start()
    srv.warmup()
    xs = [rng.randint(0, VOCAB, size=(8, SEQ)).astype(np.float32)
          for _ in range(SERVE_TRACE_REQUESTS)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        futs = [srv.submit(x) for x in xs]
        for f in futs:
            f.result(600)  # dropped at once: the pinned block goes back
        burst_ms = (time.perf_counter() - t0) * 1e3
    batches = srv.snapshot()["batches"]
    srv.stop()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k3 = sum(1 for _, _, n in spans if "flash_fwd" in n.lower())
    n_copies, copy_us, overlap_us = _overlap(spans)
    e2e = sorted((f.t_done - f.t_submit) * 1e3 for f in futs)
    log("serve: a traced burst of %d bucket-8 requests on %s (2 workers, "
        "the callers dropping each result): %d batches in %.1f ms, latency "
        "p50 %.1f ms max %.1f ms; flash_fwd kernels in the trace %s "
        "(expected %d); %d device-to-host copies, %.1f ms, %.1f ms of it "
        "(%.1f %%) while a kernel ran; pinned: %s" % (
            len(xs), smi, batches, burst_ms, float(np.percentile(e2e, 50)),
            e2e[-1], k3 if spans else "not measured (no device events)",
            LAYERS * batches, n_copies, copy_us / 1e3, overlap_us / 1e3,
            100.0 * overlap_us / copy_us if copy_us else 0.0,
            _fmt_pinned(_host_pinned())))
    if spans and k3 != LAYERS * batches:
        raise AssertionError("the served replays did not run K3 once a "
                             "layer a batch")
    del futs

    # a bucket built lazily (captured) while the other worker serves
    srv = InferenceServer(net, {"data": (SEQ,)},
                          buckets=BUCKETS + (LAZY_BUCKET,),
                          device="cuda").start()
    for b in BUCKETS:  # the net's graphs: builds with no capture
        srv._bucket_fn(b)
    built = []
    build = srv._model.build

    def timed_build(bucket):
        t = time.perf_counter()
        exe = build(bucket)
        built.append((bucket, t, time.perf_counter()))
        return exe

    srv._model.build = timed_build
    done = threading.Event()
    served = []

    def small_client(cid):
        r = np.random.RandomState(100 + cid)
        while not done.is_set():
            x = r.randint(0, VOCAB, size=(2 + cid, SEQ)).astype(np.float32)
            f = srv.submit(x)
            f.result(600)
            served.append((f.t_submit, f.t_done))

    clients = [threading.Thread(target=small_client, args=(c,))
               for c in range(2)]
    for t in clients:
        t.start()
    time.sleep(0.3)
    xl = rng.randint(0, VOCAB, size=(LAZY_SAMPLES, SEQ)).astype(np.float32)
    big = srv.submit(xl)
    out = big.result(600)[0]
    done.set()
    for t in clients:
        t.join(600)
    srv.stop()
    if any(t.is_alive() for t in clients) or len(built) != 1 \
            or built[0][0] != LAZY_BUCKET:
        raise AssertionError("the lazy bucket was not built once: %s"
                             % built)
    _, b0, b1 = built[0]
    during = sum(1 for s, d in served if b0 < d < b1)
    with torch.inference_mode(), _capture.staging():
        lazy_err = _device_err(out, net(torch.from_numpy(xl).cuda()))
    log("serve: bucket %d built lazily (captured) in %.1f ms under load; "
        "%d small requests served by the other worker during the build, "
        "%d in all; the %d-row request's rows within %.3g of an unbatched "
        "forward" % (LAZY_BUCKET, (b1 - b0) * 1e3, during, len(served),
                     LAZY_SAMPLES, lazy_err))
    if during < 1 or not lazy_err <= SERVE_TOL:
        raise AssertionError("the lazy build kept the other worker off the "
                             "card, or its rows are wrong")
    del out, graph

    # the same weights through the plain path on the CPU, at a short input
    cpu_net = _cpu_copy(net)
    x = torch.from_numpy(requests[1][:, :128].copy())
    with torch.inference_mode(), _capture.staging():
        got = net(x.cuda()).cpu()
        ref = cpu_net(x)
    err = (got - ref).abs().max().item()
    log("serve: card vs CPU plain path on a (2, 128) input: max abs err "
        "%.3g (tol %.0e)" % (err, SERVE_TOL))
    torch.testing.assert_close(got, ref, rtol=SERVE_TOL, atol=SERVE_TOL)
    del net
    torch.cuda.empty_cache()
    return dict(launches=launches, traced_replays=batches,
                launches_in_traced_replays=k3 if spans else None)


# phase 4b: LeNet (phase 8's symbol) served through a Predictor
LENET_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
LENET_CLIENTS, LENET_REQUESTS = 6, 10
PREDICT_TOL = 1e-5


def predictor_serve(seed, smi):
    """Phase 4b: LeNet with seeded weights, written by save_checkpoint,
    loaded by Predictor and served at buckets 1-64 to concurrent clients,
    each bucket's predict forward captured; the knobs turned mid-run."""
    import os
    import tempfile

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import reqtrace, runtime_stats, serving, slo
    from mxnet_tpu_torch.predictor import Predictor
    from mxnet_tpu_torch.serving import InferenceServer

    sym = _mnist_net("lenet")
    one = (1, 1, 28, 28)
    arg_shapes, _, _ = sym.infer_shape(data=one)
    rng = np.random.RandomState(seed)
    params = {n: mx.nd.array(rng.normal(0, 0.1, size=s).astype(np.float32),
                             ctx="cpu")
              for n, s in zip(sym.list_arguments(), arg_shapes)
              if n not in ("data", "softmax_label")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pred_")
    prefix = os.path.join(tmp, "lenet")
    mx.model.save_checkpoint(prefix, 0, sym, params, {})
    with open(prefix + "-symbol.json") as f, \
            open(prefix + "-0000.params", "rb") as g:
        pred = Predictor(f.read(), g.read(), {"data": one})  # the card

    # the captured predict forward against the eager one, bitwise
    x64 = rng.rand(64, 1, 28, 28).astype(np.float32)
    clone = pred._reshape_clone({"data": (64, 1, 28, 28)})
    clone.forward(data=x64)
    captured = clone._exec.outputs[0].data_torch
    eager = clone._exec._predict()[0]
    if not (torch.equal(captured, eager)
            and len(clone._exec.predict_graphs) == 1):
        raise AssertionError("the captured predict forward is not the "
                             "eager one bit for bit")
    log("predictor: LeNet's captured predict forward at batch 64 bitwise "
        "equal to the eager one (one graph); weights shared with the "
        "clone: %s" % all(
            clone._exec.arg_dict[n].data_torch.data_ptr()
            == a.data_torch.data_ptr() for n, a in pred._arg_params.items()))
    del clone, captured, eager

    sizes = [[int(s) for s in rng.randint(1, 65, size=LENET_REQUESTS)]
             for _ in range(LENET_CLIENTS)]
    xs = [[rng.rand(n, 1, 28, 28).astype(np.float32) for n in row]
          for row in sizes]
    runtime_stats.reset()
    slo.enable("e2e:50ms:99,avail:99.9")
    reqtrace.enable(sample=8)
    metrics = os.path.join(tmp, "serve.jsonl")
    srv = InferenceServer(pred, buckets=LENET_BUCKETS, workers=1,
                          metrics_path=metrics).start()
    t0 = time.perf_counter()
    srv.warmup()
    warm_s = time.perf_counter() - t0
    got = [[None] * LENET_REQUESTS for _ in range(LENET_CLIENTS)]
    errors = []

    def client(c):
        try:
            for i, x in enumerate(xs[c]):
                got[c][i] = srv.submit(x).result(300)[0]
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(LENET_CLIENTS)]
    total = LENET_CLIENTS * LENET_REQUESTS

    def wait_done(n):
        while sum(g is not None for row in got for g in row) < n \
                and any(t.is_alive() for t in threads):
            time.sleep(0.001)

    t0 = time.perf_counter()
    for t in threads:
        t.start()
    wait_done(total // 3)
    srv.set_workers(3)
    wait_done(total // 2)
    srv.set_max_wait_ms(0.5)
    wait_done(2 * total // 3)
    srv.set_workers(1)
    for t in threads:
        t.join(300)
    wall = time.perf_counter() - t0
    deadline = time.monotonic() + 10
    while srv._worker_count > 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    workers_left = srv._worker_count
    srv.stop()
    snap = serving.snapshot()
    if errors or any(t.is_alive() for t in threads) \
            or any(g is None for row in got for g in row):
        raise AssertionError("a request was lost: %s" % errors[:3])
    with open(metrics) as f:
        lines = [json.loads(line) for line in f]
    log("predictor: served %d requests (%d rows) in %.3f s on %s, buckets "
        "%s built in %.2f s (%d builds), %d batches, %d JSONL lines, "
        "workers 1 -> 3 -> 1 (%d left after the run)" % (
            total, sum(map(sum, sizes)), wall, smi, LENET_BUCKETS, warm_s,
            snap["bucket_compiles"], snap["batches"], len(lines),
            workers_left))
    if snap["bucket_compiles"] != len(LENET_BUCKETS) \
            or snap["outcomes"]["ok"] != total \
            or len(lines) != snap["batches"] or workers_left != 1 \
            or snap["knob_adjusts"] != 3:
        raise AssertionError("the Predictor server's accounting is off")

    # each row against a batch-1 Predictor forward
    one_pred = pred._reshape_clone({"data": one})
    worst = 0.0
    for row_x, row_got in zip(xs, got):
        for x, out in zip(row_x, row_got):
            for r in range(x.shape[0]):
                one_pred.forward(data=x[r:r + 1])
                worst = max(worst, float(np.abs(
                    out[r] - one_pred.get_output(0)[0]).max()))
    log("predictor: every served row within %.3g of a batch-1 Predictor "
        "forward (tol %.0e)" % (worst, PREDICT_TOL))
    if not worst <= PREDICT_TOL:
        raise AssertionError("a served LeNet row is off")
    log("predictor: serving.snapshot() %s" % json.dumps(snap))
    log("predictor: runtime_stats.snapshot()['serving'] equal to it: %s; "
        "counters %s" % (runtime_stats.snapshot()["serving"] == snap,
                         json.dumps(runtime_stats.snapshot()["counters"])))
    log("predictor: slo.snapshot() %s" % json.dumps(slo.snapshot()))
    log("predictor: reqtrace.exemplar() %s (of %d records retained)" % (
        reqtrace.exemplar(), reqtrace.snapshot()["retained"]))
    log("predictor: a JSONL line: %s" % json.dumps(lines[-1]))
    slo.reset()
    reqtrace.reset()
    serving.reset()


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
    del cpu_net, want
    hybrid_check(net, x.cuda(), y.cuda(), got)
    del got
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


# the hybridized model vs eager on the card: the same kernels, cuBLAS
# products outside and inside a captured graph
HYBRID_TOL = 1e-5


def hybrid_check(net, x, y, want):
    """Phase 5.1: two record/backward calls of a hybridized copy of
    ``net`` (the first warms up, captures the forward and backward graphs
    and replays them; the second replays) against ``want``, the eager
    gradients of the same weights on the card: logits and every
    gradient within HYBRID_TOL of its largest magnitude.  K3, K4a and K4b
    run inside the captured graphs."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.convert import load_mxnet_tpu_params
    from mxnet_tpu_torch.ops import attention as A

    hyb = load_mxnet_tpu_params(_lm("cuda"), {
        k: v.detach().cpu().numpy() for k, v in net.state_dict().items()})
    hyb.hybridize()
    with torch.no_grad():
        logits = net(x)
    counts = [A.flash_attention.launches, A.flash_attention_bwd_dq.launches,
              A.flash_attention_bwd_dkv.launches]
    worst, bitwise = 0.0, True
    t0 = time.perf_counter()
    for call in range(2):
        with autograd.record():
            out = hyb(x)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, y)
        autograd.backward(loss)
        torch.cuda.synchronize()
        if call == 0:
            first_s = time.perf_counter() - t0
        errs = {"logits": _bn_err(out.detach(), logits)[1]}
        for name, p in hyb.collect_params().items():
            if name in want:
                errs[name] = _bn_err(p.grad, want[name])[1]
                bitwise = bitwise and torch.equal(p.grad, want[name])
        bitwise = bitwise and torch.equal(out.detach(), logits)
        name = max(errs, key=errs.get)
        worst = max(worst, errs[name])
        hyb.zero_grad()
    (graph,) = hyb._cached_graphs.values()
    launched = [A.flash_attention.launches, A.flash_attention_bwd_dq.launches,
                A.flash_attention_bwd_dkv.launches]
    log("train: hybridized TransformerLM, 2 record/backward calls at (2, "
        "128) vs eager on the card: worst %.3g of the largest magnitude "
        "(%s; tol %.0e), bitwise %s; %d cached graph(s), %d calls, %d "
        "forward replays; the first call (warm-up, capture of both graphs, "
        "replay) %.2f s; K3, K4a, K4b launched %s times at warm-up and "
        "capture" % (worst, name, HYBRID_TOL, bitwise,
                     len(hyb._cached_graphs), graph.calls, graph.replays,
                     first_s, [b - a for a, b in zip(counts, launched)]))
    if worst > HYBRID_TOL or graph.replays != 2 or graph.bwd is None:
        raise AssertionError("the hybridized TransformerLM disagrees with "
                             "eager execution or did not replay its graphs")
    if any(b - a != 2 * LAYERS for a, b in zip(counts, launched)):
        raise AssertionError("the attention kernels were not in the "
                             "captured graphs")
    del hyb
    torch.cuda.empty_cache()


def _train_step(net, loss_fn, trainer, x, y):
    from mxnet_tpu_torch import autograd

    with autograd.record():
        loss = loss_fn(net(x), y)
    autograd.backward(loss)
    trainer.step(x.shape[0])
    return loss.detach().mean()


# device kernels by what they do, matched on the kernel's name
KERNEL_GROUPS = (("K4b flash_bwd_dkv", ("flash_bwd_dkv",)),
                 ("K4a flash_bwd_dq", ("flash_bwd_dq",)),
                 ("K3 flash_fwd", ("flash_fwd",)),
                 ("matrix products", ("gemm",)),
                 ("softmax", ("softmax",)))


def profile_steps(step, smi, step_ms, steps=3, groups=KERNEL_GROUPS,
                  tag="train", count=None):
    """Device time by kernel group and the device's busy share over a
    window of training steps, from a torch.profiler trace.  The profiler
    slows the host, so the device time per step is also given as a share
    of ``step_ms``, the step time measured without it.  ``groups``:
    (group, substrings of the kernel's name), the first match wins.
    ``count``: (key, substrings, _) of kernels to count; then the steps
    are graph replays, the launches of each over the window are returned,
    and a
    trace without device kernels (a CUPTI that does not see inside
    graphs) is reported and gives ``None``."""
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
    if not spans and count is not None:
        log("%s: the profiler saw no device kernel in %d graph replays "
            "(%.2f ms of wall): busy share and time by group not measured"
            % (tag, steps, wall_us / 1e3))
        return None
    if not spans:
        raise AssertionError("the profiler saw no device kernel")
    totals = dict.fromkeys([g for g, _ in groups] + ["other"], 0.0)
    others = {}
    busy, end = 0.0, None
    for t_start, t_end, name in spans:
        group = next((g for g, keys in groups
                      if any(k in name.lower() for k in keys)), "other")
        totals[group] += t_end - t_start
        if group == "other":
            others[name] = others.get(name, 0.0) + t_end - t_start
        if end is None or t_start > end:
            busy += t_end - t_start
            end = t_end
        elif t_end > end:
            busy += t_end - end
            end = t_end
    total = sum(totals.values())
    log("%s: profiled %d steps on %s: %.2f ms of wall, device busy "
        "%.1f %% of it (%d kernels); device time per step %.2f ms, %.1f %% "
        "of the unprofiled step (%.2f ms); by group: %s" % (
            tag, steps, smi, wall_us / 1e3, 100.0 * busy / wall_us,
            len(spans), total / steps / 1e3,
            100.0 * total / steps / 1e3 / step_ms, step_ms,
            ", ".join("%s %.2f ms (%.1f %%)" % (
                g, t / steps / 1e3, 100.0 * t / total)
                for g, t in totals.items())))
    log("%s: the largest kernels of no group, a step: %s" % (tag, "; ".join(
        "%.2f ms %s" % (t / steps / 1e3, name[:100]) for name, t in sorted(
            others.items(), key=lambda kv: -kv[1])[:4]) or "none"))
    if count is None:
        return None
    return {key: sum(1 for _, _, name in spans
                     if any(k in name.lower() for k in keys))
            for key, keys, _ in count}


# ----------------------------------------------- compiled LM training (5b)

# the compiled step's f32 check against the eager Trainer loop (phase
# 5b.1): 3 steps, every parameter and Adam state within this share of its
# largest magnitude
COMPILED_TOL = 1e-5
LM_COMPILED_CHECK = 3
# the main path's steps, the step after which it saves the Trainer's
# states (the resumed run takes the steps after it), and the timed turns
LM_COMPILED_STEPS, LM_RESUME_AT = 10, 5
LM_TURNS, LM_TURN_STEPS = 3, 5
# the attention kernels of one step, with the substrings of their device
# kernels' names: once a layer a step
LM_LAUNCH_KERNELS = (("fwd", ("flash_fwd",), LAYERS),
                     ("dq", ("flash_bwd_dq",), LAYERS),
                     ("dkv", ("flash_bwd_dkv",), LAYERS))
# phase 5b's kernel groups: the float16 products are cuBLAS's nvjet
# kernels, and the update's element-wise work is split out
COMPILED_GROUPS = KERNEL_GROUPS[:3] + (
    ("matrix products", ("gemm", "nvjet")), ("softmax", ("softmax",)),
    ("element-wise", ("elementwise_kernel",)),
    ("reductions", ("reduce_kernel",)))
# the other compile-safe optimizers (Adam is the main path's), phase 5b.6
COMPILE_SAFE = (("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3}),
                ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
                ("signum", {"learning_rate": 0.01, "wd_lh": 1e-3}),
                ("adamax", {}), ("ftml", {}), ("ftrl", {}),
                ("rmsprop", {}), ("rmsprop", {"centered": True}),
                ("adagrad", {"learning_rate": 0.1}), ("adadelta", {}))


def _attention_counters():
    from mxnet_tpu_torch.ops import attention as A

    return {"fwd": A.flash_attention, "dq": A.flash_attention_bwd_dq,
            "dkv": A.flash_attention_bwd_dkv}


def _trained_state(net, trainer):
    """Every parameter and every leaf of its optimizer state (float32
    masters first), by name, cloned."""
    from mxnet_tpu_torch.parallel.gluon_step import _leaves

    out = {}
    states = trainer._updaters[0].states
    for i, (name, p) in enumerate(net.collect_params().items()):
        out[name] = p.detach().clone()
        for j, t in enumerate(_leaves(states.get(i))):
            out["%s/state%d" % (name, j)] = t.detach().clone()
    return out


def _compiled_lm(seed, dtype=None, optimizer="adam", **kw):
    from mxnet_tpu_torch import gluon

    net = _lm("cuda", seed)
    if dtype is not None:
        net.cast(dtype)
    kw = dict(kw, learning_rate=kw.get("learning_rate", 1e-3))
    return net, gluon.Trainer(net.collect_params(), optimizer, kw)


def compiled_vs_eager(seed, x, y):
    """Phase 5b.1: float32 Adam through ``trainer.compile`` on the card,
    3 captured steps, against the same compiled step run eagerly (the code
    the graph captures: bitwise) and against the eager Trainer loop
    (record, backward, step) from the same state: every parameter and
    Adam state within COMPILED_TOL of its largest magnitude."""
    from mxnet_tpu_torch import gluon

    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    runs = {}
    for kind in ("captured", "eager step", "eager loop"):
        net, trainer = _compiled_lm(seed)
        if kind == "eager loop":
            losses = [_train_step(net, loss_fn, trainer, x, y)
                      for _ in range(LM_COMPILED_CHECK)]
        else:
            cs = trainer.compile(net, loss_fn)
            cs._capture = kind == "captured"
            losses = [cs.step(x, y).mean() for _ in range(LM_COMPILED_CHECK)]
            graphs = len(cs.graphs) if kind == "captured" else graphs
        torch.cuda.synchronize()
        runs[kind] = ([float(v) for v in losses], _trained_state(net, trainer))
        del net, trainer
        torch.cuda.empty_cache()
    (lc, sc), (le, se), (ll, sl) = (runs[k] for k in (
        "captured", "eager step", "eager loop"))
    differ = [k for k in sc if not torch.equal(sc[k], se[k])]
    errs = {k: _bn_err(sc[k], sl[k])[1] for k in sc}
    worst = max(errs, key=errs.get)
    log("compiled train: float32 Adam, %d captured steps (%d graph) of the "
        "full-width TransformerLM at (%d, %d): losses %s; the step run "
        "eagerly %s, %d of %d tensors differ (bitwise expected); the eager "
        "Trainer loop %s, worst tensor %.3g of its largest magnitude (%s; "
        "tol %.0e), %d of %d bitwise" % (
            LM_COMPILED_CHECK, graphs, TRAIN_BATCH, SEQ, lc, le, len(differ),
            len(sc), ll, errs[worst], worst, COMPILED_TOL,
            sum(torch.equal(sc[k], sl[k]) for k in sc), len(sc)))
    if differ or lc != le or graphs != 1:
        raise AssertionError("the compiled step's replays differ from the "
                             "same step run eagerly: %s" % differ[:5])
    if errs[worst] > COMPILED_TOL:
        raise AssertionError("the compiled step left the eager Trainer "
                             "loop's trajectory")


def compiled_other_optimizers(seed):
    """Phase 5b.6: every other compile-safe optimizer through two steps
    of ``trainer.compile`` on a two-layer MLP (the first captures), against
    the eager Trainer loop from the same state, bitwise."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn as gnn

    def mlp():
        net = gnn.HybridSequential(device="cuda")
        net.add(gnn.Dense(64, activation="relu", in_units=32, device="cuda"))
        net.add(gnn.Dense(10, in_units=64, device="cuda"))
        return net.initialize(seed=seed)

    rng = np.random.RandomState(seed + 23)
    x = torch.from_numpy(rng.randn(16, 32).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 10, (16,)).astype(np.int32)).cuda()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    bad, rows = [], []
    for name, kw in COMPILE_SAFE:
        states = []
        for compiled in (True, False):
            net = mlp()
            trainer = gluon.Trainer(net.collect_params(), name, dict(kw))
            cs = trainer.compile(net, loss_fn) if compiled else None
            for _ in range(2):
                if compiled:
                    cs.step(x, y)
                else:
                    _train_step(net, loss_fn, trainer, x, y)
            states.append(_trained_state(net, trainer))
            if compiled:
                replays = [g.replays for g in cs.graphs.values()]
        torch.cuda.synchronize()
        same = all(torch.equal(states[0][k], states[1][k]) for k in states[0])
        rows.append("%s%s %s" % (name, " centered" if kw.get("centered")
                                 else "", "bitwise" if same else "DIFFER"))
        if not same or replays != [2]:
            bad.append(name)
    log("compiled train: the other compile-safe optimizers, 2 compiled steps "
        "(one graph, 2 replays) on an MLP vs the eager Trainer loop: %s"
        % ", ".join(rows))
    if bad:
        raise AssertionError("compiled steps differ from the eager Trainer "
                             "loop: %s" % bad)


def compiled_train(seed, smi):
    """Phase 5b: ``Trainer.compile`` on the card.  (1) float32 Adam
    against the eager loop; (2) the main path: the full-width
    TransformerLM cast to float16, Adam with ``multi_precision`` (float32
    masters), ``trainer.compile(net, SoftmaxCrossEntropyLoss())``, 10
    steps of ``cs.step(x, y)`` on one fixed (8, 1024) batch, one captured
    graph, the Trainer's states saved after step 5; (3) 3 more replays
    under torch.profiler: K3, K4a and K4b counted (4 each a step), the
    busy share and the time by kernel group; (4) the step time,
    tokens/s and peak memory, then the compiled float16 step and phase
    5's eager float32 step in turns; (5) a new compiled Trainer, and the
    main path's own, loaded from the saved states take steps 6-10
    bitwise as the main path did; (6) the other compile-safe
    optimizers.  Returns the attention
    kernels' counts for the kernels line."""
    import tempfile

    from mxnet_tpu_torch import gluon

    rng = np.random.RandomState(seed + 3)
    x = torch.from_numpy(rng.randint(0, VOCAB, (TRAIN_BATCH, SEQ))
                         .astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, VOCAB, (TRAIN_BATCH, SEQ))
                         .astype(np.float32)).cuda()
    compiled_vs_eager(seed, x, y)

    # 2. the main path
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net, trainer = _compiled_lm(seed, "float16", multi_precision=True)
    tmp = tempfile.TemporaryDirectory()
    states_file = "%s/lm.states" % tmp.name
    cs = trainer.compile(net, loss_fn)
    counters = _attention_counters()
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(LM_COMPILED_STEPS)]
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for i, ev in enumerate(events):
        ev[0].record()
        losses.append(cs.step(x, y))
        ev[1].record()
        if i + 1 == LM_RESUME_AT:
            trainer.save_states(states_file)
            at_resume = {k: v.detach().clone()
                         for k, v in net.state_dict().items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    # ---- end of the main path
    peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [v.float().mean().item() for v in losses]
    final = _trained_state(net, trainer)
    step_ms = float(np.mean([a.elapsed_time(b)
                             for a, b in events[WARMUP_STEPS:]]))
    states = trainer._updaters[0].states
    dtypes = {(str(p.dtype), str(_first(states[i]).dtype))
              for i, p in enumerate(net.collect_params().values())}
    (graph,) = cs.graphs.values()
    log("compiled train: the main path, float16 TransformerLM (vocab %d, "
        "units %d, %d layers, %d heads), Adam lr 1e-3 multi_precision, %d "
        "compiled steps on one (%d, %d) batch: loss %s; weights and "
        "masters %s; %d graph, %d replays; wrapper launches over the main "
        "path %s (the warm-up's and the capture's: %d each expected)" % (
            VOCAB, UNITS, LAYERS, HEADS, LM_COMPILED_STEPS, TRAIN_BATCH, SEQ,
            " ".join("%.4f" % v for v in losses), sorted(dtypes),
            len(cs.graphs), graph.replays, launches, 2 * LAYERS))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("the float16 compiled loss is not finite or "
                             "did not fall")
    if dtypes != {("torch.float16", "torch.float32")}:
        raise AssertionError("the weights are not float16 with float32 "
                             "masters")
    if len(cs.graphs) != 1 or graph.replays != LM_COMPILED_STEPS:
        raise AssertionError("the compiled step recaptured")
    if any(n != 2 * LAYERS for n in launches.values()):
        raise AssertionError("the attention kernels were not in the "
                             "captured step")

    # 3. three more replays under the profiler
    traced = 3
    seen = profile_steps(lambda: cs.step(x, y), smi, step_ms, steps=traced,
                         groups=COMPILED_GROUPS, tag="compiled train",
                         count=LM_LAUNCH_KERNELS)
    want = {k: n * traced for k, _, n in LM_LAUNCH_KERNELS}
    log("compiled train: attention kernels in the trace of %d replays: %s; "
        "expected %s" % (traced, seen, want))
    if seen != want:
        raise AssertionError("the replayed step does not launch K3, K4a and "
                             "K4b once a layer")

    # 4. the step's time, and phase 5's float32 eager step in turns
    log("compiled train: the float16 compiled step %.2f ms on %s (mean of "
        "%d after %d warm-up, CUDA events), %.0f tokens/s; %d steps in "
        "%.2f s wall (the first: warm-up, capture, replay; the save after "
        "step %d); peak memory %.2f GB" % (
            step_ms, smi, LM_COMPILED_STEPS - WARMUP_STEPS, WARMUP_STEPS,
            TRAIN_BATCH * SEQ / step_ms * 1e3, LM_COMPILED_STEPS, wall,
            LM_RESUME_AT, peak))
    net32, trainer32 = _compiled_lm(seed)
    _train_step(net32, loss_fn, trainer32, x, y)
    turns = {"float16 compiled": [], "float32 eager": []}
    for _ in range(LM_TURNS):
        for kind, step in (
                ("float16 compiled", lambda: cs.step(x, y)),
                ("float32 eager",
                 lambda: _train_step(net32, loss_fn, trainer32, x, y))):
            turns[kind].append(time_ms(step, iters=LM_TURN_STEPS))
    log("compiled train: in %d turns of %d steps on %s: %s" % (
        LM_TURNS, LM_TURN_STEPS, smi, "; ".join(
            "%s %s ms" % (k, " ".join("%.2f" % v for v in t))
            for k, t in turns.items())))
    del net32, trainer32
    torch.cuda.empty_cache()

    # 5. steps 6-10 again from the states saved after step 5: through a
    # new net, Trainer and compiled step, and through the main path's own
    # (its graph captured before the load reads the old state tensors:
    # the load drops it, and the next step captures again)
    net2, trainer2 = _compiled_lm(None, "float16", multi_precision=True)
    cs2 = trainer2.compile(net2, loss_fn)
    for kind, n, t, c in (("a new compiled Trainer", net2, trainer2, cs2),
                          ("the main path's Trainer", net, trainer, cs)):
        with torch.no_grad():
            for k, v in n.state_dict().items():
                v.copy_(at_resume[k])
        t.load_states(states_file)
        resumed = [c.step(x, y).float().mean().item()
                   for _ in range(LM_RESUME_AT, LM_COMPILED_STEPS)]
        torch.cuda.synchronize()
        after = _trained_state(n, t)
        differ = [k for k in final if not torch.equal(final[k], after[k])]
        log("compiled train: %s loaded with the states saved after step %d "
            "(%d graph, %d replays): steps %d-%d loss %s (the main path's "
            "%s); %d of %d tensors differ at step %d (bitwise expected)" % (
                kind, LM_RESUME_AT, len(c.graphs),
                next(iter(c.graphs.values())).replays, LM_RESUME_AT + 1,
                LM_COMPILED_STEPS, " ".join("%.4f" % v for v in resumed),
                " ".join("%.4f" % v for v in losses[LM_RESUME_AT:]),
                len(differ), len(final), LM_COMPILED_STEPS))
        if differ or resumed != losses[LM_RESUME_AT:] or len(c.graphs) != 1:
            raise AssertionError("the resumed run differs: %s" % differ[:5])
    tmp.cleanup()
    del net, trainer, cs, net2, trainer2, cs2, final, after, at_resume
    torch.cuda.empty_cache()

    compiled_other_optimizers(seed)
    return {k: dict(launches=n, traced_replays=traced,
                    launches_in_traced_replays=seen[k])
            for k, n in launches.items()}


def _first(state):
    """The first tensor of an optimizer state (a master weight's)."""
    return state if isinstance(state, torch.Tensor) else _first(state[0])


# ---------------------------------------------------------------- ResNet-50

RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000
RESNET_STEPS, RESNET_WARMUP = 10, 2
# the default layout's check (phase 6.2): one captured step against an
# eager one of resnet50_v1() in NCHW at this batch
RESNET_NCHW_BATCH = 8
# ResNet-50's convolutions per training step by formulation, and its one
# max pool (the stem's 3x3/s2/p1)
RESNET_K1A, RESNET_K1B, RESNET_K2 = 44, 9, 1
# K1 vs its plain version: long float32 sums in another order (the stem's
# runs over 1.6 M positions)
DW_TOL = 1e-3
# the parameter gradients of a float32 step on the card vs the CPU plain
# path in predict mode (BatchNorm by its running statistics), within
# GRAD_TOL of each gradient's largest magnitude; a tensor's scale is at
# least GRAD_FLOOR of the largest gradient, for the biases of the
# convolutions that feed a BatchNorm, whose true gradient is 0
GRAD_FLOOR = 1e-3
# In train mode (batch statistics) the gradients at initialisation are
# ill-conditioned: a relative perturbation of 1e-7 in the input moves some
# of them by 10 % on the CPU.  There the card's deviation from the CPU
# (L2 over all gradients) must stay within TRAIN_NOISE_RATIO times the
# CPU's own deviation under such a perturbation (measured on the H100:
# 0.68-0.95 times).
INPUT_NOISE, TRAIN_NOISE_RATIO = 1e-7, 3.0


def _meta_resnet(make):
    """``make`` (a model-zoo entry point, resnet50_v1 by default) in NHWC
    on the meta device."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    return (make or vision.resnet50_v1)(layout="NHWC", device="meta")


def resnet_convs(batch=RESNET_BATCH, size=RESNET_SIZE, make=None):
    """(x shape, kernel, stride, pad, O) of every convolution of
    resnet50_v1 (or of ``make()``'s net) at (batch, size, size, 3), in
    forward order, from a forward on the meta device; the space-to-depth
    stem's as the 4x4 convolution it runs over 12 channels."""
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import _S2DStem
    from mxnet_tpu_torch.gluon.nn import Conv2D

    net = _meta_resnet(make)
    convs = []

    def hook(mod, args, _out):
        kw = mod._kwargs
        convs.append((tuple(args[0].shape), kw["kernel"], kw["stride"],
                      kw["pad"], kw["num_filter"]))

    def s2d_hook(mod, args, _out):
        n, h, w, c = args[0].shape
        convs.append(((n, h // 2 + 3, w // 2 + 3, 4 * c), (4, 4), (1, 1),
                      (0, 0), mod._channels))

    for m in net.modules():
        if isinstance(m, Conv2D):
            m.register_forward_hook(hook)
        elif isinstance(m, _S2DStem):
            m.register_forward_hook(s2d_hook)
    net(torch.empty(batch, size, size, 3, device="meta"))
    return convs


def _out_size(size, k, s, p, d=1):
    return (size + 2 * p - d * (k - 1) - 1) // s + 1


def _taps_read(size, k, s, p, out, d=1):
    """How many of ``size`` input positions along one axis a convolution
    reads: those some output position's tap lands on."""
    return len({y * s + r * d - p for y in range(out) for r in range(k)}
               & set(range(size)))


def conv_dw_bound_ms(xs, k, s, p, o, dtype, d=(1, 1), groups=1):
    """Least time for dW: the pixels of x that the convolution reads (all
    of them unless a stride skips some, as a 1x1 stride-2 convolution
    does) and dy read once and dW (float32, O x KH x KW x I/G) written
    once, against 2 flops per multiply-add (each output channel's over
    its group's I/G inputs) at the card's peak for the inputs' type (bf16
    and float16: the tensor cores; float32: the tensor cores' 3xTF32
    rate)."""
    n, h, w, i = xs
    ig = i // groups
    oh = _out_size(h, k[0], s[0], p[0], d[0])
    ow = _out_size(w, k[1], s[1], p[1], d[1])
    flops = 2.0 * n * oh * ow * o * k[0] * k[1] * ig
    esize = torch.finfo(dtype).bits // 8
    pixels = _taps_read(h, k[0], s[0], p[0], oh, d[0]) * _taps_read(
        w, k[1], s[1], p[1], ow, d[1])
    nbytes = (n * pixels * i + n * oh * ow * o) * esize \
        + o * k[0] * k[1] * ig * 4
    # float32 runs on the tensor cores by 3xTF32
    peak = PEAK_TF32X3_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _nchw(t):
    return t.permute(0, 3, 1, 2)


def conv_kernels(seed):
    """Phase 3c, K1a and K1b: every distinct convolution shape of the main
    path in bf16 (by the formulation rule), two of them in float32, three
    in float16 and a ragged shape in both formulations.  Returns, for each kernel, its
    numbers summed over the convolutions of one training step."""
    from mxnet_tpu_torch.ops import conv_dw as C

    convs = resnet_convs()
    counts = {}
    for c in convs:
        counts[c] = counts.get(c, 0) + 1
    cases = [(c, torch.bfloat16, C.formulation(c[0][3]), n)
             for c, n in counts.items()]
    f32 = [convs[0], next(c for c in convs if c[0][3] >= 128)]
    ragged = ((8, 15, 13, 200), (3, 3), (2, 2), (1, 1), 100)
    cases += [(c, torch.float32, form, 0) for c in f32
              for form in ("pertap", "im2col")]
    cases += [(ragged, dt, form, 0) for dt in (torch.float32, torch.bfloat16)
              for form in ("pertap", "im2col")]
    # float16, the tensor-core kernel's f16 instances: the stem and the
    # 3x3 convolutions of 64 and 512 channels
    f16 = [convs[0]] + [c for c in counts if c[1] == (3, 3)
                        and c[0][3] in (64, 512) and c[2] == (1, 1)]
    cases += [(c, torch.float16, C.formulation(c[0][3]), 0) for c in f16]
    # LeNet's two convolutions (phase 8) and the ConvLSTM cell's two
    # (phase 10), float32, the symbolic paths' shapes
    cases += [(c, torch.float32, C.formulation(c[0][3]), 0)
              for c in LENET_CONVS + [c for c, _ in CONVLSTM_CONVS]]
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    rows = {form: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       library_ms=0.0, launches_per_step=0,
                       bound_by=set()) for form in ("pertap", "im2col")}
    lenet = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=0.0, bound_by=set())
    convlstm = dict(lenet, bound_by=set())
    convlstm_per_call = dict(CONVLSTM_CONVS)
    ws_most = 0
    for (xs, k, s, p, o), dt, form, per_step in cases:
        n, h, w, _ = xs
        dys = (n, _out_size(h, k[0], s[0], p[0]),
               _out_size(w, k[1], s[1], p[1]), o)
        x = torch.randn(xs, device="cuda", generator=gen).to(dt)
        dy = torch.randn(dys, device="cuda", generator=gen).to(dt)
        run = C.conv_dw_pertap if form == "pertap" else C.conv_dw_im2col

        def fn():
            return run(x, dy, k, s, p)

        got, again = fn(), fn()
        torch.cuda.synchronize()
        ref = C.conv_dw_reference(x, dy, k, s, p)
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        same = torch.equal(got, again)
        del got, again, ref
        ms = time_ms(fn)
        plain_ms = time_ms(lambda: C.conv_dw_reference(x, dy, k, s, p),
                           iters=3)
        wt = torch.empty((o,) + k + xs[3:], dtype=dt, device="cuda")
        lib_ms = time_ms(lambda: torch.ops.aten.convolution_backward(
            _nchw(dy), _nchw(x), _nchw(wt), None, s, p, (1, 1), False,
            (0, 0), 1, (False, True, False)))
        bound, bound_by = conv_dw_bound_ms(xs, k, s, p, o, dt)
        plan = C.launch_plan(form, tuple(k), tuple(s), tuple(p), xs, o, dt)
        flops = 2.0 * dys[0] * dys[1] * dys[2] * o * k[0] * k[1] * xs[3]
        if per_step:
            ws_most = max(ws_most, plan.ws_elems * 4)
        log("kernel conv_dw %s [x %s k %s s %s p %s O %d %s, %d a step]: "
            "max_abs_err %.3g of max %.3g (tol %.0e of it), bitwise "
            "repeatable %s; %s kernel, route %s, tile of %d channels, x %s, "
            "dy %s, %d splits of %d, workspace %d bytes; kernel %.4f ms "
            "(%.1f TFLOP/s, %.1f %% of the bound), plain %.4f ms, cuDNN "
            "wgrad %.4f ms, bound %.4f ms (%s)" % (
                form, xs, k, s, p, o, str(dt).split(".")[1], per_step, err,
                scale, DW_TOL, same, plan.kernel, plan.route, plan.tile_o,
                plan.x_loads, plan.dy_loads, plan.splits, plan.chunk,
                plan.ws_elems * 4,
                ms, flops / ms / 1e9, 100.0 * bound / ms, plain_ms, lib_ms,
                bound, bound_by))
        if not err <= DW_TOL * scale:
            raise AssertionError("conv_dw %s disagrees with its plain "
                                 "version at x %s" % (form, xs))
        if not same:
            raise AssertionError("two launches of conv_dw %s differ at x %s"
                                 % (form, xs))
        row = rows[form]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        conv = (xs, k, s, p, o)
        if dt == torch.float32 and (conv in LENET_CONVS
                                    or conv in convlstm_per_call):
            # phases 8 and 10 replay these in captured graphs: device
            # times, summed over a LeNet batch or a ConvLSTM backward
            g = [graph_ms(f) for f in (
                fn, lambda: C.conv_dw_reference(x, dy, k, s, p),
                lambda: torch.ops.aten.convolution_backward(
                    _nchw(dy), _nchw(x), _nchw(wt), None, s, p, (1, 1),
                    False, (0, 0), 1, (False, True, False)))]
            what, sums, n = ("LeNet", lenet, 1) if conv in LENET_CONVS \
                else ("ConvLSTM", convlstm, convlstm_per_call[conv])
            log("kernel conv_dw im2col [%s x %s O %d]: in graph replays "
                "kernel %.4f ms (%.1f %% of the bound), plain %.4f ms, cuDNN "
                "wgrad %.4f ms" % (what, xs, o, g[0], 100.0 * bound / g[0],
                                   g[1], g[2]))
            sums["max_abs_err"] = max(sums["max_abs_err"], err)
            for key, v in (("ms", g[0]), ("plain_ms", g[1]),
                           ("bound_ms", bound), ("library_ms", g[2])):
                sums[key] += n * v
            sums["bound_by"].add(bound_by)
        if per_step:
            for key, v in (("ms", ms), ("plain_ms", plain_ms),
                           ("bound_ms", bound), ("library_ms", lib_ms)):
                row[key] += per_step * v
            row["launches_per_step"] += per_step
            row["bound_by"].add(bound_by)
        del x, dy, wt
    torch.cuda.empty_cache()
    log("kernel conv_dw: the largest workspace at a ResNet-50 shape, %d "
        "bytes" % ws_most)
    for form, row in rows.items():
        row["bound_by"] = "+".join(sorted(row.pop("bound_by")))
        log("kernel conv_dw %s over one ResNet-50 step (%d launches, bf16): "
            "kernel %.3f ms, plain %.3f ms, cuDNN wgrad %.3f ms, bound "
            "%.3f ms" % (form, row.pop("launches_per_step"), row["ms"],
                         row["plain_ms"], row["library_ms"], row["bound_ms"]))
    lenet["bound_by"] = "+".join(sorted(lenet.pop("bound_by")))
    log("kernel conv_dw im2col over one LeNet batch (2 launches, float32; "
        "graph replays): kernel %.4f ms, plain %.4f ms, cuDNN wgrad %.4f ms, "
        "bound %.4f ms"
        % (lenet["ms"], lenet["plain_ms"], lenet["library_ms"],
           lenet["bound_ms"]))
    convlstm["bound_by"] = "+".join(sorted(convlstm.pop("bound_by")))
    log("kernel conv_dw im2col over one ConvLSTM backward (%d launches, "
        "float32; graph replays): kernel %.4f ms, plain %.4f ms, cuDNN wgrad "
        "%.4f ms, bound %.4f ms" % (
            sum(convlstm_per_call.values()), convlstm["ms"],
            convlstm["plain_ms"], convlstm["library_ms"],
            convlstm["bound_ms"]))
    return rows, lenet, convlstm


def _timed_dw(fn, plain, lib):
    """K1 (``fn``) twice against its plain version (``plain``) on the
    card: (max abs error, the plain result's largest magnitude, bitwise
    repeatable, kernel ms, plain ms, ms of ``lib``, the library call)."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    ref = plain()
    scale, err = ref.abs().max().item(), (got - ref).abs().max().item()
    same = torch.equal(got, again)
    del got, again, ref
    return (err, scale, same, time_ms(fn), time_ms(plain, iters=3),
            time_ms(lib))


def _wgrad(x, dy, wt, s, p, groups=1):
    """aten's weight gradient of an NHWC/OHWI convolution (cuDNN's wgrad
    on the channels_last views)."""
    return torch.ops.aten.convolution_backward(
        _nchw(dy), _nchw(x), _nchw(wt), None, s, p, (1, 1), False, (0, 0),
        groups, (False, True, False))


# phase 3c's grouped and transposed shapes: (name, x NHWC, kernel, stride,
# pad, O, groups, transposed).  A transposed convolution's dW is the
# convolution dW of its output's gradient (as x) over its input (as dy) at
# the same stride and pad; its x here is the transposed convolution's input
GROUPED_CONVS = (
    ("ResNeXt 3x3, 32 groups", (RESNET_BATCH, 56, 56, 128), (3, 3), (1, 1),
     (1, 1), 128, 32, False),
    ("MobileNet depthwise 3x3", (RESNET_BATCH, 112, 112, 32), (3, 3),
     (1, 1), (1, 1), 32, 32, False),
    ("2x Conv2DTranspose k4 s2 p1", (32, 56, 56, 64), (4, 4), (2, 2),
     (1, 1), 128, 1, True),
)


def _dw_case(xs, k, s, p, o, groups, transposed):
    """(x, dy shapes, groups) of the conv_dw call of a GROUPED_CONVS row:
    for a transposed convolution the roles swapped."""
    n, h, w, i = xs
    if not transposed:
        return xs, (n, _out_size(h, k[0], s[0], p[0]),
                    _out_size(w, k[1], s[1], p[1]), o), groups
    oh = (h - 1) * s[0] - 2 * p[0] + k[0]
    ow = (w - 1) * s[1] - 2 * p[1] + k[1]
    return (n, oh, ow, o), xs, groups


def grouped_conv_kernels(seed):
    """Phase 3c, K1 grouped and with the roles swapped: the ResNeXt-style
    grouped 3x3, MobileNet's depthwise 3x3 and a 2x transposed
    convolution's dW, in bf16 and float32, each against its plain version
    on the card, bitwise repeatable, timed beside aten's weight gradient
    and the bound; then the path: the three as Gluon layers in bf16
    (Conv2D groups 32, Conv2D groups 32 depthwise, NHWC; Conv2DTranspose,
    NCHW) through one recorded forward and backward, the wrappers' counts
    set to 0 just before it and read just after.  Returns the bf16 rows
    summed over that path by formulation and its launches."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.ops import conv_dw as C

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    rows = {form: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       library_ms=0.0, bound_by=set())
            for form in ("pertap", "im2col")}
    for name, xs0, k, s, p, o0, groups, transposed in GROUPED_CONVS:
        xs, dys, g = _dw_case(xs0, k, s, p, o0, groups, transposed)
        o = dys[3]
        form = C.formulation(xs[3] // g)
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(xs, device="cuda", generator=gen).to(dt)
            dy = torch.randn(dys, device="cuda", generator=gen).to(dt)

            if transposed:
                # aten's weight gradient of the transposed convolution,
                # (I, O/G, KH, KW), over its own input and output gradient
                wt = torch.empty((o, xs[3]) + k, dtype=dt, device="cuda")

                def lib():
                    return torch.ops.aten.convolution_backward(
                        _nchw(x), _nchw(dy), wt, None, s, p, (1, 1), True,
                        (0, 0), 1, (False, True, False))
            else:
                wt = torch.empty((o,) + k + (xs[3] // g,), dtype=dt,
                                 device="cuda")

                def lib():
                    return _wgrad(x, dy, wt, s, p, g)
            err, scale, same, ms, plain_ms, lib_ms = _timed_dw(
                lambda: C.conv_dw(x, dy, k, s, p, (1, 1), g),
                lambda: C.conv_dw_reference(x, dy, k, s, p, (1, 1), g), lib)
            bound, bound_by = conv_dw_bound_ms(xs, k, s, p, o, dt,
                                               groups=g)
            plan = C.launch_plan(form, k, s, p, xs, o, dt, (1, 1), g)
            log("kernel conv_dw %s [%s: x %s dy %s k %s s %s p %s, %d "
                "groups, %s]: max_abs_err %.3g of max %.3g (tol %.0e of "
                "it), bitwise repeatable %s; route %s, tile of %d channels, "
                "x %s, dy %s, %d splits of %d; kernel %.4f ms (%.1f %% of "
                "the bound), plain %.4f ms, aten weight gradient %.4f ms, "
                "bound %.4f ms (%s)" % (
                    form, name, xs, dys, k, s, p, g, str(dt).split(".")[1],
                    err, scale, DW_TOL, same, plan.route, plan.tile_o,
                    plan.x_loads, plan.dy_loads, plan.splits, plan.chunk, ms,
                    100.0 * bound / ms, plain_ms, lib_ms, bound, bound_by))
            if not err <= DW_TOL * scale:
                raise AssertionError("grouped conv_dw disagrees with its "
                                     "plain version at %s %s" % (name, dt))
            if not same:
                raise AssertionError("two launches of grouped conv_dw "
                                     "differ at %s %s" % (name, dt))
            if dt == torch.bfloat16:
                row = rows[form]
                row["max_abs_err"] = max(row["max_abs_err"], err)
                for key, v in (("ms", ms), ("plain_ms", plain_ms),
                               ("bound_ms", bound), ("library_ms", lib_ms)):
                    row[key] += v
                row["bound_by"].add(bound_by)
            del x, dy, wt
    torch.cuda.empty_cache()
    for row in rows.values():
        row["bound_by"] = "+".join(sorted(row.pop("bound_by")))

    # the path: the three as Gluon layers in bf16, one recorded forward
    # and backward each
    layers = []
    for name, xs0, k, s, p, o0, groups, transposed in GROUPED_CONVS:
        n, h, w, i = xs0
        if transposed:
            layer = gnn.Conv2DTranspose(o0, k, s, p, in_channels=i,
                                        use_bias=False, device="cuda")
            x = torch.randn((n, i, h, w), device="cuda", generator=gen)
            x = x.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
        else:
            layer = gnn.Conv2D(o0, k, s, p, groups=groups, in_channels=i,
                               use_bias=False, layout="NHWC", device="cuda")
            x = torch.randn(xs0, device="cuda", generator=gen).to(
                torch.bfloat16)
        layer.initialize(seed=seed)
        layer.cast("bfloat16")
        layers.append((name, layer, x))
    counters = {"pertap": C.conv_dw_pertap, "im2col": C.conv_dw_im2col}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    grads = []
    for name, layer, x in layers:
        with autograd.record():
            out = layer(x)
        torch.autograd.backward(out, torch.ones_like(out))
        grads.append((name, layer.weight.grad))
    torch.cuda.synchronize()
    launches = {key: fn.launches for key, fn in counters.items()}
    # ---- end of the path
    finite = all(bool(torch.isfinite(g).all()) for _, g in grads)
    log("grouped conv path: Conv2D (32 groups), depthwise Conv2D and "
        "Conv2DTranspose in bf16, one recorded forward and backward each: "
        "weight gradients %s, finite %s; wrapper launches %s (expected "
        "im2col 2, pertap 1)" % (
            ", ".join("%s %s" % (n, tuple(g.shape)) for n, g in grads),
            finite, launches))
    if not finite or launches != {"pertap": 1, "im2col": 2}:
        raise AssertionError("the grouped and transposed convolutions did "
                             "not take their weight gradients from K1")
    del layers, grads
    torch.cuda.empty_cache()
    return {k: dict(rows[k], launches=launches[k]) for k in rows}


def maxpool_bound_ms(xs, dys, dtype):
    """Least time for max-pool dX: x and dy read once, dX written once."""
    esize = torch.finfo(dtype).bits // 8
    nbytes = (2 * int(np.prod(xs)) + int(np.prod(dys))) * esize
    return nbytes / PEAK_BYTES * 1e3, "bytes"


def _one_call_kernels(fn):
    """The device kernels one call of ``fn`` launches (torch.profiler),
    and the bytes it allocates on top of what is already allocated."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return names, extra, out


# the cases at which K2 is held bitwise to its plain version: (name, x
# shape, kernel, stride, pad, dtype); x is random normal unless the name
# says otherwise
POOL_CASES = [
    ("stem", (RESNET_BATCH, 112, 112, 64), (3, 3), (2, 2), (1, 1),
     torch.bfloat16),
    ("stem", (RESNET_BATCH, 112, 112, 64), (3, 3), (2, 2), (1, 1),
     torch.float32),
    ("stem", (RESNET_BATCH, 112, 112, 64), (3, 3), (2, 2), (1, 1),
     torch.float16),
    ("all ties", (4, 16, 16, 64), (3, 3), (2, 2), (1, 1), torch.float32),
    ("odd", (3, 9, 11, 5), (3, 3), (2, 2), (1, 1), torch.bfloat16),
    ("2x2/s2", (32, 56, 56, 64), (2, 2), (2, 2), (0, 0), torch.bfloat16),
    ("3x3/s1/p1", (32, 56, 56, 64), (3, 3), (1, 1), (1, 1), torch.bfloat16),
    ("7x7/s2/p3", (8, 56, 56, 128), (7, 7), (2, 2), (3, 3), torch.float32),
    ("NaN input", (16, 56, 56, 64), (3, 3), (2, 2), (1, 1), torch.bfloat16),
    # pad 2 >= kernel 2: the first window of each axis lies wholly in the
    # padding, so its dy reaches no pixel
    ("window in padding", (4, 8, 8, 16), (2, 2), (2, 2), (2, 2),
     torch.float16),
    # LeNet's two pools (phase 8): C = 20 takes the 16-byte route, C = 50
    # the scalar one
    ("lenet pool1", (SYM_BATCH, 24, 24, 20), (2, 2), (2, 2), (0, 0),
     torch.float32),
    ("lenet pool2", (SYM_BATCH, 8, 8, 50), (2, 2), (2, 2), (0, 0),
     torch.float32),
]


def pool_kernels(seed):
    """Phase 3c, K2: the stem pool's shape in bf16 (the main path's),
    float32 and float16, an all-ties input, an odd shape, windows 2x2/s2,
    3x3/s1 and 7x7, NaN inputs and windows wholly in the padding; each
    bitwise equal to the plain version and to itself across two launches.
    At the stem shape one call launches one kernel and allocates nothing
    but dX.  Returns the main path's row."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import pool_bwd as P

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    row = None
    lenet = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                 library_ms=0.0, bound_by="bytes")
    for name, xs, k, s, p, dt in POOL_CASES:
        n, h, w, c = xs
        dys = (n, _out_size(h, k[0], s[0], p[0]),
               _out_size(w, k[1], s[1], p[1]), c)
        x = (torch.ones(xs, device="cuda") if name == "all ties"
             else torch.randn(xs, device="cuda", generator=gen))
        if name == "NaN input":  # NaN at some taps, the first among them
            x[:, ::3, ::2, ::5] = float("nan")
        x = x.to(dt)
        dy = torch.randn(dys, device="cuda", generator=gen).to(dt)

        def fn():
            return P.maxpool_bwd(x, dy, k, s, p)

        got, again = fn(), fn()
        torch.cuda.synchronize()
        ref = P.maxpool_bwd_reference(x, dy, k, s, p)
        err = (got.float() - ref.float()).abs().max().item()
        equal, same = torch.equal(got, ref), torch.equal(got, again)
        del got, again, ref
        plan = P.launch_plan(xs, dys, k, s, dt)
        ms = time_ms(fn)
        plain_ms = time_ms(lambda: P.maxpool_bwd_reference(x, dy, k, s, p),
                           iters=3)
        lib_ms = None
        if 2 * p[0] <= k[0] and 2 * p[1] <= k[1]:  # what max_pool2d takes
            _, idx = F.max_pool2d(_nchw(x), k, s, p, return_indices=True)
            lib_ms = time_ms(
                lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    _nchw(dy), _nchw(x), k, s, p, (1, 1), False, idx))
            del idx
        bound, bound_by = maxpool_bound_ms(xs, dys, dt)
        log("kernel maxpool_bwd [%s x %s k %s s %s p %s %s]: bitwise equal "
            "to the plain version %s (max abs err %.3g), bitwise repeatable "
            "%s; %s, tile %dx%dx%d, %d tiles, %d bytes of shared memory; "
            "kernel %.4f ms (%.1f %% of the bound), plain %.4f ms, "
            "max_pool2d_with_indices_backward %s ms, bound %.4f ms (%s)" % (
                name, xs, k, s, p, str(dt).split(".")[1], equal, err, same,
                plan.access, plan.tile_h, plan.tile_w, plan.tile_c,
                plan.tiles(n), plan.smem_bytes, ms, 100.0 * bound / ms,
                plain_ms, "%.4f" % lib_ms if lib_ms is not None else "n/a",
                bound, bound_by))
        if not (equal and same):
            raise AssertionError("maxpool_bwd differs from its plain version "
                                 "or between two launches at %s %s"
                                 % (name, dt))
        if name == "stem" and dt == torch.bfloat16:
            names, extra, out = _one_call_kernels(fn)
            dx_bytes = out.numel() * out.element_size()
            log("kernel maxpool_bwd [stem bf16]: one call launches %s and "
                "allocates %d bytes (dX: %d)" % (names, extra, dx_bytes))
            if len(names) != 1 or "maxpool_bwd_kernel" not in names[0] \
                    or extra > dx_bytes + (2 << 20):
                raise AssertionError("maxpool_bwd is not one launch that "
                                     "allocates only dX")
            del out
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": lib_ms}
        if name.startswith("lenet"):
            # phase 8 replays these in a captured graph: device times
            _, idx = F.max_pool2d(_nchw(x), k, s, p, return_indices=True)
            g = [graph_ms(f) for f in (
                fn, lambda: P.maxpool_bwd_reference(x, dy, k, s, p),
                lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                    _nchw(dy), _nchw(x), k, s, p, (1, 1), False, idx))]
            log("kernel maxpool_bwd [%s]: in graph replays kernel %.4f ms "
                "(%.1f %% of the bound), plain %.4f ms, "
                "max_pool2d_with_indices_backward %.4f ms" % (
                    name, g[0], 100.0 * bound / g[0], g[1], g[2]))
            del idx
            lenet["max_abs_err"] = max(lenet["max_abs_err"], err)
            for key, v in (("ms", g[0]), ("plain_ms", g[1]),
                           ("bound_ms", bound), ("library_ms", g[2])):
                lenet[key] += v
        del x, dy
    torch.cuda.empty_cache()
    log("kernel maxpool_bwd over one LeNet batch (2 launches, float32; "
        "graph replays): kernel %.4f ms, plain %.4f ms, "
        "max_pool2d_with_indices_backward %.4f ms, bound %.4f ms" % (lenet["ms"], lenet["plain_ms"],
                                    lenet["library_ms"], lenet["bound_ms"]))
    return row, lenet


def resnet_bns(batch=RESNET_BATCH, size=RESNET_SIZE, make=None):
    """The (N, H, W, C) input of every BatchNorm of resnet50_v1 (or of
    ``make()``'s net) at (batch, size, size, 3), in forward order, from a
    forward on the meta device."""
    from mxnet_tpu_torch.gluon.nn import BatchNorm

    net = _meta_resnet(make)
    shapes = []
    for m in net.modules():
        if isinstance(m, BatchNorm):
            m.register_forward_hook(
                lambda _m, args, _o: shapes.append(tuple(args[0].shape)))
    net(torch.empty(batch, size, size, 3, device="meta"))
    return shapes


# K6a/K6b vs their plain versions on the card, of the plain result's
# largest magnitude: two steps of the type for bf16 and float16 (a float32
# sum in another order may move a rounded mean, var or scale by one step);
# float32 sums over up to 1.6 M rows in another order
BN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6,
          torch.float16: 2.0 ** -9}
BN_EPS, BN_MOMENTUM = 1e-5, 0.9
# ResNet-50's BatchNorms per training step (its convolutions': 53)
RESNET_BN = 53
# the stem's and layer 4's (M, C) at batch 128
BN_STEM, BN_LAST = (RESNET_BATCH * 112 * 112, 64), (RESNET_BATCH * 49, 2048)


def bn_bound_ms(m, c, dtype, passes):
    """Least time for ``passes`` tensors of (m, c) elements read or written
    once (the forward reads x and writes y: 2; the backward reads x and dy
    and writes dx: 3); the per-channel vectors are left out."""
    esize = torch.finfo(dtype).bits // 8
    return passes * m * c * esize / PEAK_BYTES * 1e3, "bytes"


def _bn_err(got, ref):
    """max |got - ref| and the share of ref's largest magnitude."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def bn_occupancy(occ, m, c, dtype):
    """The blocks an SM that the occupancy API allows the kernel of
    ``occ`` (a plan's ops/batch_norm.py Occupancy: K6a's or K6b's), held
    to what the plan assumes co-resident: at least its blocks an SM, its
    grid within them on the card's SMs."""
    import ctypes

    from mxnet_tpu_torch import _kernels

    lib = _kernels.library("batch_norm")
    blocks = ctypes.c_int()
    err = getattr(lib, occ.entry)(*occ.args, ctypes.byref(blocks))
    if err:
        raise AssertionError("%s failed: %s"
                             % (occ.entry, lib.mxt_error_string(err).decode()))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if blocks.value < occ.blocks_per_sm or occ.grid > sms * occ.blocks_per_sm:
        raise AssertionError("the plan %s is not co-resident on %d SMs at "
                             "M %d C %d %s: the occupancy API allows %d "
                             "blocks an SM" % (occ, sms, m, c, dtype,
                                               blocks.value))
    return blocks.value


def one_launch_a_call(cases, gen):
    """One call of K6a (train mode at each case; predict mode at the first
    case of each type) and one of K6b at each case, in one torch.profiler
    session: each call is one device kernel, bn_fwd_kernel or
    bn_bwd_kernel."""
    from torch.profiler import ProfilerActivity, profile

    from mxnet_tpu_torch.ops import batch_norm as B

    calls, predict, types = [], [], set()
    for m, c, dt, _ in cases:
        x = torch.randn(m, c, device="cuda", generator=gen).to(dt)
        gamma = torch.ones(c, device="cuda", dtype=dt)
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        stats = B.batch_norm_fwd(x, gamma, gamma, rm, rv, BN_EPS, False,
                                 False)[3]
        calls.append((x, torch.randn_like(x), stats, gamma, rm, rv))
        if dt not in types:
            types.add(dt)
            predict.append(calls[-1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x, _, _, gamma, rm, rv in calls:
            B.batch_norm_fwd(x, gamma, gamma, rm, rv, BN_EPS, False, False,
                             BN_MOMENTUM)
        for x, _, _, gamma, rm, rv in predict:
            B.batch_norm_fwd(x, gamma, gamma, rm, rv, BN_EPS, False, True)
        for x, dy, stats, gamma, _, _ in calls:
            B.batch_norm_bwd(x, dy, stats, gamma, gamma, False, True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    n_fwd = len(calls) + len(predict)
    ok = (len(names) == n_fwd + len(calls)
          and all("bn_fwd_kernel" in n for n in names[:n_fwd])
          and all("bn_bwd_kernel" in n for n in names[n_fwd:]))
    for kernel, part, n in (("fwd", names[:n_fwd], n_fwd),
                            ("bwd", names[n_fwd:], len(calls))):
        log("kernel batch_norm_%s: %d calls at %d shapes in one profiler "
            "session launch %d device kernels (%s)" % (
                kernel, n, len(calls), len(part),
                ", ".join(sorted(set(
                    re.search(r"bn_%s_kernel<[^>]*>" % kernel, x)[0]
                    if "bn_%s_kernel<" % kernel in x else x for x in part)))))
    if not ok:
        raise AssertionError("a K6a or K6b call is not one device kernel: "
                             "%d kernels for %d calls" % (
                                 len(names), n_fwd + len(calls)))
    del calls, predict
    torch.cuda.empty_cache()


def bn_kernels(seed):
    """Phase 3d, K6a and K6b: every distinct BatchNorm shape of the main
    path in bf16 (bf16 gamma and beta, as the step's casts make them), each
    in float32 and float16 too (timed at the stem and layer 4), C = 5 (the
    scalar path) and a tiny M; each against its plain version on the card (within BN_TOL of
    its largest magnitude) and bitwise equal across two launches, with its
    plan, time, the plain version's, the library call's and the bound;
    axis=1 on NCHW data with channels_last strides runs them too
    (:func:`bn_axis_1`).  Returns, for each kernel, its numbers summed
    over the BatchNorms of one training step of ResNet-50 v1 (phase 6) and
    of v2 (phase 6b, whose raw input's BatchNorm, C = 3, runs K6a alone:
    neither its input nor its fixed gamma and beta need a gradient)."""
    from mxnet_tpu_torch.ops import batch_norm as B

    counts = {}
    for n, h, w, c in resnet_bns():
        counts[(n * h * w, c)] = counts.get((n * h * w, c), 0) + 1
    v2 = {"fwd": {}, "bwd": {}}
    for i, (n, h, w, c) in enumerate(resnet_bns(make=_resnet50_v2)):
        for key in ("fwd", "bwd") if i else ("fwd",):
            v2[key][(n * h * w, c)] = v2[key].get((n * h * w, c), 0) + 1
    cases = [(m, c, torch.bfloat16, k) for (m, c), k in counts.items()]
    cases += [(m, c, torch.bfloat16, 0) for m, c in v2["fwd"]
              if (m, c) not in counts]
    cases += [(m, c, dt, 0) for m, c in counts
              for dt in (torch.float32, torch.float16)]
    cases += [(792, 5, torch.bfloat16, 0), (792, 5, torch.float32, 0),
              (3, 64, torch.bfloat16, 0)]
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                    library_ms=0.0, bound_by="bytes")
            for k in ("fwd", "bwd")}
    rows_v2 = {k: dict(v) for k, v in rows.items()}
    fwd_times, bwd_times = [], []
    for m, c, dt, per_step in cases:
        on_v2 = dt == torch.bfloat16 and (m, c) in v2["fwd"]
        pdt = dt  # gamma and beta in the data's type, as the step casts them
        x = (torch.randn(m, c, device="cuda", generator=gen) * 2 + 0.5).to(dt)
        dy = torch.randn(m, c, device="cuda", generator=gen).to(dt)
        gamma = (1 + 0.1 * torch.randn(c, device="cuda", generator=gen)).to(
            pdt)
        beta = (0.1 * torch.randn(c, device="cuda", generator=gen)).to(pdt)
        rm = torch.zeros(c, device="cuda")
        rv = torch.ones(c, device="cuda")

        def fwd(run=B.batch_norm_fwd):
            m_, v_ = rm.clone(), rv.clone()
            out = run(x, gamma, beta, m_, v_, BN_EPS, False, False,
                      BN_MOMENTUM)
            return out + (m_, v_)

        got, again = fwd(), fwd()
        ref = fwd(B.batch_norm_fwd_plain)
        stats = got[3]

        def bwd(run=B.batch_norm_bwd):
            return run(x, dy, stats, gamma, beta, False, True)

        gotb, againb = bwd(), bwd()
        refb = bwd(B.batch_norm_bwd_plain)
        torch.cuda.synchronize()
        tol = BN_TOL[dt]
        # y, mean, var, the running mean and var; dx, dgamma, dbeta
        errs = [_bn_err(got[i], ref[i]) for i in (0, 1, 2, 4, 5)]
        errsb = [_bn_err(g, r) for g, r in zip(gotb, refb)]
        same = all(torch.equal(a, b) for a, b in zip(got, again)) and all(
            torch.equal(a, b) for a, b in zip(gotb, againb))
        equal_y = (got[0] == ref[0]).float().mean().item()
        del again, ref, againb, refb
        plan = B.launch_plan(
            m, c, dt, True,
            torch.cuda.get_device_properties(0).multi_processor_count)
        code = B._DTYPE_CODES[dt]
        occupancy = bn_occupancy(plan.bwd_occupancy(code), m, c, dt)
        occ_fwd = bn_occupancy(plan.fwd_occupancy(code), m, c, dt)
        tol = BN_TOL[dt]
        if not (per_step or on_v2 or (m, c) in (BN_STEM, BN_LAST)):
            # checked, not timed: the other shapes in float32 and float16
            log("kernel batch_norm [M %d C %d %s]: K6a %d blocks, %d "
                "rounds kept, K6b %s, %d blocks; errs "
                "(share of the largest magnitude) y %.3g mean %.3g var %.3g "
                "running mean %.3g var %.3g, dx %.3g dgamma %.3g dbeta %.3g "
                "(tol %.3g); bitwise repeatable %s" % (
                    m, c, str(dt).split(".")[1], plan.fwd_grid,
                    plan.fwd_kept_rounds, plan.route, plan.bwd_grid,
                    *(e[1] for e in errs + errsb), tol, same))
            if any(e[1] > tol for e in errs + errsb) or not same:
                raise AssertionError("batch_norm disagrees with its plain "
                                     "version or does not repeat at M %d C "
                                     "%d %s" % (m, c, dt))
            del x, dy, got, gotb
            continue

        def fwd_k():
            return B.batch_norm_fwd(x, gamma, beta, rm, rv, BN_EPS, False,
                                    False, BN_MOMENTUM)

        # the kernels and the library call in graph replays (device time,
        # as in the captured step); the wrappers eagerly, for the record
        ms, ms_b = graph_ms(fwd_k), graph_ms(bwd)
        eager_ms, eager_b = time_ms(fwd_k), time_ms(bwd)
        plain_ms = time_ms(lambda: fwd(B.batch_norm_fwd_plain), iters=3)
        plain_b = time_ms(lambda: bwd(B.batch_norm_bwd_plain), iters=3)
        # the library: aten's batch norm on the same (M, C) tensors, float32
        # weights and running statistics (other rounding points: a
        # yardstick of time only)
        w32, b32 = gamma.float(), beta.float()
        lrm, lrv = rm.clone(), rv.clone()
        _, save_mean, save_invstd = torch.ops.aten.native_batch_norm(
            x, w32, b32, lrm, lrv, True, 1 - BN_MOMENTUM, BN_EPS)
        lib_ms = graph_ms(lambda: torch.ops.aten.native_batch_norm(
            x, w32, b32, lrm, lrv, True, 1 - BN_MOMENTUM, BN_EPS))
        lib_b = graph_ms(lambda: torch.ops.aten.native_batch_norm_backward(
            dy, x, w32, lrm, lrv, save_mean, save_invstd, True, BN_EPS,
            [True, True, True]))
        bound, _ = bn_bound_ms(m, c, dt, 2)
        bound_b, _ = bn_bound_ms(m, c, dt, 3)
        log("kernel batch_norm [M %d C %d %s, %d a step]: %s, %d threads a "
            "row, %d channel tiles of %d, %d splits of %d rows; K6a "
            "streamed, %d rounds kept, one launch of %d blocks, %d bytes of "
            "dynamic shared memory, %d blocks an SM by plan (occupancy API: "
            "%d); "
            "K6b %s, %d "
            "splits a block, one launch of %d blocks, %d bytes of dynamic "
            "shared memory, %d blocks an SM by plan (occupancy API: %d); "
            "fwd errs "
            "(share of the largest magnitude) y %.3g mean %.3g var %.3g "
            "running mean %.3g var %.3g, y bitwise equal to the plain "
            "version at %.4f of its elements; bwd errs dx %.3g dgamma %.3g "
            "dbeta %.3g (tol %.3g); bitwise repeatable %s; in graph "
            "replays K6a %.4f ms (%.1f %% of the bound %.4f), "
            "native_batch_norm %.4f, K6b %.4f ms (%.1f %% of the bound "
            "%.4f), native_batch_norm_backward %.4f; eager wrapper calls "
            "K6a %.4f, K6b %.4f; plain %.4f and %.4f" % (
                m, c, str(dt).split(".")[1], per_step, plan.access,
                plan.tpr, plan.channel_tiles, plan.tile_c, plan.splits,
                plan.rows, plan.fwd_kept_rounds, plan.fwd_grid,
                plan.fwd_smem, plan.fwd_blocks_per_sm, occ_fwd, plan.route,
                plan.splits_per_block,
                plan.bwd_grid, plan.bwd_smem, plan.blocks_per_sm,
                occupancy, *(e[1] for e in errs), equal_y,
                *(e[1] for e in errsb), tol, same, ms, 100.0 * bound / ms,
                bound, lib_ms, ms_b, 100.0 * bound_b / ms_b, bound_b, lib_b,
                eager_ms, eager_b, plain_ms, plain_b))
        if any(e[1] > tol for e in errs + errsb):
            raise AssertionError("batch_norm disagrees with its plain version "
                                 "at M %d C %d %s" % (m, c, dt))
        if not same:
            raise AssertionError("two launches of batch_norm differ at M %d "
                                 "C %d %s" % (m, c, dt))
        check_share("batch_norm_fwd", (m, c, dt), ms, bound)
        check_share("batch_norm_bwd", (m, c, dt), ms_b, bound_b)
        if per_step or on_v2 or (m, c) in (BN_STEM, BN_LAST):
            fwd_times.append((m, c, str(dt).split(".")[1], "streamed", ms,
                              bound, lib_ms))
            bwd_times.append((m, c, str(dt).split(".")[1], plan.route, ms_b,
                              bound_b, lib_b))
        for key, row, vals, err in (
                ("fwd", rows["fwd"], (ms, plain_ms, bound, lib_ms),
                 errs[0][0]),
                ("bwd", rows["bwd"], (ms_b, plain_b, bound_b, lib_b),
                 errsb[0][0])):
            row["max_abs_err"] = max(row["max_abs_err"], err)
            for name, v in zip(("ms", "plain_ms", "bound_ms", "library_ms"),
                               vals):
                row[name] += per_step * v
            n_v2 = v2[key].get((m, c), 0) if on_v2 else 0
            if n_v2:
                row2 = rows_v2[key]
                row2["max_abs_err"] = max(row2["max_abs_err"], err)
                for name, v in zip(("ms", "plain_ms", "bound_ms",
                                    "library_ms"), vals):
                    row2[name] += n_v2 * v
        del x, dy, got, gotb
    torch.cuda.empty_cache()
    for name, times in (("batch_norm_fwd (K6a)", fwd_times),
                        ("batch_norm_bwd (K6b)", bwd_times)):
        log("kernel %s by shape, in graph replays: %s" % (name, "; ".join(
            "M %d C %d %s %s %.4f ms (%.1f %% of %.4f), aten %.4f" % (
                m, c, dt, route, t, 100.0 * bound / t, bound, lib)
            for m, c, dt, route, t, bound, lib in times)))
    one_launch_a_call(cases, gen)
    for key, row in rows.items():
        log("kernel batch_norm %s over one ResNet-50 step (%d BatchNorms, "
            "bf16; kernel and library in graph replays): kernel %.3f ms, "
            "plain %.3f ms, library %.3f ms, bound %.3f ms" % (
                key, sum(counts.values()), row["ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"]))
    for key, row in rows_v2.items():
        log("kernel batch_norm %s over one ResNet-50 v2 step (%d launches, "
            "bf16; kernel and library in graph replays): kernel %.3f ms, "
            "plain %.3f ms, library %.3f ms, bound %.3f ms" % (
                key, sum(v2[key].values()), row["ms"], row["plain_ms"],
                row["library_ms"], row["bound_ms"]))
    bn_axis_1(gen)
    return rows, rows_v2


def bn_axis_1(gen):
    """BatchNorm over axis 1 of NCHW data that lies channels_last in
    memory (SSD's and every default-layout Gluon CNN's): one K6a and one
    K6b launch on its NHWC view, with no copy of x, each output equal to
    the plain version's within BN_TOL and, bit for bit, to the same call
    on the NHWC tensor over its last axis."""
    from mxnet_tpu_torch.ops import batch_norm as B
    from mxnet_tpu_torch.ops import nn as N

    n, c, h, w = SSD_BATCH, 512, 38, 38      # SSD300's relu4_3
    x = torch.randn(n, h, w, c, device="cuda", generator=gen)
    dy = torch.randn(n, h, w, c, device="cuda", generator=gen)
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    beta = torch.randn(c, device="cuda", generator=gen)
    outs = {}
    for name, data, grad, axis in (("nchw", x.permute(0, 3, 1, 2),
                                    dy.permute(0, 3, 1, 2), 1),
                                   ("nhwc", x, dy, -1)):
        data = data.detach().requires_grad_()
        g, b = (t.clone().requires_grad_() for t in (gamma, beta))
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        launched = (B.batch_norm_fwd.launches, B.batch_norm_bwd.launches)
        y = N.batch_norm(data, g, b, rm, rv, eps=BN_EPS, fix_gamma=False,
                         axis=axis, momentum=BN_MOMENTUM)[0]
        dx, dg, db = torch.autograd.grad(y, (data, g, b), grad)
        launched = (B.batch_norm_fwd.launches - launched[0],
                    B.batch_norm_bwd.launches - launched[1])
        outs[name] = (y, dx, dg, db, rm, rv, launched)
    y, dx, dg, db, rm, rv, launched = outs["nchw"]
    x2 = x.reshape(-1, c)
    ref_y, _, _, stats = B.batch_norm_fwd_plain(
        x2, gamma, beta, torch.zeros(c, device="cuda"),
        torch.ones(c, device="cuda"), BN_EPS, False, False)
    ref_dx, ref_dg, ref_db = B.batch_norm_bwd_plain(
        x2, dy.reshape(-1, c), stats, gamma, beta, False, True)
    errs = [_bn_err(got, ref)[1] for got, ref in (
        (y.permute(0, 2, 3, 1).reshape(-1, c), ref_y),
        (dx.permute(0, 2, 3, 1).reshape(-1, c), ref_dx), (dg, ref_dg),
        (db, ref_db))]
    same = all(torch.equal(a, b) for a, b in zip(
        (y.permute(0, 2, 3, 1), dx.permute(0, 2, 3, 1), dg, db, rm, rv),
        outs["nhwc"][:6]))
    log("kernel batch_norm [axis 1 of NCHW channels_last x (%d, %d, %d, %d) "
        "float32]: K6a and K6b launches %s, y and dx channels_last %s, "
        "largest error against the plain version %.3g of its magnitude "
        "(tol %.0e), bitwise equal to the NHWC call over the last axis %s"
        % (n, c, h, w, launched,
           y.is_contiguous(memory_format=torch.channels_last)
           and dx.is_contiguous(memory_format=torch.channels_last),
           max(errs), BN_TOL[torch.float32], same))
    if launched != (1, 1) or max(errs) > BN_TOL[torch.float32] or not same \
            or not y.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError("BatchNorm over axis 1 on the card did not run "
                             "K6a and K6b on the NHWC view")


def _resnet50_v2(**kwargs):
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v2

    return resnet50_v2(**kwargs)


def _resnet(device, seed=None, layout="NHWC", make=None, **kwargs):
    """resnet50_v1 (or ``make``'s net) on ``device``, initialised from
    ``seed`` unless it is None."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    net = (make or resnet50_v1)(layout=layout, device=device, **kwargs)
    return net if seed is None else net.initialize(seed=seed)


def _resnet_grads(net, x, y, train):
    """The float32 gradients of one forward and backward in train or
    predict mode, by parameter name, on the CPU."""
    from mxnet_tpu_torch import autograd, gluon

    params = {k: p for k, p in net.collect_params().items()
              if p.grad_req != "null"}
    with autograd.record(train_mode=train):
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(net(x), y).mean()
    return {k: g.detach().cpu() for k, g in
            zip(params, torch.autograd.grad(loss, list(params.values())))}


def _l2_rel(got, want):
    """|got - want| / |want| over all tensors together."""
    num = sum(float(((got[k].double() - w.double()) ** 2).sum())
              for k, w in want.items())
    return (num / sum(float((w.double() ** 2).sum())
                      for w in want.values())) ** 0.5


def resnet_gradient_check(seed, make=None, tag="resnet"):
    """Phase 6.1 (and 6b's, ``make`` resnet50_v2): float32 (TF32 off)
    gradients of ResNet-50 at (4, 64, 64, 3) on the card against the same
    weights on the CPU plain path, in predict mode (each within GRAD_TOL)
    and in train mode (within TRAIN_NOISE_RATIO of the CPU's own rounding
    sensitivity)."""
    from mxnet_tpu_torch.convert import load_mxnet_tpu_params

    rng = np.random.RandomState(seed + 5)
    net = _resnet("cuda", seed, make=make)
    state = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    cpu_net = _resnet("cpu", make=make)
    x = rng.rand(4, 64, 64, 3).astype(np.float32)
    y = torch.from_numpy(rng.randint(0, RESNET_CLASSES, (4,)).astype(np.int32))
    x_noisy = (x * (1 + INPUT_NOISE * rng.randn(*x.shape))).astype(np.float32)
    for train in (False, True):
        load_mxnet_tpu_params(net, state)
        load_mxnet_tpu_params(cpu_net, state)
        got = _resnet_grads(net, torch.from_numpy(x).cuda(), y.cuda(), train)
        want = _resnet_grads(cpu_net, torch.from_numpy(x), y, train)
        big = max(g.abs().max().item() for g in want.values())
        rel = {name: (got[name] - g).abs().max().item()
               / max(g.abs().max().item(), GRAD_FLOOR * big)
               for name, g in want.items()}
        worst = max(rel, key=rel.get)
        l2 = _l2_rel(got, want)
        mode = "train" if train else "predict"
        if not train:
            log("%s: float32 %s-mode gradients of %d parameters on the "
                "card vs the CPU plain path on a (4, 64, 64, 3) batch: "
                "worst %.3g of the gradient's largest magnitude (%s; tol "
                "%.0e; each scale at least %.0e of the largest gradient, "
                "%.3g); L2 over all %.3g" % (tag, mode, len(want), rel[worst],
                                             worst, GRAD_TOL, GRAD_FLOOR,
                                             big, l2))
            if rel[worst] > GRAD_TOL:
                raise AssertionError("the card's ResNet-50 gradients "
                                     "disagree with the CPU plain path")
            continue
        load_mxnet_tpu_params(cpu_net, state)
        noise = _l2_rel(_resnet_grads(cpu_net, torch.from_numpy(x_noisy), y,
                                      True), want)
        log("%s: float32 %s-mode gradients on the card vs the CPU: L2 "
            "over all %.3g, worst tensor %.3g (%s); the CPU's own L2 change "
            "under a %.0e input perturbation %.3g (ratio %.2f, limit %.1f)"
            % (tag, mode, l2, rel[worst], worst, INPUT_NOISE, noise,
               l2 / noise, TRAIN_NOISE_RATIO))
        if not l2 <= TRAIN_NOISE_RATIO * noise:
            raise AssertionError("the card's train-mode ResNet-50 gradients "
                                 "are farther from the CPU's than rounding "
                                 "noise explains")


# device kernels of the ResNet step by what they do, matched on the
# kernel's name (the first group that matches wins)
RESNET_GROUPS = (
    ("K6a batch_norm fwd", ("bn_fwd_kernel",)),
    ("K6b batch_norm bwd", ("bn_bwd_kernel",)),
    # template arguments: the type (false bf16, true float16), then the
    # formulation (false per-tap, true im2col)
    ("K1a conv_dw pertap", ("conv_dw_wgmma_kernel<false, false",
                            "conv_dw_wgmma_kernel<true, false",
                            "conv_dw_tf32_kernel<false")),
    ("K1b conv_dw im2col", ("conv_dw_wgmma_kernel<false, true",
                            "conv_dw_wgmma_kernel<true, true",
                            "conv_dw_tf32_kernel<true")),
    ("K1 split-K sum", ("conv_dw_reduce",)),
    ("K2 maxpool_bwd", ("maxpool_bwd_kernel",)),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("loss softmax", ("softmax", "nll")),
    ("cuDNN conv fwd/dgrad", ("conv", "cudnn", "xmma", "fprop", "dgrad",
                              "implicit", "gemm", "cutlass", "sm90")),
    ("pooling fwd", ("pool",)),
    ("ReLU, casts and other element-wise/reductions",
     ("elementwise", "reduce", "vectorized", "copy", "fill", "cat")),
)
# one kernel of each wrapper's launch, by name, to count launches per step
# in a trace of graph replays: (wrapper, name substrings, launches a step)
RESNET_LAUNCH_KERNELS = (
    ("batch_norm_fwd", ("bn_fwd_kernel",), RESNET_BN),
    ("batch_norm_bwd", ("bn_bwd_kernel",), RESNET_BN),
    ("pertap", ("conv_dw_wgmma_kernel<false, false",
                "conv_dw_wgmma_kernel<true, false",
                "conv_dw_tf32_kernel<false"),
     RESNET_K1A),
    ("im2col", ("conv_dw_wgmma_kernel<false, true",
                "conv_dw_wgmma_kernel<true, true",
                "conv_dw_tf32_kernel<true"),
     RESNET_K1B),
    ("maxpool", ("maxpool_bwd_kernel",), RESNET_K2),
)


def _resnet_counters():
    from mxnet_tpu_torch.ops import batch_norm as B
    from mxnet_tpu_torch.ops import conv_dw as C
    from mxnet_tpu_torch.ops import pool_bwd as P

    return {"pertap": C.conv_dw_pertap, "im2col": C.conv_dw_im2col,
            "maxpool": P.maxpool_bwd, "batch_norm_fwd": B.batch_norm_fwd,
            "batch_norm_bwd": B.batch_norm_bwd}


def _step_state(net, step):
    return [t.detach().clone() for t in list(net.state_dict().values())
            + step.opt_state]


def captured_vs_eager(seed, x, y, steps=3, layout="NHWC"):
    """Phase 6.2: ``steps`` captured steps against as many eager steps
    from the same state, bitwise (losses, weights, running statistics,
    momentum), of ResNet-50 in ``layout``; then, in NHWC, 3 more eager
    steps, timed.  Returns the eager step's time (None in NCHW)."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import GluonTrainStep

    runs = {}
    eager_ms = None
    for capture in (False, True):
        net = _resnet("cuda", seed, layout)
        step = GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                              mesh=None, lr=0.1, momentum=0.9, wd=1e-4,
                              compute_dtype="bfloat16")
        xs, ys = step.put_batch(x, y)
        # the eager side runs the code that the graph captures
        run = step if capture else step._eager
        out = [run(xs, ys) for _ in range(steps)]
        if capture:
            losses, norms = out, step.last_grad_norm
        else:
            losses, norms = [o[0] for o in out], out[-1][1]
        runs[capture] = (torch.stack(losses).float(), norms,
                         _step_state(net, step))
        if not capture and layout == "NHWC":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            for e in ev[1:]:
                step._eager(xs, ys)
                e.record()
            torch.cuda.synchronize()
            eager_ms = float(np.mean([a.elapsed_time(b)
                                      for a, b in zip(ev, ev[1:])]))
        else:
            graphs = len(step.graphs)
        del net, step, xs, ys
        torch.cuda.empty_cache()
    (le, ne, se), (lc, nc, sc) = runs[False], runs[True]
    diff = [i for i, (a, b) in enumerate(zip(se, sc)) if not torch.equal(a, b)]
    log("resnet (%s, x %s): %d captured steps (%d graph) vs %d eager steps "
        "from the same state: losses %s vs %s, grad norm %.6g vs %.6g; %d "
        "of %d state tensors differ (weights, running statistics, momentum)"
        % (layout, tuple(x.shape), steps, graphs, steps, lc.tolist(),
           le.tolist(), float(nc), float(ne), len(diff), len(se)))
    if diff or not torch.equal(le, lc) or not torch.equal(ne, nc):
        worst = max((_bn_err(sc[i], se[i])[1] for i in diff), default=0.0)
        raise AssertionError("the captured step differs from the eager step "
                             "(worst state tensor %.3g of its largest "
                             "magnitude)" % worst)
    return eager_ms


def resnet_train(seed, smi):
    """Phase 6: the float32 gradient check against the CPU plain path,
    captured vs eager steps, then the main path (the bench's step,
    captured), a profiled window of replays, and make_chained(10);
    returns the kernels' launch counts on the main path."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.parallel import GluonTrainStep

    resnet_gradient_check(seed)
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed + 6)
    x = rng.rand(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (RESNET_BATCH,)).astype(np.int32)
    eager_ms = captured_vs_eager(seed, x, y)
    # the default layout, NCHW (BatchNorm over axis 1): one step at batch
    # RESNET_NCHW_BATCH, captured against eager
    xn = rng.rand(RESNET_NCHW_BATCH, 3, RESNET_SIZE,
                  RESNET_SIZE).astype(np.float32)
    captured_vs_eager(seed, xn, y[:RESNET_NCHW_BATCH], steps=1,
                      layout="NCHW")

    # the main path: the bench's step, captured, 10 steps on one fixed
    # batch (the first call warms up eagerly, captures and replays)
    net = _resnet("cuda", seed)
    step = GluonTrainStep(net, gluon.loss.SoftmaxCrossEntropyLoss(),
                          mesh=None, lr=0.1, momentum=0.9, wd=1e-4,
                          compute_dtype="bfloat16")
    xs, ys = step.put_batch(x, y)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(RESNET_STEPS)]
    losses = []
    counters = _resnet_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for ev in events:
        ev[0].record()
        losses.append(step(xs, ys))
        ev[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    # ---- end of the main path
    (graph,) = step.graphs.values()
    losses = [v.float().item() for v in losses]
    log("resnet: %d GluonTrainStep steps (lr 0.1, momentum 0.9, wd 1e-4, "
        "bf16 compute, captured) on one (%d, %d, %d, 3) batch: loss %s; "
        "grad norm %.4g" % (RESNET_STEPS, RESNET_BATCH, RESNET_SIZE,
                            RESNET_SIZE, " ".join("%.4f" % v for v in losses),
                            float(step.last_grad_norm)))
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("the ResNet-50 loss is not finite or did not "
                             "fall")
    # the wrappers count where they launch: in the eager warm-up and into
    # the graph at capture; the replays run the captured launches again
    per_step = {"pertap": RESNET_K1A, "im2col": RESNET_K1B,
                "maxpool": RESNET_K2, "batch_norm_fwd": RESNET_BN,
                "batch_norm_bwd": RESNET_BN}
    log("resnet: wrapper counts over the main path (1 eager warm-up step + "
        "1 capture; then %d graph replays) %s; expected 2 x %s" % (
            graph.replays, launches, per_step))
    if launches != {k: 2 * v for k, v in per_step.items()}:
        raise AssertionError("the ResNet-50 step did not launch K1a, K1b, K2, "
                             "K6a and K6b once per convolution, pool and "
                             "BatchNorm")

    # the step time (CUDA events, after the warmup steps)
    step_ms = float(np.mean([a.elapsed_time(b)
                             for a, b in events[RESNET_WARMUP:]]))
    log("resnet: step %.2f ms on %s (captured; mean of %d after %d "
        "warmup), %.1f images/s; the eager step %.2f ms (%.1f images/s); "
        "%d steps in %.2f s wall (the first: warm-up, capture, replay); "
        "peak memory %.2f GB" % (
            step_ms, smi, RESNET_STEPS - RESNET_WARMUP, RESNET_WARMUP,
            RESNET_BATCH / step_ms * 1e3, eager_ms,
            RESNET_BATCH / eager_ms * 1e3, RESNET_STEPS, wall,
            torch.cuda.max_memory_allocated() / 1e9))
    traced = 3
    seen = profile_steps(lambda: step(xs, ys), smi, step_ms, steps=traced,
                         groups=RESNET_GROUPS, tag="resnet",
                         count=RESNET_LAUNCH_KERNELS)
    if seen is not None:
        want = {k: n * traced for k, _, n in RESNET_LAUNCH_KERNELS}
        log("resnet: kernel launches in the trace of %d replays: %s; "
            "expected %s" % (traced, seen, want))
        if seen != want:
            raise AssertionError("the replayed step does not launch each "
                                 "kernel once per layer")

    # n steps as one graph, launched once
    chained = step.make_chained(RESNET_STEPS)
    t0 = time.perf_counter()
    chained(xs, ys)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    last = chained(xs, ys)
    end.record()
    torch.cuda.synchronize()
    chain_ms = start.elapsed_time(end)
    log("resnet: make_chained(%d): one graph launch of %d steps in %.2f ms, "
        "%.2f ms a step (%.1f images/s) on %s; last loss %.4f (%s); its "
        "first call (warm-up, capture, replay) %.1f s" % (
            RESNET_STEPS, RESNET_STEPS, chain_ms, chain_ms / RESNET_STEPS,
            RESNET_BATCH * RESNET_STEPS / chain_ms * 1e3, smi,
            float(last), last.dtype, first_s))
    if last.dtype != torch.float32 or not np.isfinite(float(last)):
        raise AssertionError("make_chained did not return a finite float32 "
                             "loss")
    del step, net, chained
    torch.cuda.empty_cache()
    # each kernel's launches as the trace of replays saw them, or None
    # where the trace saw no device kernel (then nothing is inferred)
    return {k: dict(launches=n, traced_replays=traced,
                    launches_in_traced_replays=None if seen is None
                    else seen[k])
            for k, n in launches.items()}


# ------------------------------------------------------- ResNet-50 v2 (6b)

# the optimizer= route's SGD (the bench's hyperparameters), and the steps
# the two routes are timed over, in turns
V2_SGD = dict(learning_rate=0.1, momentum=0.9, wd=1e-4)
V2_TIMED = 5


def _per_formulation(convs):
    """The convolutions of one step by K1's formulation (I < 128: im2col)."""
    from mxnet_tpu_torch.ops import conv_dw as C

    out = {"pertap": 0, "im2col": 0}
    for c in convs:
        out[C.formulation(c[0][3])] += 1
    return out


def step_dw_rows(convs, seed, tag):
    """K1a and K1b at every distinct convolution of ``convs`` (one step's)
    in bf16, against their plain version on the card (DW_TOL) and bitwise
    repeatable, timed beside cuDNN's wgrad and the bound; the numbers
    summed over the step by formulation."""
    from mxnet_tpu_torch.ops import conv_dw as C

    counts = {}
    for c in convs:
        counts[c] = counts.get(c, 0) + 1
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    rows = {form: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                       library_ms=0.0, bound_by=set())
            for form in ("pertap", "im2col")}
    dt = torch.bfloat16
    for (xs, k, s, p, o), n_step in counts.items():
        form = C.formulation(xs[3])
        run = C.conv_dw_pertap if form == "pertap" else C.conv_dw_im2col
        n, h, w, _ = xs
        dys = (n, _out_size(h, k[0], s[0], p[0]),
               _out_size(w, k[1], s[1], p[1]), o)
        x = torch.randn(xs, device="cuda", generator=gen).to(dt)
        dy = torch.randn(dys, device="cuda", generator=gen).to(dt)
        wt = torch.empty((o,) + k + xs[3:], dtype=dt, device="cuda")
        err, scale, same, ms, plain_ms, lib_ms = _timed_dw(
            lambda: run(x, dy, k, s, p),
            lambda: C.conv_dw_reference(x, dy, k, s, p),
            lambda: _wgrad(x, dy, wt, s, p))
        if not (err <= DW_TOL * scale and same):
            raise AssertionError("conv_dw %s at x %s (%s): error %.3g of "
                                 "%.3g, bitwise repeatable %s"
                                 % (form, xs, tag, err, scale, same))
        bound, bound_by = conv_dw_bound_ms(xs, k, s, p, o, dt)
        log("kernel conv_dw %s [%s: x %s k %s s %s p %s O %d bf16, %d a "
            "step]: max_abs_err %.3g of max %.3g; kernel %.4f ms (%.1f %% "
            "of the bound), plain %.4f ms, cuDNN wgrad %.4f ms, bound %.4f "
            "ms (%s)" % (form, tag, xs, k, s, p, o, n_step, err, scale, ms,
                         100.0 * bound / ms, plain_ms, lib_ms, bound,
                         bound_by))
        row = rows[form]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound), ("library_ms", lib_ms)):
            row[key] += n_step * v
        row["bound_by"].add(bound_by)
        del x, dy, wt
    torch.cuda.empty_cache()
    for form, row in rows.items():
        row["bound_by"] = "+".join(sorted(row.pop("bound_by")))
        log("kernel conv_dw %s over one %s step (bf16): kernel %.3f ms, "
            "plain %.3f ms, cuDNN wgrad %.3f ms, bound %.3f ms" % (
                form, tag, row["ms"], row["plain_ms"], row["library_ms"],
                row["bound_ms"]))
    return rows


def _timed_turns(runs, n=V2_TIMED):
    """Each (name, fn) of ``runs`` called ``n`` times, timed by CUDA events,
    in the order given: {name: [ms a call, ...]}."""
    out = {}
    for name, fn in runs:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.setdefault(name, []).append(start.elapsed_time(end) / n)
    return out


def scheduled_step_check(seed):
    """Phase 6b.2: GluonTrainStep(optimizer=SGD with a FactorScheduler
    that halves the rate every 2 steps) on a two-layer MLP on the card:
    five captured steps from one capture, against the same step run
    eagerly (the code the graph captures), bit for bit, and against the
    eager Updater loop within 1e-5 of each weight's largest magnitude;
    each step's rate read back from the step's buffer."""
    from mxnet_tpu_torch import autograd, gluon, lr_scheduler, optimizer
    from mxnet_tpu_torch.gluon import nn as gnn
    from mxnet_tpu_torch.parallel import GluonTrainStep

    def mlp():
        net = gnn.HybridSequential(device="cuda")
        net.add(gnn.Dense(64, activation="relu", in_units=32, device="cuda"))
        net.add(gnn.Dense(10, in_units=64, device="cuda"))
        return net.initialize(seed=seed)

    def sgd():
        return optimizer.SGD(learning_rate=0.5, momentum=0.9, wd=1e-3,
                             lr_scheduler=lr_scheduler.FactorScheduler(
                                 step=2, factor=0.5))

    rng = np.random.RandomState(seed + 21)
    x = torch.from_numpy(rng.randn(16, 32).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 10, (16,)).astype(np.int32)).cuda()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    nets = [mlp() for _ in range(3)]
    captured = GluonTrainStep(nets[0], loss_fn, optimizer=sgd())
    eager = GluonTrainStep(nets[1], loss_fn, optimizer=sgd())
    eager._capture = False
    updater = optimizer.get_updater(sgd())
    params = list(nets[2].collect_params().values())
    rates, worst, differ = [], 0.0, 0
    for _ in range(5):
        captured(x, y)
        eager(x, y)
        rates.append(float(captured._scalars[0]))
        with autograd.record():
            loss = loss_fn(nets[2](x), y).mean()
        autograd.backward(loss)
        for i, p in enumerate(params):
            updater(i, p.grad, p)
        torch.cuda.synchronize()
        a, b, c = (n.state_dict() for n in nets)
        differ += sum(not torch.equal(a[k], b[k]) for k in a)
        worst = max(worst, max((a[k] - c[k]).abs().max().item()
                               / max(c[k].abs().max().item(), 1e-30)
                               for k in a))
    (graph,) = captured.graphs.values()
    log("resnet v2: GluonTrainStep(optimizer=SGD, FactorScheduler(step 2, "
        "factor 0.5)) on an MLP, 5 captured steps: %d graph, %d replays; "
        "rates read from the buffer %s; %d state tensors differ from the "
        "same step run eagerly (bitwise expected); worst weight against the "
        "eager Updater loop %.3g of its largest magnitude (tol 1e-05)" % (
            len(captured.graphs), graph.replays, rates, differ, worst))
    if len(captured.graphs) != 1 or rates != [0.5, 0.5, 0.25, 0.25, 0.125] \
            or differ or worst > 1e-5:
        raise AssertionError("the scheduled optimizer= step recaptured, read "
                             "a stale rate or left the eager trajectory")


def _train_drive(step, xs, ys, n, counters):
    """``n`` steps, their times by CUDA events and the wrappers' launches:
    every count set to 0 just before and read just after."""
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    losses = []
    t0 = time.perf_counter()
    for ev in events:
        ev[0].record()
        losses.append(step(xs, ys))
        ev[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    step_ms = float(np.mean([a.elapsed_time(b)
                             for a, b in events[RESNET_WARMUP:]]))
    return ([v.float().item() for v in losses], launches, step_ms, wall,
            torch.cuda.max_memory_allocated() / 1e9)


def resnet_v2(seed, smi):
    """Phase 6b: ResNet-50 v2 (pre-activation) and the space-to-depth
    stem.  (1) float32 gradients of resnet50_v2 at (4, 64, 64, 3) on the
    card against the CPU plain path (phase 6's criteria); (2) an
    FactorScheduler inside a captured optimizer= step (one capture, the
    rate changing mid-run); (3) the main path: resnet50_v2(layout="NHWC")
    through GluonTrainStep(optimizer=SGD(lr 0.1, momentum 0.9, wd 1e-4),
    compute_dtype bfloat16), captured, 10 steps on one (128, 224, 224, 3)
    batch: a finite loss, the wrappers' counts (2 x a step: the warm-up's
    and the capture's), step time, images/s, peak memory, then 3 replays
    under torch.profiler (busy share, time by group, launches counted);
    (4) the same step with the fused lr/momentum/wd closure, timed in
    turns; (5) resnet50_v1(stem_s2d=True) against the 7x7 stem, both
    captured at the same batch, in turns, the s2d path's counts, and K1
    over its convolutions (the stem's K1b at (128, 115, 115, 12) 4x4
    among them; the 7x7 stem's is phase 3c's).  Returns the two paths'
    launches and the K1 rows of each path's convolutions."""
    from mxnet_tpu_torch import gluon, optimizer
    from mxnet_tpu_torch.parallel import GluonTrainStep

    resnet_gradient_check(seed, make=_resnet50_v2, tag="resnet v2")
    torch.cuda.empty_cache()
    scheduled_step_check(seed)
    rng = np.random.RandomState(seed + 6)
    x = rng.rand(RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3).astype(np.float32)
    y = rng.randint(0, RESNET_CLASSES, (RESNET_BATCH,)).astype(np.int32)
    convs = resnet_convs(make=_resnet50_v2)
    bns = resnet_bns(make=_resnet50_v2)
    per_step = dict(_per_formulation(convs), maxpool=RESNET_K2,
                    batch_norm_fwd=len(bns), batch_norm_bwd=len(bns) - 1)
    counters = _resnet_counters()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    # (3) the main path
    net = _resnet("cuda", seed, make=_resnet50_v2)
    step = GluonTrainStep(net, loss_fn, compute_dtype="bfloat16",
                          optimizer=optimizer.SGD(**V2_SGD))
    xs, ys = step.put_batch(x, y)
    losses, launches, step_ms, wall, peak = _train_drive(
        step, xs, ys, RESNET_STEPS, counters)
    # ---- end of the main path
    (graph,) = step.graphs.values()
    log("resnet v2: %d GluonTrainStep(optimizer=SGD(lr 0.1, momentum 0.9, "
        "wd 1e-4), bf16 compute, captured) steps of resnet50_v2 on one (%d, "
        "%d, %d, 3) batch: loss %s; grad norm %.4g; %d graph, %d replays"
        % (RESNET_STEPS, RESNET_BATCH, RESNET_SIZE, RESNET_SIZE,
           " ".join("%.4f" % v for v in losses), float(step.last_grad_norm),
           len(step.graphs), graph.replays))
    log("resnet v2: wrapper counts over the main path (1 eager warm-up step "
        "+ 1 capture) %s; expected 2 x %s (the raw input's BatchNorm runs "
        "K6a alone)" % (launches, per_step))
    if not all(np.isfinite(losses)):
        raise AssertionError("the ResNet-50 v2 loss is not finite")
    if launches != {k: 2 * v for k, v in per_step.items()} \
            or len(step.graphs) != 1:
        raise AssertionError("the ResNet-50 v2 step did not launch K1a, K1b, "
                             "K2, K6a and K6b once per layer, or recaptured")
    log("resnet v2: step %.2f ms on %s (captured, optimizer=; mean of %d "
        "after %d warmup), %.1f images/s; %d steps in %.2f s wall (the "
        "first: warm-up, capture, replay); peak memory %.2f GB" % (
            step_ms, smi, RESNET_STEPS - RESNET_WARMUP, RESNET_WARMUP,
            RESNET_BATCH / step_ms * 1e3, RESNET_STEPS, wall, peak))
    traced = 3
    count = tuple((key, keys, per_step[key])
                  for key, keys, _ in RESNET_LAUNCH_KERNELS)
    seen = profile_steps(lambda: step(xs, ys), smi, step_ms, steps=traced,
                         groups=RESNET_GROUPS, tag="resnet v2", count=count)
    if seen is not None:
        want = {k: n * traced for k, _, n in count}
        log("resnet v2: kernel launches in the trace of %d replays: %s; "
            "expected %s" % (traced, seen, want))
        if seen != want:
            raise AssertionError("the replayed v2 step does not launch each "
                                 "kernel once per layer")

    # (4) the optimizer= route against the fused closure, in turns
    net_f = _resnet("cuda", seed, make=_resnet50_v2)
    fused = GluonTrainStep(net_f, loss_fn, lr=0.1, momentum=0.9, wd=1e-4,
                           compute_dtype="bfloat16")
    xf, yf = fused.put_batch(x, y)
    fused(xf, yf)
    turns = _timed_turns([("optimizer=", lambda: step(xs, ys)),
                          ("fused", lambda: fused(xf, yf)),
                          ("fused", lambda: fused(xf, yf)),
                          ("optimizer=", lambda: step(xs, ys))])
    log("resnet v2: the captured step on %s, optimizer=SGD against the "
        "fused lr/momentum/wd closure, %d replays each, in turns: %s ms" % (
            smi, V2_TIMED, "; ".join("%s %s" % (k, ", ".join(
                "%.2f" % v for v in vals)) for k, vals in turns.items())))
    v2_launches = {k: dict(launches=n, traced_replays=traced,
                           launches_in_traced_replays=None if seen is None
                           else seen[k]) for k, n in launches.items()}
    del step, net, fused, net_f, xs, ys, xf, yf
    torch.cuda.empty_cache()
    v2_rows = step_dw_rows(convs, seed, "resnet50_v2")

    # (5) the space-to-depth stem against the 7x7 stem
    s2d_convs = resnet_convs(make=lambda **kw: _resnet(
        kw.pop("device"), stem_s2d=True, **kw))
    s2d_per_step = dict(_per_formulation(s2d_convs), maxpool=RESNET_K2,
                        batch_norm_fwd=RESNET_BN, batch_norm_bwd=RESNET_BN)
    steps = {}
    for name, kw in (("s2d", {"stem_s2d": True}), ("7x7", {})):
        net = _resnet("cuda", seed, **kw)
        st = GluonTrainStep(net, loss_fn, lr=0.1, momentum=0.9, wd=1e-4,
                            compute_dtype="bfloat16")
        steps[name] = (net, st) + st.put_batch(x, y)
    _, st, xs, ys = steps["s2d"]
    losses, s2d_launches, s2d_ms, wall, peak = _train_drive(
        st, xs, ys, RESNET_STEPS, counters)
    # ---- end of the s2d path
    log("resnet s2d: %d captured steps of resnet50_v1(stem_s2d=True) (lr "
        "0.1, momentum 0.9, wd 1e-4, bf16): loss %s; step %.2f ms; wrapper "
        "counts %s, expected 2 x %s; peak memory %.2f GB" % (
            RESNET_STEPS, " ".join("%.4f" % v for v in losses), s2d_ms,
            s2d_launches, s2d_per_step, peak))
    if not all(np.isfinite(losses)) or s2d_launches != {
            k: 2 * v for k, v in s2d_per_step.items()}:
        raise AssertionError("the s2d step's loss is not finite or it did "
                             "not launch each kernel once per layer")
    _, std, xs7, ys7 = steps["7x7"]
    first = [float(std(xs7, ys7))]
    turns = _timed_turns([("s2d", lambda: st(xs, ys)),
                          ("7x7", lambda: std(xs7, ys7)),
                          ("7x7", lambda: std(xs7, ys7)),
                          ("s2d", lambda: st(xs, ys))])
    log("resnet s2d: the captured step on %s, the space-to-depth stem "
        "against the 7x7/s2 stem, %d replays each, in turns: %s ms; the 7x7 "
        "stem's first loss %.4f against the s2d one's %.4f (the same "
        "function; bf16 rounding differs)" % (
            smi, V2_TIMED, "; ".join("%s %s" % (k, ", ".join(
                "%.2f" % v for v in vals)) for k, vals in turns.items()),
            first[0], losses[0]))
    del steps, st, std, xs, ys, xs7, ys7, net
    torch.cuda.empty_cache()
    # the stem's K1b at (128, 115, 115, 12) 4x4 among them (the 7x7 stem's
    # is phase 3c's)
    s2d_rows = step_dw_rows(s2d_convs, seed, "resnet50_v1 s2d")
    s2d = {k: dict(launches=n) for k, n in s2d_launches.items()}
    return dict(v2_launches=v2_launches, v2_rows=v2_rows,
                s2d_launches=s2d, s2d_rows=s2d_rows)


# ---------------------------------------------------------------- imperative

# mx.nd on the card vs the same call on the CPU: float results within this
# share of the CPU result's largest magnitude (transcendental functions
# and reductions differ by some ulps between the two devices' libraries)
ND_TOL = 1e-5
# a user's rtc kernels vs their plain versions: NVRTC may contract a
# product and a sum into one FMA, one rounding of the result apart
RTC_TOL = 1e-6
FFN_SHAPE, FFN_HIDDEN = (TRAIN_BATCH, SEQ, UNITS), 4 * UNITS
RESNET_TRAINABLE, RESNET_VALUES = 193, 25_575_912
AXPY_SHAPE = (RESNET_BATCH, 112, 112, 64)  # the stem activation
RTC_BLOCK = 256
SGD_MOM = dict(lr=0.1, momentum=0.9, wd=1e-4)
MXNET_AXPY_EXAMPLE = r'''
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
'''
SGD_SIG = ("float *weight, const float *grad, float *mom, float lr, "
           "float momentum, float wd, float rescale_grad, "
           "float clip_gradient, int n")


def _nd_outputs(case, ctx, seed):
    """One op case of mxnet_tpu_torch.test_utils through mx.nd on ``ctx``;
    the results (for the in-place updates: the weight and the states) as
    numpy."""
    from mxnet_tpu_torch import nd, test_utils as T

    name = T.op_name(case)
    attrs = dict(T.OP_CASES[case][1])
    if name in T.NO_TENSOR_OPS:
        attrs["ctx"] = ctx
    inputs = [nd.array(a, ctx=ctx, dtype=a.dtype)
              for a in T.make_inputs(case, seed)]
    out = nd.imperative_invoke(name, inputs, attrs)
    if name in T.INPLACE_OPS:
        out = T.updated(case, inputs)
    return [o.asnumpy() for o in out]


# op cases whose zeros must keep their sign on the card as on the CPU
SIGNED_ZERO_CASES = {"sign/nan-and-zeros"}


def registry_on_card(seed):
    """Phase 7a: every registered op once on the card against the CPU."""
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch import test_utils as T
    from mxnet_tpu_torch.ops import registry

    bad, worst = [], (0.0, None)
    for case in sorted(T.OP_CASES):
        name = T.op_name(case)
        mx_random.seed(seed)
        got = _nd_outputs(case, torch.device("cuda", 0), seed)
        torch.cuda.synchronize()
        if name in T.RANDOM_OPS:
            want = _nd_outputs(case, torch.device("cpu"), seed)
            ok = all(g.shape == w.shape and g.dtype == w.dtype and
                     np.isfinite(g).all() and
                     (name != "_shuffle" or np.array_equal(
                         np.sort(g, axis=0), np.sort(w, axis=0)))
                     and abs(float(g.mean()) - float(w.mean()))
                     < 0.15 * max(1.0, float(np.abs(w).max()))
                     for g, w in zip(got, want))
            if not ok:
                bad.append(case)
            continue
        want = _nd_outputs(case, torch.device("cpu"), seed)
        for g, w in zip(got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                bad.append(case)
                continue
            if not np.issubdtype(w.dtype, np.floating):
                if not np.array_equal(g, w):
                    bad.append(case)
                continue
            fin = np.isfinite(w)
            if not np.array_equal(fin, np.isfinite(g)) or not np.array_equal(
                    np.isnan(g), np.isnan(w)):
                bad.append(case)
                continue
            scale = max(1.0, float(np.abs(w[fin]).max(initial=0.0)))
            err = float(np.abs(g[fin] - w[fin]).max(initial=0.0)) / scale
            if err > worst[0]:
                worst = (err, case)
            if err > ND_TOL or not np.array_equal(g[~fin], w[~fin],
                                                  equal_nan=True):
                bad.append(case)
            elif case in SIGNED_ZERO_CASES and not np.array_equal(
                    np.signbit(g[w == 0]), np.signbit(w[w == 0])):
                bad.append(case)
    log("imperative: %d registered ops in %d cases through mx.nd on the card "
        "vs the CPU: worst %.3g of the result's magnitude (%s; tol %.0e); "
        "disagree: %s" % (len(registry.list_ops()), len(T.OP_CASES),
                          worst[0], worst[1], ND_TOL, bad or "none"))
    if bad:
        raise AssertionError("mx.nd ops disagree between the card and the "
                             "CPU: %s" % bad)


def _ffn(ctx, vals):
    """The feed-forward of a TransformerLM block in mx.nd, recorded, with
    gradients of its weights; returns (output, loss, {name: grad})."""
    from mxnet_tpu_torch import autograd, nd

    x, r, w1, b1, w2, b2, gamma, beta = [nd.array(v, ctx=ctx) for v in vals]
    params = {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "gamma": gamma,
              "beta": beta}
    for p in params.values():
        p.attach_grad()
    with autograd.record():
        h = nd.FullyConnected(x, w1, b1, num_hidden=FFN_HIDDEN, flatten=False)
        h = nd.LeakyReLU(h, act_type="gelu")
        h = nd.FullyConnected(h, w2, b2, num_hidden=UNITS, flatten=False)
        out = nd.LayerNorm(h + x, gamma, beta)
        loss = nd.sum(out * r)
    loss.backward()
    return out, loss, {k: p.grad for k, p in params.items()}


def ffn_full_width(seed, smi):
    """Phase 7a: the full-width feed-forward on the card vs the CPU."""
    rng = np.random.RandomState(seed + 7)
    vals = [rng.randn(*FFN_SHAPE).astype(np.float32),
            rng.randn(*FFN_SHAPE).astype(np.float32),
            (rng.randn(FFN_HIDDEN, UNITS) / UNITS ** 0.5).astype(np.float32),
            (0.02 * rng.randn(FFN_HIDDEN)).astype(np.float32),
            (rng.randn(UNITS, FFN_HIDDEN) / FFN_HIDDEN ** 0.5)
            .astype(np.float32),
            (0.02 * rng.randn(UNITS)).astype(np.float32),
            (1 + 0.1 * rng.randn(UNITS)).astype(np.float32),
            (0.1 * rng.randn(UNITS)).astype(np.float32)]
    cuda = torch.device("cuda", 0)
    _ffn(cuda, vals)  # warm up cuBLAS
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out, loss, got = _ffn(cuda, vals)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    _, cpu_loss, want = _ffn(torch.device("cpu"), vals)
    worst, worst_name = 0.0, None
    for name, g in want.items():
        gw = g.asnumpy()
        rel = float(np.abs(got[name].asnumpy() - gw).max()) \
            / max(float(np.abs(gw).max()), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    log("imperative: feed-forward in mx.nd at (%d, %d, %d) -> %d -> %d, "
        "record + backward on %s in %.2f ms; loss card %.6g cpu %.6g; "
        "gradients of %d weights vs the CPU: worst %.3g of the gradient's "
        "largest magnitude (%s; tol %.0e)" % (
            FFN_SHAPE + (FFN_HIDDEN, UNITS, smi, ms, loss.asscalar(),
                         cpu_loss.asscalar(), len(want), worst, worst_name,
                         GRAD_TOL)))
    if out.shape != FFN_SHAPE or not np.isfinite(out.asnumpy()).all() \
            or worst > GRAD_TOL:
        raise AssertionError("the imperative feed-forward disagrees with the "
                             "CPU")


def _rtc_source(name):
    import os

    with open(os.path.join("mxnet_tpu_torch", "csrc", "rtc", name)) as f:
        return f.read()


def _grid(n):
    return (max(1, -(-n // RTC_BLOCK)), 1, 1)


def _rel_err(got, want):
    return (got - want).abs().max().item() / max(want.abs().max().item(),
                                                 1e-30)


def _resnet_trainables(seed):
    """resnet50_v1's trainable parameters on the card as NDArrays (the
    Gluon parameters themselves, no copy) and their float32 gradients from
    one train-mode backward at (4, 64, 64, 3), as phase 6 computes them."""
    from mxnet_tpu_torch import nd

    rng = np.random.RandomState(seed + 8)
    net = _resnet("cuda", seed)
    x = torch.from_numpy(rng.rand(4, 64, 64, 3).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, RESNET_CLASSES, (4,))
                         .astype(np.int32)).cuda()
    grads = _resnet_grads(net, x, y, True)
    params = {k: p for k, p in net.collect_params().items()
              if p.grad_req != "null"}
    return net, [nd.NDArray(p.data) for p in params.values()], \
        [nd.NDArray(grads[k].cuda()) for k in params]


def _host_us(fn, n=2000):
    """Host time of one call of ``fn`` in microseconds, over ``n`` calls."""
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def _earlier_arguments(args, params):
    """The per-launch argument work of the earlier launch path:
    a formatted name for every argument, a numpy array and a ctypes object
    for every scalar, a c_void_p for every pointer, then a fresh void*[]."""
    import ctypes

    from mxnet_tpu_torch import rtc

    cts = {"float": ctypes.c_float, "int": ctypes.c_int32}
    out = []
    for i, (arg, (is_ptr, _c, ctype)) in enumerate(zip(args, params)):
        tdt, ndt, _ = rtc._C_TYPES[ctype]
        what = "CudaKernel(%s): argument %d (%s%s)" % (
            "sgd_mom", i, ctype, " *" if is_ptr else "")
        if not is_ptr:
            out.append(cts[ctype].from_buffer_copy(
                np.array(arg, ndt).tobytes()))
            continue
        t = arg.data_torch
        if t.dtype != tdt or not t.is_contiguous() or not what:
            raise AssertionError(what)
        out.append(ctypes.c_void_p(t.data_ptr()))
    return (ctypes.c_void_p * len(out))(*[ctypes.addressof(p) for p in out])


def launch_host_parts(sgd, w, g, m, hp):
    """Where the host time of one sgd_mom launch (9 arguments) goes, each
    part repeated alone: the launch as it is and its parts, then the parts
    of the earlier path that the launch template replaced; and the
    stream candidates, the raw one checked under torch.cuda.stream."""
    import contextlib
    import ctypes

    from mxnet_tpu_torch import _nvrtc, gpu
    from mxnet_tpu_torch.context import resolve_device

    ctx, dev = gpu(0), torch.device("cuda", 0)
    args = [w.copy(), g, m.copy(), *hp, w.size]
    cu = _nvrtc._cuda()
    get_current, launch_kernel = _nvrtc._calls
    func = sgd._module._function(0, sgd._symbol)
    values = sgd._values(args, 0)
    ptrs = sgd._pack(values)
    stream = _nvrtc.current_stream(0)
    cur = ctypes.c_void_p()
    pcur = ctypes.pointer(cur)
    # the driver call as the earlier path declared it, for comparison
    vp, u = ctypes.c_void_p, ctypes.c_uint
    proto = cu["cuLaunchKernel"]
    proto.restype = ctypes.c_int
    proto.argtypes = [vp, u, u, u, u, u, u, u, vp, ctypes.POINTER(vp),
                      ctypes.POINTER(vp)]

    @contextlib.contextmanager
    def pushed():
        cu.cuCtxPushCurrent_v2(_nvrtc._primary_context(0))
        try:
            yield
        finally:
            cu.cuCtxPopCurrent_v2(ctypes.byref(ctypes.c_void_p()))

    def push_pop():
        with pushed():
            pass

    parts = {
        "launch": lambda: sgd.launch(args, ctx, (1, 1, 1), (RTC_BLOCK, 1, 1)),
        "checks (attribute reads)": lambda: sgd._values(args, 0),
        "pack (one struct call)": lambda: sgd._pack(values),
        "raw current stream": lambda: _nvrtc.current_stream(0),
        "cuCtxGetCurrent": lambda: get_current(pcur),
        "cuLaunchKernel alone": lambda: launch_kernel(
            func, 1, 1, 1, RTC_BLOCK, 1, 1, 0, ctypes.c_void_p(stream), ptrs,
            None),
        "earlier: cuLaunchKernel through argtypes": lambda: proto(
            func, 1, 1, 1, RTC_BLOCK, 1, 1, 0, stream, ptrs, None),
        "earlier: checks and ctypes arguments": lambda: _earlier_arguments(
            args, sgd._params),
        "earlier: torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "earlier: resolve_device": lambda: resolve_device(dev),
        "earlier: context push and pop (contextmanager)": push_pop,
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
    }
    host = {name: _host_us(fn) for name, fn in parts.items()}
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        raw_ok = _nvrtc.current_stream(0) == side.cuda_stream
    log("rtc: host us of one sgd_mom launch: %s; the raw stream follows "
        "torch.cuda.stream %s" % (", ".join("%s %.2f" % kv
                                            for kv in host.items()), raw_ok))
    if not raw_ok:
        raise AssertionError("the raw current stream does not follow "
                             "torch.cuda.stream")
    return host


def captured_update(update, start, grads, replays=20):
    """The rtc update of the 193 tensors captured in one CUDA graph: two
    replays from the start state against two eager updates (bitwise), then
    the device time of a replay."""
    from mxnet_tpu_torch import nd

    ctx = torch.device("cuda", 0)
    we = [s.copy() for s in start]
    me = [nd.zeros(s.shape, ctx=ctx) for s in start]
    for _ in range(2):
        update(we, me, grads)
    wc = [s.copy() for s in start]
    mc = [nd.zeros(s.shape, ctx=ctx) for s in start]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # capture only: nothing runs
        update(wc, mc, grads)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize()
    same = all(torch.equal(a.data_torch, b.data_torch)
               for a, b in zip(we + me, wc + mc))
    start_ev = torch.cuda.Event(enable_timing=True)
    end_ev = torch.cuda.Event(enable_timing=True)
    start_ev.record()
    for _ in range(replays):
        graph.replay()
    end_ev.record()
    torch.cuda.synchronize()
    del graph
    return start_ev.elapsed_time(end_ev) / replays, same


def rtc_phase(seed, smi):
    """Phase 7b: rtc.CudaModule on the card; returns the row of the kernels
    line and the launch count of the main path."""
    from mxnet_tpu_torch import MXNetError, gpu, nd, rtc
    from mxnet_tpu_torch import _nvrtc
    from mxnet_tpu_torch.parallel.gluon_step import sgd_momentum_update

    ctx = gpu(0)
    log("rtc: NVRTC %d.%d, include path %s" % (_nvrtc.nvrtc_version()
                                                + (_nvrtc.include_dir(),)))
    compile_ms = {}
    mods = {}
    for name, exports in (("axpy.cu", ()), ("sgd_mom.cu", ()),
                          ("scale_tmpl.cu", ("ns::scale<float>",))):
        src = _rtc_source(name)
        t0 = time.perf_counter()
        mods[name] = rtc.CudaModule(src, exports=exports)
        t1 = time.perf_counter()
        rtc.CudaModule(src, exports=exports)
        compile_ms[name] = ((t1 - t0) * 1e3,
                            (time.perf_counter() - t1) * 1e3)
    log("rtc: NVRTC compile ms, cold / cached: %s" % ", ".join(
        "%s %.1f / %.4f" % (n, c, w) for n, (c, w) in compile_ms.items()))

    # 1. MXNet's documented example, verbatim
    k = rtc.CudaModule(MXNET_AXPY_EXAMPLE).get_kernel(
        "axpy", "const float *x, float *y, float alpha")
    x = nd.ones((10,), ctx=ctx)
    y = nd.zeros((10,), ctx=ctx)
    k.launch([x, y, 3.0], ctx, (1, 1, 1), (10, 1, 1))
    torch.cuda.synchronize()
    log("rtc: MXNet's axpy example:\n%s" % y)
    if y.asnumpy().tolist() != [3.0] * 10:
        raise AssertionError("MXNet's axpy example did not give 3s")
    # the host's cost of a launch: marshalling, checks, driver call
    launch_us = _host_us(lambda: k.launch([x, y, 3.0], ctx, (1, 1, 1),
                                          (10, 1, 1)), 200)
    torch.cuda.synchronize()
    log("rtc: host time per launch %.1f us (200 launches of 10 elements, "
        "no sync)" % launch_us)

    # 2. axpy at the stem activation
    gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    n = int(np.prod(AXPY_SHAPE))
    xa = nd.NDArray(torch.randn(AXPY_SHAPE, device="cuda", generator=gen))
    y0 = torch.randn(AXPY_SHAPE, device="cuda", generator=gen)
    axpy = mods["axpy.cu"].get_kernel(
        "axpy", "const float *x, float *y, float alpha, int n")
    alpha = 0.75
    runs = []
    for _ in range(2):
        ya = nd.NDArray(y0.clone())
        axpy.launch([xa, ya, alpha, n], ctx, _grid(n), (RTC_BLOCK, 1, 1))
        torch.cuda.synchronize()
        runs.append(ya.data_torch)
    want = (nd.NDArray(y0) + xa * alpha).data_torch
    err = _rel_err(runs[0], want)
    same = torch.equal(runs[0], runs[1])
    ya = nd.NDArray(y0.clone())
    ms = time_ms(lambda: axpy.launch([xa, ya, alpha, n], ctx, _grid(n),
                                     (RTC_BLOCK, 1, 1)))
    y0n = nd.NDArray(y0)
    plain_ms = time_ms(lambda: y0n + xa * alpha)
    yt = y0.clone()
    lib_ms = time_ms(lambda: yt.add_(xa.data_torch, alpha=alpha))
    bound = 12.0 * n / PEAK_BYTES * 1e3
    log("rtc: axpy at %s float32 (%d elements): max err %.3g of the plain "
        "result's magnitude (tol %.0e), bitwise repeatable %s; kernel %.4f "
        "ms, plain %.4f ms, y.add_(x, alpha) %.4f ms, bound %.4f ms (bytes), "
        "%.0f %% of it" % (AXPY_SHAPE, n, err, RTC_TOL, same, ms, plain_ms,
                           lib_ms, bound, 100.0 * bound / ms))
    if err > RTC_TOL or not same:
        raise AssertionError("the axpy kernel disagrees with y + alpha * x "
                             "or is not repeatable")
    del xa, y0, ya, runs, want, y0n, yt
    torch.cuda.empty_cache()

    # 3. the main path: a user's sgd_mom update of ResNet-50's trainables
    net, weights, grads = _resnet_trainables(seed)
    values = sum(w.size for w in weights)
    sgd = mods["sgd_mom.cu"].get_kernel("sgd_mom", SGD_SIG)
    hp = (SGD_MOM["lr"], SGD_MOM["momentum"], SGD_MOM["wd"], 1.0, -1.0)

    def update(ws, ms_, gs):
        for w, g, m in zip(ws, gs, ms_):
            sgd.launch([w, g, m, *hp, w.size], ctx, _grid(w.size),
                       (RTC_BLOCK, 1, 1))

    start = [w.copy() for w in weights]
    moms = [nd.zeros(w.shape, ctx=ctx) for w in weights]
    torch.cuda.synchronize()
    rtc.CudaKernel.launches = 0
    update(weights, moms, grads)
    launches = rtc.CudaKernel.launches
    torch.cuda.synchronize()
    # ---- end of the main path
    small = sum(1 for w in weights if w.size <= 2048)
    log("rtc: sgd_mom over resnet50_v1's %d trainable tensors (%d values, "
        "%d of them with 2048 or fewer): %d launches" % (
            len(weights), values, small, launches))
    if (len(weights), values, launches) != (RESNET_TRAINABLE, RESNET_VALUES,
                                            RESNET_TRAINABLE):
        raise AssertionError("the rtc update did not launch once per "
                             "trainable tensor of ResNet-50")
    host = launch_host_parts(sgd, weights[0], grads[0], moms[0], hp)
    moved = max((w.data_torch - s.data_torch).abs().max().item()
                for w, s in zip(weights, start))
    if not moved > 0:
        raise AssertionError("the rtc update did not move the parameters")
    # two updates each: the kernel (twice, for repeatability) vs the plain
    rows = []
    for _ in range(2):
        ws = [s.copy() for s in start]
        ms_ = [nd.zeros(s.shape, ctx=ctx) for s in start]
        for _ in range(2):
            update(ws, ms_, grads)
        torch.cuda.synchronize()
        rows.append((ws, ms_))
    wp = [s.copy() for s in start]
    mp = [nd.zeros(s.shape, ctx=ctx) for s in start]
    for _ in range(2):
        for w, g, m in zip(wp, grads, mp):
            nd.sgd_mom_update(w, g, m, **SGD_MOM)
    torch.cuda.synchronize()
    (wk, mk), (wk2, mk2) = rows
    err = max(max(_rel_err(a.data_torch, b.data_torch)
                  for a, b in zip(wk, wp)),
              max(_rel_err(a.data_torch, b.data_torch)
                  for a, b in zip(mk, mp)))
    abs_err = max((a.data_torch - b.data_torch).abs().max().item()
                  for a, b in zip(wk + mk, wp + mp))
    same = all(torch.equal(a.data_torch, b.data_torch)
               for a, b in zip(wk + mk, wk2 + mk2))
    del rows, wk, mk, wk2, mk2
    # times of one whole update (193 launches) on the stream
    ws = [s.copy() for s in start]
    ms_ = [nd.zeros(s.shape, ctx=ctx) for s in start]
    t_ms = time_ms(lambda: update(ws, ms_, grads), iters=10)
    t0 = time.perf_counter()
    update(ws, ms_, grads)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    plain_ms = time_ms(lambda: [nd.sgd_mom_update(w, g, m, **SGD_MOM)
                                for w, g, m in zip(wp, grads, mp)], iters=10)
    cap_ms, cap_same = captured_update(update, start, grads)
    fe = sgd_momentum_update(**SGD_MOM)
    tw = [w.data_torch for w in ws]
    tg = [g.data_torch for g in grads]
    tm = [m.data_torch for m in ms_]
    lib_ms = time_ms(lambda: fe(tw, tg, tm), iters=10)
    bound = 20.0 * values / PEAK_BYTES * 1e3
    log("rtc: sgd_mom vs mx.nd.sgd_mom_update over two updates of %d "
        "tensors: max err %.3g relative to each tensor's magnitude (%.3g "
        "abs; tol %.0e), bitwise repeatable %s; a whole update on %s: "
        "kernel %.4f ms (host %.3f ms to issue its %d launches), plain "
        "%.4f ms, foreach SGD-momentum %.4f ms, bound %.4f ms (bytes); "
        "captured in a CUDA graph and replayed: %.4f ms of device time an "
        "update (%.1f %% of the bound), bitwise equal to the eager update "
        "%s" % (len(weights), err, abs_err, RTC_TOL, same, smi, t_ms,
                host_ms, len(weights), plain_ms, lib_ms, bound, cap_ms,
                100.0 * bound / cap_ms, cap_same))
    if err > RTC_TOL or not same or not cap_same:
        raise AssertionError("the sgd_mom kernel disagrees with "
                             "mx.nd.sgd_mom_update, is not repeatable or "
                             "differs when captured")
    row = {"max_abs_err": abs_err, "ms": t_ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": "bytes", "library_ms": lib_ms,
           "captured_ms": cap_ms}
    del net, weights, grads, start, moms, ws, ms_, wp, mp, tw, tg, tm
    torch.cuda.empty_cache()

    # 4. a templated kernel in a namespace, through exports
    scale = mods["scale_tmpl.cu"].get_kernel(
        "ns::scale<float>", "const float *x, float *y, float s, int n")
    xs = nd.NDArray(torch.randn(AXPY_SHAPE, device="cuda", generator=gen))
    outs = []
    for _ in range(2):
        ys = nd.zeros(AXPY_SHAPE, ctx=ctx)
        scale.launch([xs, ys, 2.5, n], ctx, _grid(n), (RTC_BLOCK, 1, 1))
        torch.cuda.synchronize()
        outs.append(ys.data_torch)
    equal = torch.equal(outs[0], (xs * 2.5).data_torch)
    same = torch.equal(outs[0], outs[1])
    s_ms = time_ms(lambda: scale.launch([xs, ys, 2.5, n], ctx, _grid(n),
                                        (RTC_BLOCK, 1, 1)))
    log("rtc: ns::scale<float> through exports (lowered %s) at %s: equal to "
        "x * s %s, bitwise repeatable %s; kernel %.4f ms, bound %.4f ms" % (
            mods["scale_tmpl.cu"]._lowered["ns::scale<float>"], AXPY_SHAPE,
            equal, same, s_ms, 8.0 * n / PEAK_BYTES * 1e3))
    if not (equal and same):
        raise AssertionError("scale<float> disagrees with x * s")
    del xs, ys, outs
    torch.cuda.empty_cache()

    # 5. what must raise
    errors = {}
    try:
        rtc.CudaModule('extern "C" __global__ void f(float *y) { y[0] = '
                       'undeclared_name; }')
    except MXNetError as e:
        errors["compile"] = str(e)
    try:
        k.launch([x.astype("float16"), y, 3.0], ctx, (1, 1, 1), (10, 1, 1))
    except MXNetError as e:
        errors["dtype"] = str(e)
    try:
        k.launch([nd.ones((10,), ctx="cpu"), y, 3.0], ctx, (1, 1, 1),
                 (10, 1, 1))
    except MXNetError as e:
        errors["cpu array"] = str(e)
    torch.cuda.synchronize()
    for case, msg in errors.items():
        log("rtc: %s raises MXNetError: %s" % (case, msg.strip()[:400]))
    if sorted(errors) != ["compile", "cpu array", "dtype"] \
            or "undeclared_name" not in errors["compile"]:
        raise AssertionError("an rtc error case did not raise as it should")
    row["launch_host_us"] = host["launch"]
    row["compile_ms_cold"] = compile_ms["sgd_mom.cu"][0]
    return row, launches


def imperative(seed, smi):
    """Phase 7: the imperative path, mx.nd and rtc.CudaModule."""
    registry_on_card(seed)
    ffn_full_width(seed, smi)
    torch.cuda.empty_cache()
    return rtc_phase(seed, smi)


# ---------------------------------------------------------------- symbolic

# common/fit.py's settings for train_mnist.py: SGD at lr 0.05, momentum
# 0.9, wd 1e-4, the rate divided by 10 at epoch 10 (lr_step_epochs "10"),
# rescale_grad 1/batch (Module's); 6000 training digits an epoch
SYM_EPOCH = 6000 // SYM_BATCH
# the first batch's gradients on the card vs the CPU plain path, within
# this share of each gradient's largest magnitude
SYM_GRAD_TOL = 1e-5
# the wrappers' launches of one LeNet batch (two convolutions, two pools)
LENET_LAUNCHES = {"im2col": 2, "maxpool": 2}
LENET_KERNELS = (("im2col", ("conv_dw_tf32_kernel<true",), 2),
                 ("maxpool", ("maxpool_bwd_kernel",), 2))
# device kernels of a symbolic batch by what they do, matched on the
# kernel's name (the first group that matches wins)
SYM_GROUPS = (
    ("K1b conv_dw im2col", ("conv_dw_tf32_kernel<true",)),
    ("K1 split-K sum", ("conv_dw_reduce",)),
    ("K2 maxpool_bwd", ("maxpool_bwd_kernel",)),
    ("host-to-device copies", ("memcpy htod", "memcpy h2d")),
    ("matrix products", ("gemm", "cutlass", "sm90_xmma")),
    ("cuDNN conv fwd/dgrad", ("conv", "cudnn", "xmma", "fprop", "dgrad",
                              "implicit")),
    ("pooling fwd", ("pool",)),
    ("softmax", ("softmax",)),
    ("element-wise (the update, activations, copies)",
     ("elementwise", "vectorized", "reduce", "fill", "copy", "memcpy",
      "memset")),
)


def _mnist_net(network):
    """train_mnist.py's build_mlp or build_lenet, named from fresh
    counters."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.name import NameManager

    sym = mx.sym
    with NameManager():
        net = sym.Variable("data")
        if network == "mlp":
            net = sym.Flatten(net)
            net = sym.FullyConnected(net, num_hidden=128, name="fc1")
            net = sym.Activation(net, act_type="relu")
            net = sym.FullyConnected(net, num_hidden=64, name="fc2")
            net = sym.Activation(net, act_type="relu")
            net = sym.FullyConnected(net, num_hidden=10, name="fc3")
        else:
            for i, filters in ((1, 20), (2, 50)):
                net = sym.Convolution(net, kernel=(5, 5), num_filter=filters,
                                      name="conv%d" % i)
                net = sym.Activation(net, act_type="tanh")
                net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                                  stride=(2, 2))
            net = sym.FullyConnected(sym.Flatten(net), num_hidden=500,
                                     name="fc1")
            net = sym.Activation(net, act_type="tanh")
            net = sym.FullyConnected(net, num_hidden=10, name="fc2")
        return sym.SoftmaxOutput(net, name="softmax")


def _fit_params():
    import mxnet_tpu_torch as mx

    return {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
            "lr_scheduler": mx.lr_scheduler.MultiFactorScheduler(
                step=[SYM_EPOCH * 10], factor=0.1)}


def _mnist_iter(train, shuffle):
    """common/data.py's get_mnist_iter: the idx files under data/ when
    present, else the synthetic digits."""
    import mxnet_tpu_torch as mx

    kind = "train" if train else "t10k"
    return mx.io.MNISTIter(image="data/%s-images-idx3-ubyte" % kind,
                           label="data/%s-labels-idx1-ubyte" % kind,
                           batch_size=SYM_BATCH, shuffle=shuffle)


def _bound_module(network, device, params):
    """A Module of ``network`` bound for training on ``device`` from the
    host ``params`` (args, aux), with common/fit.py's SGD."""
    import mxnet_tpu_torch as mx

    it = _mnist_iter(True, False)
    mod = mx.mod.Module(_mnist_net(network), context=device)
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params=params[0], aux_params=params[1])
    mod.init_optimizer(optimizer="sgd", optimizer_params=_fit_params())
    return mod


def _module_state(mod):
    ex = mod._exec_group.execs[0]
    state = [a.data_torch.clone() for a in ex.arg_arrays + ex.aux_arrays]
    state += [g.data_torch.clone() for g in ex.grad_dict.values()]
    state += [s.clone() for s in mod._updater.states.values()
              if s is not None]
    return state


def _train_batches(mod, batches, n, events=None):
    """``n`` batches of forward_backward + update, cycling ``batches``;
    each batch's outputs (copies); CUDA events around each when given."""
    outs = []
    for i in range(n):
        if events is not None:
            events[i][0].record()
        mod.forward_backward(batches[i % len(batches)])
        mod.update()
        if events is not None:
            events[i][1].record()
        outs.append(mod.get_outputs()[0].data_torch.clone())
    return outs


def symbolic_net(network, epochs, seed, smi):
    """Phase 8, one network: gradients against the CPU plain path, 3
    captured batches against 3 eager ones (bitwise), the step time
    captured and eager, then the main path: Module.fit on the card with
    accuracy, Speedometer and do_checkpoint, the kernels' counts over it,
    the validation accuracy and the checkpoint read back."""
    import shutil
    import tempfile

    import mxnet_tpu_torch as mx

    from mxnet_tpu_torch.ops import conv_dw as C
    from mxnet_tpu_torch.ops import pool_bwd as P

    card = torch.device("cuda", 0)
    counters = {"im2col": C.conv_dw_im2col, "maxpool": P.maxpool_bwd}
    per_batch = LENET_LAUNCHES if network == "lenet" \
        else dict.fromkeys(LENET_LAUNCHES, 0)
    # the initial parameters, from the seed (the reference common/fit.py's
    # initializer), kept on the host
    mx.random.seed(seed)
    first = mx.mod.Module(_mnist_net(network), context=mx.cpu())
    it = _mnist_iter(True, False)
    first.bind(it.provide_data, it.provide_label)
    first.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2))
    params = tuple({k: v.copy() for k, v in d.items()}
                   for d in first.get_params())
    batches = [next(it) for _ in range(3)]

    # 1. the first batch's gradients on the card vs the CPU plain path
    grads = {}
    for where, dev in (("card", card), ("cpu", torch.device("cpu"))):
        mod = _bound_module(network, dev, params)
        mod.forward_backward(batches[0])
        ex = mod._exec_group.execs[0]
        grads[where] = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
        grads[where]["softmax_output"] = mod.get_outputs()[0].asnumpy()
    errs = {k: float(np.abs(grads["card"][k] - w).max())
            / max(float(np.abs(w).max()), 1e-30)
            for k, w in grads["cpu"].items()}
    worst = max((e, k) for k, e in errs.items())
    log("symbolic %s: first batch's gradients and outputs on the card vs "
        "the CPU plain path: worst %.3g of the largest magnitude (%s; tol "
        "%.0e); each: %s" % (network, worst[0], worst[1], SYM_GRAD_TOL,
                             ", ".join("%s %.2g" % kv for kv in errs.items())))
    if not worst[0] <= SYM_GRAD_TOL:
        raise AssertionError("symbolic %s: the card's gradients disagree "
                             "with the CPU's" % network)

    # 2. 3 captured batches vs 3 eager ones (the program the graph holds),
    # bitwise; the eager run counts the kernels' launches a batch
    runs = {}
    for capture in (True, False):
        mod = _bound_module(network, card, params)
        mod._exec_group.execs[0].capture = capture
        for fn in counters.values():
            fn.launches = 0
        outs = _train_batches(mod, batches, 3)
        torch.cuda.synchronize()
        runs[capture] = (outs, _module_state(mod),
                         {k: fn.launches for k, fn in counters.items()},
                         mod)
    (oc, sc, _, mod_c), (oe, se, eager_counts, mod_e) = runs[True], \
        runs[False]
    diff = sum(not torch.equal(a, b) for a, b in zip(oc + sc, oe + se))
    graph = next(iter(mod_c._exec_group.execs[0].graphs.values()))
    log("symbolic %s: 3 captured batches (%d graph, %d replays) vs 3 eager "
        "from the same state: %d of %d outputs, arguments, aux states, "
        "gradients and momenta differ; eager launches %s (expected 3 x %s)"
        % (network, len(mod_c._exec_group.execs[0].graphs), graph.replays,
           diff, len(oc + sc), eager_counts, per_batch))
    if diff or len(sc) != len(se):
        raise AssertionError("symbolic %s: the captured batches differ from "
                             "the eager ones" % network)
    if eager_counts != {k: 3 * v for k, v in per_batch.items()}:
        raise AssertionError("symbolic %s: the eager batches did not launch "
                             "K1b and K2 once per convolution and pool"
                             % network)

    # 3. the step (forward_backward + update) time, captured and eager
    steps, warm = 20, 3
    step_ms = {}
    for capture, mod in ((True, mod_c), (False, mod_e)):
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(steps)]
        _train_batches(mod, batches, steps, ev)
        torch.cuda.synchronize()
        step_ms[capture] = float(np.mean([a.elapsed_time(b)
                                          for a, b in ev[warm:]]))
    log("symbolic %s: a batch's forward_backward + update on %s, captured "
        "%.4f ms (%.0f samples/s), eager %.4f ms (%.0f samples/s) (CUDA "
        "events, mean of %d after %d)" % (
            network, smi, step_ms[True], SYM_BATCH / step_ms[True] * 1e3,
            step_ms[False], SYM_BATCH / step_ms[False] * 1e3, steps - warm,
            warm))
    # where a captured batch's host time goes: each call's host clock (the
    # device runs behind; the metric's copy to the host waits for it)
    parts = {"forward (the batch's copy in)": [], "backward (replay)": [],
             "update": [], "update_metric": []}
    metric = mx.metric.create("accuracy")
    for i in range(steps):
        b = batches[i % len(batches)]
        t = [time.perf_counter()]
        mod_c.forward(b, is_train=True)
        t.append(time.perf_counter())
        mod_c.backward()
        t.append(time.perf_counter())
        mod_c.update()
        t.append(time.perf_counter())
        mod_c.update_metric(metric, b.label)
        t.append(time.perf_counter())
        for part, a, z in zip(parts, t, t[1:]):
            parts[part].append((z - a) * 1e3)
    log("symbolic %s: a captured batch's host time by call (median of %d "
        "after %d): %s" % (network, steps - warm, warm, ", ".join(
            "%s %.4f ms" % (k, float(np.median(v[warm:])))
            for k, v in parts.items())))
    del mod_c, mod_e, runs
    torch.cuda.empty_cache()

    # 4. the main path: Module.fit as train_mnist.py calls it
    prefix_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        prefix = prefix_dir + "/" + network
        np.random.seed(seed)  # MNISTIter's shuffle
        train, val = _mnist_iter(True, True), _mnist_iter(False, False)
        mod = mx.mod.Module(_mnist_net(network), context=card)
        ends = []
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        mod.fit(train, eval_data=val, eval_metric=["accuracy"],
                num_epoch=epochs, optimizer="sgd",
                optimizer_params=_fit_params(), kvstore="device",
                arg_params=params[0], aux_params=params[1],
                batch_end_callback=[mx.callback.Speedometer(SYM_BATCH, 20),
                                    lambda p: ends.append(
                                        time.perf_counter())],
                epoch_end_callback=mx.callback.do_checkpoint(prefix))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counters.items()}
        # ---- end of the main path
        acc = dict(mod.score(val, "accuracy"))["accuracy"]
        host_ms = float(np.median(np.diff(ends))) * 1e3
        ex = mod._exec_group.execs[0]
        (graph,) = ex.graphs.values()
        log("symbolic %s: Module.fit %d epoch(s) of %d batches on %s in "
            "%.2f s wall (validation and checkpoints included); the Module "
            "loop %.4f ms of host time a batch (median; forward_backward, "
            "update, the metric's host copy, callbacks), %.0f samples/s; "
            "validation accuracy %.4f; wrapper counts %s over the main path "
            "(1 eager warm-up + 1 capture; %d replays)" % (
                network, epochs, SYM_EPOCH, smi, wall, host_ms,
                SYM_BATCH / host_ms * 1e3, acc, launches, graph.replays))
        if not acc > 0.9:
            raise AssertionError("symbolic %s: validation accuracy %.4f is "
                                 "not above 0.9" % (network, acc))
        if launches != {k: 2 * v for k, v in per_batch.items()}:
            raise AssertionError("symbolic %s: the main path did not launch "
                                 "K1b and K2 at warm-up and capture"
                                 % network)
        # the checkpoint of the last epoch, read back
        again = mx.mod.Module.load(prefix, epochs, context=card)
        again.bind(val.provide_data, val.provide_label, for_training=False)
        want = mod.predict(val)
        got = again.predict(val)
        log("symbolic %s: do_checkpoint's epoch-%d checkpoint read back "
            "predicts %s, bitwise equal to the trained Module's %s, finite "
            "%s" % (network, epochs, tuple(got.shape),
                    np.array_equal(got.asnumpy(), want.asnumpy()),
                    bool(np.isfinite(got.asnumpy()).all())))
        if got.shape != (SYM_BATCH * (1000 // SYM_BATCH), 10) or \
                not np.array_equal(got.asnumpy(), want.asnumpy()) or \
                not np.isfinite(got.asnumpy()).all():
            raise AssertionError("symbolic %s: the checkpoint does not "
                                 "predict as the Module" % network)
    finally:
        shutil.rmtree(prefix_dir, ignore_errors=True)

    # 5. 3 replayed batches under the profiler: the device's busy share,
    # its time by group and, for LeNet, K1b's and K2's launches
    traced = 3
    seen = profile_steps(lambda: _train_batches(mod, batches, 1), smi,
                         step_ms[True], steps=traced, groups=SYM_GROUPS,
                         tag="symbolic %s" % network, count=LENET_KERNELS)
    if network == "lenet":
        if seen is not None:
            want = {k: n * traced for k, _, n in LENET_KERNELS}
            log("symbolic lenet: launches in the trace of %d replayed "
                "batches %s; expected %s" % (traced, seen, want))
            if seen != want:
                raise AssertionError("the replayed LeNet batch does not "
                                     "launch K1b and K2 once per "
                                     "convolution and pool")
    del mod
    torch.cuda.empty_cache()
    return {k: dict(launches=n, traced_replays=traced,
                    launches_in_traced_replays=None if seen is None
                    else seen[k]) for k, n in launches.items()}


def symbolic(seed, smi):
    """Phase 8: train_mnist.py's MLP (2 epochs) and LeNet (1 epoch)
    through the symbolic path, Symbol -> Executor -> Module, on the card.
    Returns LeNet's launch counts."""
    import logging

    # Module.fit's and Speedometer's lines, as train_mnist.py shows them
    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s", force=True)
    symbolic_net("mlp", 2, seed, smi)
    return symbolic_net("lenet", 1, seed, smi)


# ---------------------------------------------------------------- word LM

# phase 9: batches of the main path (hybridized), of the eager timing run
# and the window whose perplexity is compared at each end
LM_STEPS, LM_EAGER_STEPS, LM_WARMUP, LM_PPL_WINDOW = 600, 20, 5, 20
# the hybridized model vs eager on the card, as phase 5's
LM_HYBRID_TOL = 1e-5
# a dropout mask's kept share: 455,000 draws at p = 0.5 (std 0.0007)
LM_KEEP_TOL = 0.01
# device kernels of a word-LM step by what they do (the forward's and
# the backward's by name, the first match wins; every kernel of the clip
# and of the update is theirs)
LM_GROUPS = (("matrix products", ("gemm", "gemv", "splitk", "xmma",
                                  "cutlass")),
             ("softmax-CE (log-softmax)", ("softmax",)),
             ("embedding rows and the loss's pick (gather, index, sort)",
              ("index", "gather", "scatter", "sort", "radix",
               "embedding")),
             ("element-wise (LSTM gates, dropout, the rest)", ("",)))
LM_PHASES = ("forward", "backward", "clip", "update")


def _word_lm(device, dropout, seed=None):
    """PTB_MEDIUM's RNNModel with deferred widths; ``seed``: initialized
    with Uniform(0.05) from that seed (drawn at the first forward)."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    c = W.PTB_MEDIUM
    net = W.RNNModel(c["vocab"], c["num_embed"], c["num_hidden"],
                     c["num_layers"], dropout=dropout, device=device)
    if seed is not None:
        net.initialize(initializer.Uniform(c["init_scale"]), seed=seed)
    return net


def _lm_copy(net, device, dropout):
    from mxnet_tpu_torch.convert import load_mxnet_tpu_params

    return load_mxnet_tpu_params(_word_lm(device, dropout), {
        k: v.detach().cpu().numpy() for k, v in net.state_dict().items()})


def _lm_data(seed, batches):
    """The synthetic corpus of ``batches`` batches, (T, batch) ids on the
    card."""
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    c = W.PTB_MEDIUM
    corpus, _ = W.synthetic_corpus(
        num_tokens=(batches * c["bptt"] + 1) * c["batch_size"],
        vocab=c["vocab"], seed=seed)
    return torch.from_numpy(W.batchify(corpus, c["batch_size"]).copy()) \
        .cuda()


def _lm_batch(data, i):
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    t = W.PTB_MEDIUM["bptt"]
    return data[i * t:(i + 1) * t], data[i * t + 1:(i + 1) * t + 1]


def _lm_record(net, x, y, hidden):
    """One recorded forward and backward: (per-token loss, logits, the
    new states)."""
    from mxnet_tpu_torch import autograd, gluon

    with autograd.record():
        out, hidden = net(x, hidden)
        loss = gluon.loss.SoftmaxCrossEntropyLoss()(out, y.reshape(-1))
    autograd.backward(loss)
    return loss.detach(), out.detach(), hidden


def _lm_trainer(net):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    return gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": W.PTB_MEDIUM["lr"]})


def _lm_steps(net, trainer, data, first, n, at=None):
    """``n`` training steps of the word-LM loop from batch ``first``: the
    states carried and detached, the loss per token summed over the bptt
    steps and averaged over the batch (PTB_MEDIUM), the gradients'
    global norm clipped to 5, SGD.  ``at(step, i)`` is called at the
    boundaries i = 0..4 around forward, backward, clip and update.
    Returns the mean losses (on the card) and the norms."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    c = W.PTB_MEDIUM
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    params = list(net.collect_params().values())
    hidden = net.begin_state(batch_size=c["batch_size"])
    losses, norms = [], []
    at = at or (lambda step, i: None)
    for step in range(n):
        x, y = _lm_batch(data, first + step)
        hidden = W.detach(hidden)
        at(step, 0)
        with autograd.record():
            out, hidden = net(x, hidden)
            loss = loss_fn(out, y.reshape(-1))
        losses.append(loss.detach().mean())
        at(step, 1)
        autograd.backward(loss)
        at(step, 2)
        norms.append(gluon.utils.clip_global_norm(
            [p.grad for p in params], c["clip"] * c["batch_size"]))
        at(step, 3)
        trainer.step(c["batch_size"])
        at(step, 4)
    return losses, norms


def _lm_timed(net, trainer, data, n, smi, tag):
    """``n`` steps timed by CUDA events at the phase boundaries: the mean
    step after LM_WARMUP and its split, tokens/s and peak memory.
    Returns the step's ms, the losses and the norms."""
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)]
              for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, norms = _lm_steps(net, trainer, data, 0, n,
                              lambda step, i: events[step][i].record())
    torch.cuda.synchronize()
    split = np.array([[a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
                      for ev in events[LM_WARMUP:]])
    parts = split.mean(axis=0)
    step_ms = split.sum(axis=1).mean()
    tokens = W.PTB_MEDIUM["bptt"] * W.PTB_MEDIUM["batch_size"]
    log("word LM: %s step %.3f ms on %s (mean of %d after %d warmup): %s; "
        "%.0f tokens/s; peak memory %.3f GB" % (
            tag, step_ms, smi, n - LM_WARMUP, LM_WARMUP,
            ", ".join("%s %.3f ms" % kv for kv in zip(LM_PHASES, parts)),
            tokens / step_ms * 1e3, torch.cuda.max_memory_allocated() / 1e9))
    return step_ms, losses, norms


def _lm_profile(run, smi, step_ms, tag, steps=3):
    """Device time of a word-LM step by group and the device's busy
    share from a torch.profiler trace of ``steps`` steps.  ``run(first,
    n, at)`` runs n steps from batch ``first``, and ``at`` launches a
    marker kernel (torch.cuda._sleep, a spin kernel) before each of a
    step's four phases; the kernels of one stream run in order, so each
    kernel belongs to the phase of the marker before it.  One more step
    runs first in the same profiler session (its first events can be
    lost); the timed steps' kernels start at the last 4 x ``steps``
    markers.  A trace with fewer markers is reported, its groups not
    measured."""
    from torch.profiler import ProfilerActivity, profile

    def mark(_step, boundary):
        if boundary < 4:  # before forward, backward, clip and update
            torch.cuda._sleep(1)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(0, 1, mark)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(1, steps, mark)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    marks = [i for i, (_, _, name) in enumerate(spans)
             if "spin_kernel" in name]
    if len(marks) < 4 * steps:
        log("word LM: %s, profiled %d steps on %s: the trace holds %d "
            "device events and %d of %d phase markers: busy share and "
            "time by group not measured" % (tag, steps + 1, smi,
                                            len(spans), len(marks),
                                            4 * steps + 4))
        return
    totals = dict.fromkeys([g for g, _ in LM_GROUPS] + ["clip",
                                                        "optimizer"], 0.0)
    busy, end, seen, kernels = 0.0, None, -1, 0
    for t_start, t_end, name in spans[marks[-4 * steps]:]:
        if "spin_kernel" in name:
            seen += 1
            continue
        phase = LM_PHASES[seen % 4]
        if phase in ("forward", "backward"):
            group = next(g for g, keys in LM_GROUPS
                         if any(k in name.lower() for k in keys))
        else:
            group = "clip" if phase == "clip" else "optimizer"
        totals[group] += t_end - t_start
        kernels += 1
        if end is None or t_start > end:
            busy += t_end - t_start
            end = t_end
        elif t_end > end:
            busy += t_end - end
            end = t_end
    total = sum(totals.values())
    log("word LM: %s, profiled %d steps on %s (%d of %d phase markers "
        "seen): %.2f ms of wall, device busy %.1f %% of it; %.0f kernels a "
        "step; device time a step %.3f ms (%.1f %% of the unprofiled step, "
        "%.3f ms); by group: %s" % (
            tag, steps, smi, len(marks), 4 * steps + 4, wall_us / 1e3,
            100.0 * busy / wall_us, kernels / steps, total / steps / 1e3,
            100.0 * total / steps / 1e3 / step_ms, step_ms,
            ", ".join("%s %.3f ms (%.1f %%)" % (
                g, t / steps / 1e3, 100.0 * t / total)
                for g, t in totals.items())))


def _lm_counters():
    """Every hand kernel's launch counter, by the kernel's ID."""
    from mxnet_tpu_torch import rtc
    from mxnet_tpu_torch.ops import attention as A

    counters = {"K3": A.flash_attention, "K4a": A.flash_attention_bwd_dq,
                "K4b": A.flash_attention_bwd_dkv, "K5": rtc.CudaKernel}
    for key, fn in _resnet_counters().items():
        counters[{"pertap": "K1a", "im2col": "K1b", "maxpool": "K2",
                  "batch_norm_fwd": "K6a",
                  "batch_norm_bwd": "K6b"}[key]] = fn
    return counters


def lm_card_vs_cpu(seed, data):
    """Phase 9a: the first batch at dropout 0, the same weights on the
    card and on the CPU plain path: the loss and every parameter gradient
    within GRAD_TOL of its largest magnitude.  Returns the card's
    model."""
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    net = _word_lm("cuda", 0.0, seed)
    x, y = _lm_batch(data, 0)
    b = W.PTB_MEDIUM["batch_size"]
    loss, _, _ = _lm_record(net, x, y, net.begin_state(batch_size=b))
    got = {k: p.grad.clone() for k, p in net.collect_params().items()}
    cpu = _lm_copy(net, "cpu", 0.0)
    want_loss, _, _ = _lm_record(cpu, x.cpu(), y.cpu(), cpu.begin_state(
        batch_size=b, device="cpu"))
    errs = {"loss": _rel_err(loss.cpu(), want_loss)}
    for k, p in cpu.collect_params().items():
        errs[k] = _rel_err(got[k].cpu(), p.grad)
    worst = max(errs, key=errs.get)
    log("word LM: card vs CPU plain path at the first batch (35, 20), "
        "dropout 0: loss %.6f vs %.6f; loss and %d gradients, worst %.3g of "
        "the largest magnitude (%s; tol %.0e)" % (
            loss.mean().item(), want_loss.mean().item(), len(got),
            errs[worst], worst, GRAD_TOL))
    if errs[worst] > GRAD_TOL or not np.isfinite(loss.mean().item()):
        raise AssertionError("the word LM on the card disagrees with the "
                             "CPU plain path")
    return net


def lm_hybrid_vs_eager(net, data):
    """Phase 9b: two record/backward calls of a hybridized copy (the
    whole model one captured forward and backward, the LSTM layer inside
    it) against the eager model, the states carried: logits, states and
    every gradient within LM_HYBRID_TOL of each largest magnitude."""
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    hyb = _lm_copy(net, "cuda", 0.0)
    hyb.hybridize()
    b = W.PTB_MEDIUM["batch_size"]
    he, hh = net.begin_state(batch_size=b), hyb.begin_state(batch_size=b)
    worst, name = 0.0, None
    for call in range(2):
        x, y = _lm_batch(data, call)
        le, oe, he = _lm_record(net, x, y, W.detach(he))
        lh, oh, hh = _lm_record(hyb, x, y, W.detach(hh))
        errs = {"loss": _rel_err(lh, le), "logits": _rel_err(oh, oe),
                "h": _rel_err(hh[0].detach(), he[0].detach()),
                "c": _rel_err(hh[1].detach(), he[1].detach())}
        grads = dict(hyb.collect_params().items())
        for k, p in net.collect_params().items():
            errs[k] = _rel_err(grads[k].grad, p.grad)
        call_worst = max(errs, key=errs.get)
        if errs[call_worst] >= worst:
            worst, name = errs[call_worst], call_worst
    (graph,) = hyb._cached_graphs.values()
    log("word LM: hybridized model, 2 record/backward calls (states "
        "carried) vs eager on the card: worst %.3g of the largest magnitude "
        "(%s; tol %.0e); %d cached graph(s), %d forward replays, backward "
        "graph %s" % (worst, name, LM_HYBRID_TOL, len(hyb._cached_graphs),
                      graph.replays, graph.bwd is not None))
    if worst > LM_HYBRID_TOL or graph.replays != 2 or graph.bwd is None:
        raise AssertionError("the hybridized word LM disagrees with eager "
                             "execution or did not replay its graphs")


def lm_dropout_in_graphs():
    """Phase 9c: dropout at p = 0.5 inside captured graphs, through the
    Dropout layer and through the RNN op's inter-layer dropout (a 2-layer
    relu RNN whose layer 0 gives ones and layer 1 is the identity, so its
    output is the mask times 2): two replays draw other masks, each
    keeping 0.5 within LM_KEEP_TOL."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch.gluon import nn, rnn

    ones = torch.ones(35, 20, 650, device="cuda")
    drop = nn.Dropout(0.5, device="cuda")
    layer = rnn.RNN(650, 2, activation="relu", dropout=0.5, input_size=650,
                    device="cuda")
    with torch.no_grad():
        for p in layer.parameters():
            p.zero_()
        layer.l0_i2h_bias.fill_(1.0)
        layer.l1_i2h_weight.copy_(torch.eye(650, device="cuda"))
    for what, block in (("Dropout layer", drop), ("RNN op", layer)):
        block.hybridize()
        with autograd.train_mode():
            outs = [block(ones) for _ in range(2)]
        (graph,) = block._cached_graphs.values()
        kept = [(o > 0).float().mean().item() for o in outs]
        values = set(torch.unique(outs[0]).tolist())
        log("word LM: %s at p = 0.5 in a captured graph: kept %.4f and "
            "%.4f in 2 replays, masks differ %s, values %s" % (
                what, kept[0], kept[1], not torch.equal(outs[0], outs[1]),
                sorted(values)))
        if graph.replays != 2 or torch.equal(outs[0], outs[1]) \
                or any(abs(k - 0.5) > LM_KEEP_TOL for k in kept) \
                or not values <= {0.0, 2.0}:
            raise AssertionError("dropout in a captured graph repeats its "
                                 "mask or keeps the wrong share")


def lm_yardstick(seed, smi):
    """Phase 9f, never on the path: the port's LSTM layer (2 layers, 650,
    at (35, 20, 650)) forward plus backward, eager and hybridized, beside
    torch.nn.LSTM (cuDNN) given the same weights; both times and the
    largest differences of output and weight gradients."""
    from mxnet_tpu_torch import autograd, initializer
    from mxnet_tpu_torch.gluon import rnn

    layer = rnn.LSTM(650, 2, input_size=650, device="cuda").initialize(
        initializer.Uniform(0.05), seed=seed)
    ref = torch.nn.LSTM(650, 650, num_layers=2).cuda()
    with torch.no_grad():
        for i in range(2):
            for theirs, ours in (("weight_ih", "i2h_weight"),
                                 ("weight_hh", "h2h_weight"),
                                 ("bias_ih", "i2h_bias"),
                                 ("bias_hh", "h2h_bias")):
                getattr(ref, "%s_l%d" % (theirs, i)).copy_(
                    getattr(layer, "l%d_%s" % (i, ours)))
    rng = np.random.RandomState(seed + 9)
    x = torch.from_numpy(rng.randn(35, 20, 650).astype(np.float32)).cuda()
    g = torch.from_numpy(rng.randn(35, 20, 650).astype(np.float32)).cuda()
    h0 = [torch.zeros(2, 20, 650, device="cuda") for _ in range(2)]

    def ours(block):
        with autograd.record():
            out, _ = block(x, h0)
        autograd.backward(out, g)
        return out

    def theirs():
        ref.zero_grad()
        out, _ = ref(x, tuple(h0))
        out.backward(g)
        return out

    out_ours, out_ref = ours(layer).detach(), theirs().detach()
    grad_err = max(
        _rel_err(getattr(layer, "l%d_%s" % (i, o)).grad,
                 getattr(ref, "%s_l%d" % (t, i)).grad)
        for i in range(2) for t, o in (("weight_ih", "i2h_weight"),
                                       ("weight_hh", "h2h_weight")))
    ms_ours = time_ms(lambda: ours(layer), iters=10)
    ms_ref = time_ms(theirs, iters=10)
    hyb = rnn.LSTM(650, 2, input_size=650, device="cuda")
    hyb.load_state_dict(layer.state_dict())
    hyb.hybridize()
    ms_hyb = time_ms(lambda: ours(hyb), iters=10)
    log("word LM: yardstick (not on the path), LSTM 2 x 650 at (35, 20, "
        "650) forward + backward on %s: the port's layer %.3f ms eager, "
        "%.3f ms hybridized (captured); torch.nn.LSTM (cuDNN) %.3f ms; "
        "largest difference: output %.3g (%.3g of its largest magnitude), "
        "weight gradients %.3g of their largest magnitude" % (
            smi, ms_ours, ms_hyb, ms_ref,
            (out_ours - out_ref).abs().max().item(),
            _rel_err(out_ours, out_ref), grad_err))


def word_lm(seed, smi):
    """Phase 9: PTB_MEDIUM's word LM (vocab 10000, 650/650, 2 layers,
    bptt 35, batch 20, dropout 0.5) on the card."""
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.gluon.model_zoo import word_lm as W

    mx_random.seed(seed)  # the dropout masks' stream
    data = _lm_data(seed, LM_STEPS)
    net = lm_card_vs_cpu(seed, data)
    lm_hybrid_vs_eager(net, data)
    del net
    lm_dropout_in_graphs()

    # the eager loop, timed
    eager = _word_lm("cuda", 0.5, seed)
    trainer = _lm_trainer(eager)
    eager_ms, _, _ = _lm_timed(eager, trainer, data, LM_EAGER_STEPS, smi,
                               "eager")
    _lm_profile(lambda first, n, at: _lm_steps(eager, trainer, data, first,
                                               n, at), smi, eager_ms, "eager")
    del eager, trainer

    # the main path: the hybridized model, its Trainer built before the
    # first forward gives the deferred widths
    model = _word_lm("cuda", 0.5, seed)
    trainer = _lm_trainer(model)
    model.hybridize()
    counters = _lm_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    hyb_ms, losses, norms = _lm_timed(model, trainer, data, LM_STEPS, smi,
                                      "hybridized")
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    # ---- end of the main path
    losses = np.array([v.item() for v in losses])
    first = float(np.exp(losses[:LM_PPL_WINDOW].mean()))
    last = float(np.exp(losses[-LM_PPL_WINDOW:].mean()))
    c = W.PTB_MEDIUM
    clipped = sum(n > c["clip"] * c["batch_size"] for n in norms)
    log("word LM: %d hybridized steps (SGD lr %g, clip %g) on the synthetic "
        "corpus: perplexity of the first %d batches %.1f, of the last %d "
        "%.1f; loss %.4f -> %.4f; the clip rescaled %d of %d steps; %.2f s "
        "wall on %s" % (LM_STEPS, c["lr"], c["clip"], LM_PPL_WINDOW, first,
                        LM_PPL_WINDOW, last, losses[0], losses[-1], clipped,
                        LM_STEPS, wall, smi))
    if not np.all(np.isfinite(losses)) or not last < first:
        raise AssertionError("the word LM's loss is not finite or its "
                             "perplexity did not fall")
    log("word LM: launches of the port's hand kernels on the main path: "
        "%s (the path runs none of K1-K6)" % launched)
    if any(launched.values()):
        raise AssertionError("the word-LM path launched a hand kernel")
    (graph,) = model._cached_graphs.values()
    log("word LM: the model is %d cached graph(s), %d calls, %d forward "
        "replays" % (len(model._cached_graphs), graph.calls, graph.replays))
    _lm_profile(lambda first, n, at: _lm_steps(model, trainer, data, first,
                                               n, at), smi, hyb_ms,
                "hybridized")
    del model, trainer
    lm_yardstick(seed, smi)
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- bucketing

# phase 10: example/rnn/bucketing/lstm_bucketing.py at the widths of the
# upstream MXNet example (--num-layers 2 --num-hidden 200 --num-embed 200
# --batch-size 32, buckets 10-60, invalid label 0, SGD lr 0.01, momentum
# 0, wd 1e-5, Xavier(factor_type="in", magnitude=2.34)), PTB's vocabulary
BK_VOCAB, BK_EMBED, BK_HIDDEN, BK_LAYERS, BK_BATCH = 10000, 200, 200, 2, 32
BK_BUCKETS = [10, 20, 30, 40, 50, 60]
BK_SGD = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5}
# the synthetic corpus: sentences of 2-60 tokens, ring walks whose next
# token is the last plus one, or (with BK_NOISE) an id drawn from a Zipf
# law over the ids (rank = id); training and validation sentences
BK_NOISE, BK_ZIPF = 0.15, 1.0
BK_TRAIN, BK_VAL = 12800, 1280
BK_PPL_WINDOW = 20
# the card vs the CPU (share of each largest magnitude), the fused cell
# vs its unfused stack
BK_GRAD_TOL, BK_FUSED_TOL = 1e-3, 1e-5
BK_GROUPS = (("matrix products", ("gemm", "gemv", "splitk", "xmma",
                                  "cutlass")),
             ("softmax", ("softmax",)),
             ("element-wise (gates, their gradients, the update)",
              ("elementwise", "vectorized", "reduce", "fill", "copy",
               "memcpy", "memset", "cat", "index")))


def _bk_corpus(n, seed):
    """``n`` sentences of 2-60 token ids: noisy ring walks over the
    vocabulary (lstm_bucketing.py's synthetic corpus, 0 kept for the
    padding), the noise a Zipf law over the ids."""
    rs = np.random.RandomState(seed)
    lengths = rs.randint(2, 61, n)
    starts = rs.randint(1, BK_VOCAB, n)
    total = int(lengths.sum())
    noise = rs.rand(total) < BK_NOISE
    law = 1.0 / np.arange(1, BK_VOCAB) ** BK_ZIPF
    draws = rs.choice(np.arange(1, BK_VOCAB), size=total, p=law / law.sum())
    sentences, pos = [], 0
    for length, tok in zip(lengths, starts):
        sent = [int(tok)]
        for _ in range(length - 1):
            tok = draws[pos] if noise[pos] else tok % (BK_VOCAB - 1) + 1
            sent.append(int(tok))
            pos += 1
        sentences.append(sent)
    return sentences


def _bk_sym_gen(cell="stack"):
    """lstm_bucketing.py's build_sym_gen on the port's mx.sym and mx.rnn;
    ``cell``: "stack" (LSTMCells), "fused" (upstream's
    cudnn_rnn_bucketing.py form) or a cell.  Returns (sym_gen, cell)."""
    import mxnet_tpu_torch as mx

    if cell == "stack":
        cell = mx.rnn.SequentialRNNCell()
        for i in range(BK_LAYERS):
            cell.add(mx.rnn.LSTMCell(BK_HIDDEN, prefix="lstm_l%d_" % i))
    elif cell == "fused":
        cell = mx.rnn.FusedRNNCell(BK_HIDDEN, num_layers=BK_LAYERS,
                                   mode="lstm", prefix="lstm_")

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data=data, input_dim=BK_VOCAB,
                                 output_dim=BK_EMBED, name="embed")
        cell.reset()
        outputs, _ = cell.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, BK_HIDDEN))
        pred = mx.sym.FullyConnected(data=pred, num_hidden=BK_VOCAB,
                                     name="pred")
        pred = mx.sym.SoftmaxOutput(data=pred, label=mx.sym.Reshape(
            label, shape=(-1,)), name="softmax")
        return pred, ("data",), ("softmax_label",)

    return sym_gen, cell


def _bk_iters(seed):
    import random

    import mxnet_tpu_torch as mx

    random.seed(seed)  # the iterators' shuffles
    np.random.seed(seed)
    sentences = _bk_corpus(BK_TRAIN + BK_VAL, seed)
    return [mx.rnn.BucketSentenceIter(part, BK_BATCH, buckets=BK_BUCKETS,
                                      invalid_label=0)
            for part in (sentences[:BK_TRAIN], sentences[BK_TRAIN:])]


def _bk_module(device, params, sym_gen=None, default=BK_BUCKETS[-1],
               sgd=BK_SGD):
    """A BucketingModule bound for training at ``default`` on ``device``,
    from the host ``params``, with the example's SGD."""
    import mxnet_tpu_torch as mx

    shape = (BK_BATCH, default)
    mod = mx.mod.BucketingModule(sym_gen or _bk_sym_gen()[0], default,
                                 context=device)
    mod.bind([("data", shape)], [("softmax_label", shape)])
    mod.init_params(arg_params=params[0], aux_params=params[1])
    mod.init_optimizer(optimizer="sgd", optimizer_params=sgd)
    return mod


def _bk_first_batches(it):
    """The first batch of each bucket, in BK_BUCKETS order."""
    it.reset()
    first = {}
    for b in it:
        first.setdefault(b.bucket_key, b)
    return [first[k] for k in BK_BUCKETS]


def _bk_ex(mod):
    return mod._curr_module._exec_group.execs[0]


def _bk_state(mod):
    """Every bound array of the current bucket: arguments, gradients."""
    ex = _bk_ex(mod)
    return [a.data_torch.clone() for a in ex.arg_arrays] + \
        [g.data_torch.clone() for g in ex.grad_dict.values()]


def _bk_step(mod, batch):
    mod.forward_backward(batch)
    mod.update()
    return mod.get_outputs()[0].data_torch


def bk_card_vs_cpu(params, batch):
    """Phase 10, 1: the first batch at bucket 10 on the card and on the
    CPU plain path from the same parameters: the loss (the mean cross
    entropy SoftmaxOutput trains) and every gradient within BK_GRAD_TOL of
    its largest magnitude."""
    got = {}
    for where, dev in (("card", torch.device("cuda", 0)),
                       ("cpu", torch.device("cpu"))):
        mod = _bk_module(dev, params, default=batch.bucket_key)
        mod.forward_backward(batch)
        probs = mod.get_outputs()[0].asnumpy()
        label = batch.label[0].asnumpy().astype(np.int64).ravel()
        got[where] = {k: g.asnumpy() for k, g in
                      _bk_ex(mod).grad_dict.items()}
        got[where]["loss"] = np.array(-np.log(np.maximum(
            probs[np.arange(label.size), label], 1e-30)).mean())
    errs = {k: float(np.abs(got["card"][k] - w).max())
            / max(float(np.abs(w).max()), 1e-30)
            for k, w in got["cpu"].items()}
    worst = max((e, k) for k, e in errs.items())
    log("bucketing: the first batch at bucket %d on the card vs the CPU "
        "plain path: loss %.6f vs %.6f; worst %.3g of the largest magnitude "
        "(%s; tol %.0e); each: %s" % (
            batch.bucket_key, float(got["card"]["loss"]),
            float(got["cpu"]["loss"]), worst[0], worst[1], BK_GRAD_TOL,
            ", ".join("%s %.2g" % kv for kv in errs.items())))
    if not worst[0] <= BK_GRAD_TOL:
        raise AssertionError("bucketing: the card's gradients disagree "
                             "with the CPU's")


def bk_captured_vs_eager(params, batches, smi):
    """Phase 10, 2: a captured and an eager (``capture = False``)
    BucketingModule from the same state, one forward_backward + update a
    bucket in turn, bitwise equal; each bucket's bind and first (capture)
    batch timed; then each bucket's step captured and eager by CUDA
    events, and bucket 60 under the profiler.  Returns the captured
    times."""
    card = torch.device("cuda", 0)
    bind_ms, first_ms = {}, {}
    mods = {}
    for capture in (True, False):
        t0 = time.perf_counter()
        mods[capture] = _bk_module(card, params)
        if capture:
            bind_ms[BK_BUCKETS[-1]] = (time.perf_counter() - t0) * 1e3
    for capture, mod in mods.items():
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.switch_bucket(b.bucket_key, b.provide_data, b.provide_label)
            if capture and b.bucket_key != BK_BUCKETS[-1]:
                bind_ms[b.bucket_key] = (time.perf_counter() - t0) * 1e3
            _bk_ex(mod).capture = capture
    for b in batches:
        outs = {}
        for capture, mod in mods.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[capture] = [_bk_step(mod, b).clone()] + _bk_state(mod)
            torch.cuda.synchronize()
            if capture:
                first_ms[b.bucket_key] = (time.perf_counter() - t0) * 1e3
        diff = sum(not torch.equal(a, c)
                   for a, c in zip(outs[True], outs[False]))
        graphs = len(_bk_ex(mods[True]).graphs)
        log("bucketing: bucket %d: bind %.1f ms, first captured batch (warm-"
            "up + capture) %.1f ms; captured vs eager from the same state: "
            "%d of %d outputs, arguments and gradients differ; %d graph" % (
                b.bucket_key, bind_ms[b.bucket_key],
                first_ms[b.bucket_key], diff, len(outs[True]), graphs))
        if diff or graphs != 1:
            raise AssertionError("bucketing: the captured batch differs from "
                                 "the eager one at bucket %d" % b.bucket_key)
    step_ms = {}
    for b in batches:
        key = b.bucket_key
        for capture, iters in ((True, 10), (False, 3)):
            mod = mods[capture]
            step_ms[key, capture] = time_ms(lambda: _bk_step(mod, b), iters)
        log("bucketing: bucket %d forward_backward + update on %s: captured "
            "%.3f ms (%.0f padded tokens/s), eager %.3f ms (%.0f)" % (
                key, smi, step_ms[key, True],
                BK_BATCH * key / step_ms[key, True] * 1e3,
                step_ms[key, False],
                BK_BATCH * key / step_ms[key, False] * 1e3))
    last = batches[-1]
    for capture in (True, False):
        mod = mods[capture]
        seen = profile_steps(lambda: _bk_step(mod, last), smi,
                             step_ms[last.bucket_key, capture], steps=3,
                             groups=BK_GROUPS,
                             tag="bucketing %s at bucket %d" % (
                                 "captured" if capture else "eager",
                                 last.bucket_key),
                             count=(("all", ("",), 0),))
        log("bucketing: %s at bucket %d: %s kernels a batch" % (
            "captured" if capture else "eager", last.bucket_key,
            "not measured" if seen is None else "%.0f" % (seen["all"] / 3)))
    del mods
    torch.cuda.empty_cache()
    return {k: v for (k, c), v in step_ms.items() if c}


def bk_fused_vs_unfused(params, batches, smi):
    """Phase 10, 4: the FusedRNNCell form (the registered RNN op) and its
    unfuse() stack, the weights carried through unpack_weights and
    pack_weights, 3 batches each at buckets 10 and 60 in turn (weight
    decay 0: MXNet's no-decay rule exempts the packed vector): outputs
    and parameters within BK_FUSED_TOL; each form's captured step
    timed."""
    card = torch.device("cuda", 0)
    gen_f, fused = _bk_sym_gen("fused")
    gen_u, stack = _bk_sym_gen(fused.unfuse())
    args = fused.pack_weights(stack.unpack_weights(dict(params[0])))
    sgd = dict(BK_SGD, wd=0.0)
    mods = {"fused": _bk_module(card, (args, {}), gen_f, sgd=sgd),
            "unrolled": _bk_module(card, params, gen_u, sgd=sgd)}
    pair = [batches[0], batches[-1]]
    worst = 0.0
    for b in pair * 3:
        outs = {k: _bk_step(m, b).clone() for k, m in mods.items()}
        worst = max(worst, _rel_err(outs["fused"], outs["unrolled"]))
    got = stack.pack_weights(fused.unpack_weights(mods["fused"].get_params()[0]))
    want = mods["unrolled"].get_params()[0]
    worst_p = max(_rel_err(torch.from_numpy(got[k].asnumpy()),
                           torch.from_numpy(want[k].asnumpy()))
                  for k in want)
    times = {(k, b.bucket_key): time_ms(lambda: _bk_step(m, b), 10)
             for k, m in mods.items() for b in pair}
    log("bucketing: FusedRNNCell(200, num_layers=2, mode='lstm') vs its "
        "unfuse() stack, 3 batches at buckets 10 and 60 in turn on the "
        "card: outputs within %.3g, parameters within %.3g of each largest "
        "magnitude (tol %.0e); captured step on %s: fused %.3f / %.3f ms, "
        "unrolled %.3f / %.3f ms at buckets 10 / 60" % (
            worst, worst_p, BK_FUSED_TOL, smi, times["fused", 10],
            times["fused", 60], times["unrolled", 10],
            times["unrolled", 60]))
    if not max(worst, worst_p) <= BK_FUSED_TOL:
        raise AssertionError("bucketing: the fused cell disagrees with its "
                             "unfused stack")
    del mods
    torch.cuda.empty_cache()


def _convlstm_symbol():
    import mxnet_tpu_torch as mx

    c = CONVLSTM
    cell = mx.rnn.ConvLSTMCell((c["batch"], c["channels"], c["size"],
                                c["size"]), c["hidden"], prefix="cl_")
    out, _ = cell.unroll(c["steps"], inputs=mx.sym.Variable("data"),
                         merge_outputs=True)
    return out


def bk_convlstm(seed, smi):
    """Phase 10, 5: a ConvLSTM cell (3x3 i2h and h2h convolutions, NCHW)
    unrolled over 4 steps through an executor: the card (captured, K1b
    for the weight gradients) against the CPU plain path, every gradient
    within BK_GRAD_TOL of its largest magnitude; the wrappers' launches
    over the main path (3 backward calls: the eager warm-up, the capture,
    a replay) and in a profiler trace of 3 replays."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.ops import conv_dw as C

    c = CONVLSTM
    shape = (c["batch"], c["steps"], c["channels"], c["size"], c["size"])
    sym = _convlstm_symbol()
    rng = np.random.RandomState(seed + 10)
    arg_shapes, out_shapes, _ = sym.infer_shape(data=shape)
    values = {n: rng.uniform(-0.5, 0.5, s).astype(np.float32)
              for n, s in zip(sym.list_arguments(), arg_shapes)}
    head = rng.randn(*out_shapes[0]).astype(np.float32)
    grads, exs = {}, {}
    counters = {"pertap": C.conv_dw_pertap, "im2col": C.conv_dw_im2col}
    for where, dev in (("cpu", torch.device("cpu")),
                       ("card", torch.device("cuda", 0))):
        ex = sym.simple_bind(ctx=dev, data=shape)
        for n, v in values.items():
            ex.arg_dict[n][:] = mx.nd.array(v, ctx=dev)
        hd = mx.nd.array(head, ctx=dev)
        if where == "card":
            for fn in counters.values():
                fn.launches = 0
        for _ in range(3 if where == "card" else 1):
            ex.forward(is_train=True)
            ex.backward(hd)
        torch.cuda.synchronize()
        if where == "card":
            launches = {k: fn.launches for k, fn in counters.items()}
        grads[where] = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
        grads[where]["output"] = ex.outputs[0].asnumpy()
        exs[where] = ex
    # ---- end of the main path
    errs = {k: float(np.abs(grads["card"][k] - w).max())
            / max(float(np.abs(w).max()), 1e-30)
            for k, w in grads["cpu"].items()}
    worst = max((e, k) for k, e in errs.items())
    per_call = sum(n for _, n in CONVLSTM_CONVS)
    ex = exs["card"]
    log("bucketing: ConvLSTMCell %s x %d steps, hidden %d, on the card "
        "(captured) vs the CPU plain path: worst %.3g of the largest "
        "magnitude (%s; tol %.0e); wrapper launches over the main path %s "
        "(expected im2col 2 x %d: the warm-up's and the capture's; %d "
        "replays)" % (
            shape, c["steps"], c["hidden"], worst[0], worst[1], BK_GRAD_TOL,
            launches, per_call, next(iter(ex.graphs.values())).replays))
    if not worst[0] <= BK_GRAD_TOL:
        raise AssertionError("bucketing: the ConvLSTM cell's gradients on "
                             "the card disagree with the CPU's")
    if launches != {"pertap": 0, "im2col": 2 * per_call}:
        raise AssertionError("bucketing: the ConvLSTM cell did not launch "
                             "K1b once per convolution")
    traced = 3
    hd = mx.nd.array(head, ctx=torch.device("cuda", 0))

    def replay():
        ex.forward(is_train=True)
        ex.backward(hd)

    k1b = ("conv_dw_tf32_kernel<true",)
    seen = profile_steps(replay, smi, time_ms(replay, 10), steps=traced,
                         groups=(("K1b conv_dw im2col", k1b),) + BK_GROUPS,
                         tag="bucketing ConvLSTM",
                         count=(("im2col", k1b, per_call),))
    if seen is not None:
        log("bucketing: ConvLSTM launches of K1b in the trace of %d "
            "replays: %d (expected %d)" % (traced, seen["im2col"],
                                           traced * per_call))
        if seen["im2col"] != traced * per_call:
            raise AssertionError("the replayed ConvLSTM backward does not "
                                 "launch K1b once per convolution")
    del exs, ex
    torch.cuda.empty_cache()
    return dict(launches=launches["im2col"], traced_replays=traced,
                launches_in_traced_replays=None if seen is None
                else seen["im2col"])


def bucketing(seed, smi):
    """Phase 10: lstm_bucketing.py's model through BucketSentenceIter and
    BucketingModule on the card.  Returns the ConvLSTM cell's K1b
    launches."""
    import logging

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.module import executor_group

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s", force=True)
    t0 = time.perf_counter()
    train, val = _bk_iters(seed)
    log("bucketing: the synthetic corpus (%d + %d sentences of 2-60 tokens, "
        "vocab %d) and its iterators in %.2f s: buckets %s, %d training and "
        "%d validation batches" % (
            BK_TRAIN, BK_VAL, BK_VOCAB, time.perf_counter() - t0,
            train.buckets, len(train.idx), len(val.idx)))
    # the initial parameters from the seed, on the host
    mx.random.seed(seed)
    host = mx.mod.BucketingModule(_bk_sym_gen()[0], BK_BUCKETS[0],
                                  context=mx.cpu())
    host.bind([("data", (BK_BATCH, BK_BUCKETS[0]))],
              [("softmax_label", (BK_BATCH, BK_BUCKETS[0]))])
    host.init_params(mx.init.Xavier(factor_type="in", magnitude=2.34))
    params = tuple({k: v.copy() for k, v in d.items()}
                   for d in host.get_params())
    del host
    batches = _bk_first_batches(train)

    bk_card_vs_cpu(params, batches[0])
    step_ms = bk_captured_vs_eager(params, batches, smi)

    # 3. the main path: BucketingModule.fit over one pass
    card = torch.device("cuda", 0)
    counters = _lm_counters()
    copies = []
    group = executor_group.DataParallelExecutorGroup
    saved = group.get_params, group.set_params

    def counted(fn, what):
        def wrapper(self, *a, **k):
            copies.append(what)
            return fn(self, *a, **k)
        return wrapper

    group.get_params = counted(saved[0], "get_params")
    group.set_params = counted(saved[1], "set_params")
    mod = mx.mod.BucketingModule(_bk_sym_gen()[0], train.default_bucket_key,
                                 context=card)
    ends, keys, ppl, copies_in_loop = [], [], [], []
    metric = mx.metric.Perplexity(0)
    seen = {"sum": 0.0, "n": 0}  # the metric's sums at the batch before

    def batch_end(p):
        # before the Speedometer's, which resets the metric
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        keys.append(mod._curr_bucket_key)
        if metric.num_inst < seen["n"]:
            seen.update(sum=0.0, n=0)
        ppl.append(metric.sum_metric - seen["sum"])
        seen.update(sum=metric.sum_metric, n=metric.num_inst)
        copies_in_loop[:] = list(copies)

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train.reset()
    t0 = time.perf_counter()
    try:
        mod.fit(train, eval_data=val, eval_metric=metric, num_epoch=1,
                optimizer="sgd", optimizer_params=BK_SGD,
                arg_params=params[0], aux_params=params[1],
                batch_end_callback=[batch_end,
                                    mx.callback.Speedometer(BK_BATCH, 100)])
    finally:
        group.get_params, group.set_params = saved
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the main path
    val_ppl = dict(mod.score(val, mx.metric.Perplexity(0)))["perplexity"]
    ppl = np.array(ppl)
    first = float(ppl[:BK_PPL_WINDOW].mean())
    last = float(ppl[-BK_PPL_WINDOW:].mean())
    times = np.diff([t0] + ends) * 1e3
    # the batches after each bucket's first (its bind and capture)
    steady = [i for i, k in enumerate(keys) if k in keys[:i]]
    padded = BK_BATCH * np.array(keys, dtype=np.float64)
    train.reset()
    valid = sum(int((b.data[0].asnumpy() != 0).sum()) for b in train)
    log("bucketing: BucketingModule.fit, %d batches on %s in %.2f s wall "
        "(validation included); training perplexity of the first %d batches "
        "%.1f, of the last %d %.1f; validation perplexity %.1f; the loop "
        "%.0f padded and %.0f valid tokens/s over the pass (binds and "
        "captures included), %.0f padded tokens/s over the batches after "
        "each bucket's first; peak memory %.3f GB" % (
            len(keys), smi, wall, BK_PPL_WINDOW, first, BK_PPL_WINDOW, last,
            val_ppl, padded.sum() / times.sum() * 1e3,
            valid / times.sum() * 1e3,
            padded[steady].sum() / times[steady].sum() * 1e3, peak / 1e9))
    log("bucketing: training perplexity by window of 50 batches: %s" % (
        ", ".join("%.1f" % ppl[i:i + 50].mean()
                  for i in range(0, len(ppl), 50))))
    for key in BK_BUCKETS:
        sel = [i for i in steady if keys[i] == key]
        log("bucketing: bucket %d: %d batches, fit loop %.3f ms a batch "
            "(median of those after the first), captured step alone %.3f ms"
            % (key, keys.count(key), float(np.median(times[sel])),
               step_ms[key]))
    if not np.all(np.isfinite(ppl)) or not last < first:
        raise AssertionError("bucketing: the perplexity is not finite or "
                             "did not fall")
    default = mod._buckets[train.default_bucket_key]._exec_group.execs[0]
    shared = []
    for key, m in sorted(mod._buckets.items()):
        ex = m._exec_group.execs[0]
        shared.append(sum(ex.arg_dict[n] is default.arg_dict[n]
                          and ex.arg_dict[n].data_torch.data_ptr()
                          == default.arg_dict[n].data_torch.data_ptr()
                          for n in m._param_names))
        if len(ex.graphs) != 1:
            raise AssertionError("bucketing: bucket %d holds %d graphs"
                                 % (key, len(ex.graphs)))
    n_params = len(mod._buckets[BK_BUCKETS[-1]]._param_names)
    log("bucketing: %d buckets bound, one captured graph each; parameters "
        "shared by storage with the default bucket's executor: %s of %d; "
        "parameter copies between the host and the card up to the last of "
        "the %d training batches: %s (expected the initial set_params "
        "alone); hand-kernel launches over the main path: %s (the path "
        "runs none of K1-K6)" % (
            len(mod._buckets), shared, n_params, len(keys), copies_in_loop,
            launched))
    if sorted(mod._buckets) != BK_BUCKETS or shared != [n_params] * 6:
        raise AssertionError("bucketing: the buckets do not share their "
                             "parameters")
    if copies_in_loop != ["set_params"]:
        raise AssertionError("bucketing: a bucket switch copied parameters "
                             "through the host")
    if any(launched.values()):
        raise AssertionError("bucketing: the unrolled LSTM launched a hand "
                             "kernel")
    # where a fit batch's host time goes, by call (a fresh pass)
    parts = {"forward (the batch's copy in)": [], "backward (replay)": [],
             "update": [], "update_metric": []}
    metric = mx.metric.Perplexity(0)
    train.reset()
    for i, b in zip(range(60), train):
        t = [time.perf_counter()]
        mod.forward(b, is_train=True)
        t.append(time.perf_counter())
        mod.backward()
        t.append(time.perf_counter())
        mod.update()
        t.append(time.perf_counter())
        mod.update_metric(metric, b.label)
        t.append(time.perf_counter())
        for part, a, z in zip(parts, t, t[1:]):
            parts[part].append((z - a) * 1e3)
    log("bucketing: a fit batch's host time by call (median of 60 batches "
        "over every bucket): %s" % ", ".join(
            "%s %.4f ms" % (k, float(np.median(v))) for k, v in parts.items()))
    del mod
    torch.cuda.empty_cache()

    bk_fused_vs_unfused(params, batches, smi)
    return bk_convlstm(seed, smi)


# ---------------------------------------------------------------- SSD300

SSD_BATCH, SSD_SIZE, SSD_CLASSES, SSD_ANCHORS = 32, 300, 20, 8732
# the JAX example's learning rate (example/ssd/train.py: Adam, 2e-3) and
# box-loss weight; the card's rehearsal trained at it, 300 steps in 85 s
# (PERF.md), so the main path takes 250
SSD_LR, SSD_LOC_WEIGHT, SSD_NMS = 2e-3, 5.0, 0.45
# training scenes (1-3 boxes), cycled in shuffled epochs of 16 batches;
# the batches of the main path, from the rehearsal; the held-out
# single-box scenes of evaluate(); the loss window that must fall
SSD_SCENES, SSD_STEPS, SSD_VAL, SSD_WINDOW = 512, 250, 32, 20
# SSD300's dW launches a step by formulation and its max pools
SSD_K1A, SSD_K1B, SSD_K2 = 32, 3, 5
# input changes on the CPU that set the batch-2 check's noise floor: how
# many, and their relative size, that of a float32 sum of thousands of
# products whose order differs (the card's convolutions against the CPU's)
SSD_NOISE_DRAWS, SSD_INPUT_NOISE = 3, 1e-6
SSD_GROUPS = (
    ("K1a conv_dw pertap", ("conv_dw_tf32_kernel<false",)),
    ("K1b conv_dw im2col", ("conv_dw_tf32_kernel<true",)),
    ("K1 split-K sum", ("conv_dw_reduce",)),
    ("K2 maxpool_bwd", ("maxpool_bwd_kernel",)),
    ("K7 box_nms", ("nms_scan_kernel", "nms_walk_kernel")),
    # cuDNN picks FFT algorithms for some float32 convolutions
    ("cuDNN conv fwd/dgrad", ("conv", "cudnn", "xmma", "fprop", "dgrad",
                              "implicit", "gemm", "cutlass", "sm90", "fft",
                              "complex")),
    ("pooling fwd", ("pool",)),
    ("sorts (MultiBoxTarget's mining)", ("sort", "radix", "scan")),
    ("element-wise, reductions, copies",
     ("elementwise", "reduce", "vectorized", "copy", "fill", "cat", "index",
      "gather", "scatter", "memcpy", "memset")),
)


def _ssd_layers(cls, batch, size):
    """(the layer, its NCHW input shape) of every ``cls`` layer of SSD300
    at (batch, 3, size, size), in forward order, from a forward on the
    meta device."""
    from mxnet_tpu_torch.gluon.model_zoo.ssd import SSD300

    net = SSD300(SSD_CLASSES, device="meta")
    seen = []
    for m in net.modules():
        if isinstance(m, cls):
            m.register_forward_hook(
                lambda mod, args, _out: seen.append((mod,
                                                     tuple(args[0].shape))))
    net(torch.empty(batch, 3, size, size, device="meta"))
    return seen


def ssd_convs(batch=SSD_BATCH, size=SSD_SIZE):
    """(NHWC x shape, kernel, stride, pad, O, dilation) of every
    convolution of SSD300 at (batch, 3, size, size), in forward order."""
    from mxnet_tpu_torch.gluon.nn import Conv2D

    return [((n, h, w, c), kw["kernel"], kw["stride"], kw["pad"],
             kw["num_filter"], kw["dilate"])
            for (n, c, h, w), kw in ((s, m._kwargs)
                                     for m, s in _ssd_layers(Conv2D, batch,
                                                             size))]


def ssd_pools(batch=SSD_BATCH, size=SSD_SIZE):
    """(NHWC x shape, kernel, stride, pad, NHWC dy shape) of SSD300's five
    max pools (pool3 in ceil mode: its last window reaches past x)."""
    from mxnet_tpu_torch.gluon.nn import MaxPool2D

    out = []
    for m, (n, c, h, w) in _ssd_layers(MaxPool2D, batch, size):
        kw = m._kwargs
        k, st, p = kw["kernel"], kw["stride"], kw["pad"]
        ceil = kw["pooling_convention"] == "full"
        dy = tuple((x + 2 * pp - kk + (ss - 1 if ceil else 0)) // ss + 1
                   for x, kk, ss, pp in zip((h, w), k, st, p))
        out.append(((n, h, w, c), k, st, p, (n,) + dy + (c,)))
    return out


# phase 3c's float32-accuracy check of K1's 3xTF32 route at three SSD300
# shapes, by NHWC x and O: its error against a float64 dW may be at most
# DW_F64_RATIO times the plain float32 version's (cuBLAS, TF32 off)
SSD_F64_CHECKS = {"conv4_3": ((SSD_BATCH, 38, 38, 512), 512),
                  "conv1_1": ((SSD_BATCH, SSD_SIZE, SSD_SIZE, 3), 64),
                  "conv4_3's loc head": ((SSD_BATCH, 38, 38, 512), 16)}
DW_F64_RATIO = 4.0


def _dw_f64(x, dy, k, s, p, d):
    """dW in float64 by conv_dw_reference's formula: one einsum a tap over
    the padded input's strided, dilated slices."""
    import torch.nn.functional as F

    oh, ow = dy.shape[1], dy.shape[2]
    xp = F.pad(x.double(), (0, 0, p[1], p[1], p[0], p[0]))
    dyd = dy.double()
    out = torch.empty((dy.shape[3],) + tuple(k) + (x.shape[3],),
                      dtype=torch.float64, device=x.device)
    for r in range(k[0]):
        for c in range(k[1]):
            y0, x0 = r * d[0], c * d[1]
            taps = xp[:, y0:y0 + s[0] * (oh - 1) + 1:s[0],
                      x0:x0 + s[1] * (ow - 1) + 1:s[1]]
            out[:, r, c, :] = torch.einsum("nyxi,nyxo->oi", taps, dyd)
    return out


def dw_f64_check(name, got, plain, want):
    """K1's float32 dW ``got`` and the plain version's ``plain`` against
    the float64 ``want``: the kernel's largest error may be at most
    DW_F64_RATIO times the plain version's."""
    e_kernel = (got.double() - want).abs().max().item()
    e_plain = (plain.double() - want).abs().max().item()
    log("kernel conv_dw [SSD300 %s, float32]: largest error against a "
        "float64 dW: kernel %.3g, plain float32 version %.3g (ratio %.2f, "
        "limit %.0f); largest magnitude %.3g" % (
            name, e_kernel, e_plain,
            e_kernel / e_plain if e_plain else float("inf"), DW_F64_RATIO,
            want.abs().max().item()))
    if not e_kernel <= DW_F64_RATIO * e_plain:
        raise AssertionError("K1's float32 dW at SSD300's %s is not float32-"
                             "accurate: %.3g against the plain version's "
                             "%.3g" % (name, e_kernel, e_plain))


def ssd_conv_kernels(seed):
    """Phase 3c at SSD300's shapes, batch 32, float32 (the 3xTF32
    kernel): K1a or K1b (by the formulation rule) at every distinct
    convolution, fc6's dilated one and the heads' odd widths among them,
    within DW_TOL of the plain version's largest magnitude, bitwise equal
    across two launches, beside cuDNN's wgrad, and at SSD_F64_CHECKS no
    farther from a float64 dW than DW_F64_RATIO times the plain version;
    K2 at pool1-pool5, bitwise
    equal to its plain version and across two launches.  Returns the rows
    of K1a, K1b and K2 summed over one SSD300 training step."""
    import torch.nn.functional as F

    from mxnet_tpu_torch.ops import conv_dw as C
    from mxnet_tpu_torch.ops import pool_bwd as P

    gen = torch.Generator(device="cuda").manual_seed(seed + 11)
    counts = {}
    for conv in ssd_convs():
        counts[conv] = counts.get(conv, 0) + 1
    rows = {key: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      library_ms=0.0, bound_by=set(), launches_per_step=0)
            for key in ("pertap", "im2col", "maxpool")}
    for (xs, k, s, p, o, d), per_step in counts.items():
        form = C.formulation(xs[3])
        n, h, w, _ = xs
        dys = (n, _out_size(h, k[0], s[0], p[0], d[0]),
               _out_size(w, k[1], s[1], p[1], d[1]), o)
        x = torch.randn(xs, device="cuda", generator=gen)
        dy = torch.randn(dys, device="cuda", generator=gen)
        run = C.conv_dw_pertap if form == "pertap" else C.conv_dw_im2col

        def fn():
            return run(x, dy, k, s, p, d)

        got, again = fn(), fn()
        torch.cuda.synchronize()
        ref = C.conv_dw_reference(x, dy, k, s, p, d)
        scale = ref.abs().max().item()
        err = (got - ref).abs().max().item()
        same = torch.equal(got, again)
        f64 = next((name for name, (fx, fo) in SSD_F64_CHECKS.items()
                    if (fx, fo) == (xs, o)), None)
        if f64 is not None:
            dw_f64_check(f64, got, ref, _dw_f64(x, dy, k, s, p, d))
        del got, again, ref
        ms = time_ms(fn, iters=5)
        plain_ms = time_ms(lambda: C.conv_dw_reference(x, dy, k, s, p, d),
                           iters=2)
        wt = torch.empty((o,) + k + xs[3:], device="cuda")
        lib_ms = time_ms(lambda: torch.ops.aten.convolution_backward(
            _nchw(dy), _nchw(x), _nchw(wt), None, s, p, d, False, (0, 0), 1,
            (False, True, False)), iters=5)
        bound, bound_by = conv_dw_bound_ms(xs, k, s, p, o, torch.float32, d)
        plan = C.launch_plan(form, k, s, p, xs, o, torch.float32, d)
        flops = 2.0 * dys[0] * dys[1] * dys[2] * o * k[0] * k[1] * xs[3]
        log("kernel conv_dw %s [SSD300 x %s k %s s %s p %s d %s O %d float32, "
            "%d a step]: max_abs_err %.3g of max %.3g (tol %.0e of it), "
            "bitwise repeatable %s; route %s, tile of %d channels, x %s, dy "
            "%s, %d splits of %d; kernel %.4f ms (%.1f TFLOP/s, %.1f %% of "
            "the bound), plain %.4f ms, cuDNN wgrad %.4f ms, bound %.4f ms "
            "(%s)" % (
                form, xs, k, s, p, d, o, per_step, err, scale, DW_TOL, same,
                plan.route, plan.tile_o, plan.x_loads, plan.dy_loads,
                plan.splits, plan.chunk, ms, flops / ms / 1e9,
                100.0 * bound / ms, plain_ms, lib_ms, bound, bound_by))
        if not err <= DW_TOL * scale or not same:
            raise AssertionError("conv_dw %s disagrees with its plain version "
                                 "or between two launches at SSD300's x %s "
                                 "k %s d %s" % (form, xs, k, d))
        row = rows[form]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound), ("library_ms", lib_ms)):
            row[key] += per_step * v
        row["launches_per_step"] += per_step
        row["bound_by"].add(bound_by)
        del x, dy, wt
    torch.cuda.empty_cache()
    # the tensor-core route with dilation (its 16-bit tap offsets): fc6's
    # shape in bf16 and a ragged dilated im2col shape in bf16 and float16,
    # checks only (the SSD300 step runs float32)
    fc6 = next(c for c in counts if c[5] != (1, 1))
    for (xs, k, s, p, o, d), dt in (
            (fc6, torch.bfloat16),
            (((8, 21, 17, 40), (3, 3), (1, 1), (2, 2), 72, (2, 2)),
             torch.bfloat16),
            (((8, 21, 17, 40), (3, 3), (2, 2), (3, 3), 72, (3, 3)),
             torch.float16)):
        form = C.formulation(xs[3])
        dys = (xs[0], _out_size(xs[1], k[0], s[0], p[0], d[0]),
               _out_size(xs[2], k[1], s[1], p[1], d[1]), o)
        x = torch.randn(xs, device="cuda", generator=gen).to(dt)
        dy = torch.randn(dys, device="cuda", generator=gen).to(dt)
        run = C.conv_dw_pertap if form == "pertap" else C.conv_dw_im2col
        got, again = run(x, dy, k, s, p, d), run(x, dy, k, s, p, d)
        ref = C.conv_dw_reference(x, dy, k, s, p, d)
        scale = ref.abs().max().item()
        err = (got.float() - ref.float()).abs().max().item()
        same = torch.equal(got, again)
        plan = C.launch_plan(form, k, s, p, xs, o, dt, d)
        log("kernel conv_dw %s [dilated x %s k %s s %s p %s d %s O %d %s]: "
            "%s kernel, max_abs_err %.3g of max %.3g (tol %.0e of it), "
            "bitwise repeatable %s" % (
                form, xs, k, s, p, d, o, str(dt).split(".")[1], plan.kernel,
                err, scale, DW_TOL, same))
        if not err <= DW_TOL * scale or not same:
            raise AssertionError("conv_dw %s disagrees with its plain version "
                                 "or between two launches at x %s d %s in %s"
                                 % (form, xs, d, dt))
        rows[form]["max_abs_err"] = max(rows[form]["max_abs_err"], err)
        del x, dy, got, again, ref
    torch.cuda.empty_cache()
    for i, (xs, k, s, p, dys) in enumerate(ssd_pools()):
        x = torch.randn(xs, device="cuda", generator=gen)
        dy = torch.randn(dys, device="cuda", generator=gen)

        def fn():
            return P.maxpool_bwd(x, dy, k, s, p)

        got, again = fn(), fn()
        torch.cuda.synchronize()
        ref = P.maxpool_bwd_reference(x, dy, k, s, p)
        equal, same = torch.equal(got, ref), torch.equal(got, again)
        err = (got - ref).abs().max().item()
        del got, again, ref
        ms = time_ms(fn, iters=5)
        plain_ms = time_ms(lambda: P.maxpool_bwd_reference(x, dy, k, s, p),
                           iters=2)
        # the library's backward of the same pool: ceil mode where the
        # window reaches past x (pool3)
        ceil = _out_size(xs[1], k[0], s[0], p[0]) != dys[1]
        _, idx = F.max_pool2d(_nchw(x), k, s, p, ceil_mode=ceil,
                              return_indices=True)
        lib_ms = time_ms(
            lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                _nchw(dy), _nchw(x), k, s, p, (1, 1), ceil, idx), iters=5)
        bound, bound_by = maxpool_bound_ms(xs, dys, torch.float32)
        log("kernel maxpool_bwd [SSD300 pool%d x %s k %s s %s p %s dy %s "
            "float32]: bitwise equal to the plain version %s (max abs err "
            "%.3g), bitwise repeatable %s; kernel %.4f ms (%.1f %% of the "
            "bound), plain %.4f ms, max_pool2d_with_indices_backward %.4f "
            "ms, bound %.4f ms" % (i + 1, xs, k, s, p, dys, equal, err, same,
                                   ms, 100.0 * bound / ms, plain_ms, lib_ms,
                                   bound))
        if not (equal and same):
            raise AssertionError("maxpool_bwd differs from its plain version "
                                 "or between two launches at SSD300's pool%d"
                                 % (i + 1))
        row = rows["maxpool"]
        for key, v in (("ms", ms), ("plain_ms", plain_ms),
                       ("bound_ms", bound), ("library_ms", lib_ms)):
            row[key] += v
        row["launches_per_step"] += 1
        row["bound_by"].add(bound_by)
        del x, dy, idx
    torch.cuda.empty_cache()
    for key, row in rows.items():
        row["bound_by"] = "+".join(sorted(row.pop("bound_by")))
        log("kernel %s over one SSD300 step (%d launches, float32, each "
            "timed alone): kernel %.3f ms, plain %.3f ms, library %.3f ms, "
            "bound %.3f ms" % (key, row.pop("launches_per_step"), row["ms"],
                               row["plain_ms"], row["library_ms"],
                               row["bound_ms"]))
    return rows


def _nms_rows(gen, b, n, classes=SSD_CLASSES, centres=24, invalid=0.3):
    """Detection rows (B, N, 6) [class, score, x1, y1, x2, y2] on the card:
    boxes around a few centres an image, so that many overlap, and a
    share ``invalid`` of the scores -1, as MultiBoxDetection hands them to
    box_nms."""
    def u(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    centre = torch.gather(u(b, centres, 2) * 0.8 + 0.1, 1, (
        u(b, n) * centres).long().unsqueeze(-1).expand(-1, -1, 2))
    half = u(b, n, 2) * 0.15 + 0.02
    score = torch.where(u(b, n) < invalid, torch.full((b, n), -1.0,
                                                      device="cuda"), u(b, n))
    cls = (u(b, n) * classes).floor()
    return torch.cat([cls.unsqueeze(-1), score.unsqueeze(-1), centre - half,
                      centre + half], dim=-1)


def nms_bound_ms(b, n, n_valid, keep, ids=None):
    """Least time for K7 on these inputs: the boxes (and ids) read once and
    the keep set written once, against the operations that this run's
    keep set ``keep`` needs at the float32 peak: each valid box's area
    once (5), and 13 a pair test (4 max/min, 4 clipped differences, the
    intersection's product, the union's add and subtract, the division,
    the compare).  Greedy NMS needs, in each class of each image (the
    image where ``ids`` is None; a NaN id is a class of its own), with n
    valid rows of which k are kept: a test of each pair of kept rows, or
    a later one could have been removed by an earlier one, and one test
    for each removed row: k(k-1)/2 + (n-k).  No pair of two classes is
    tested."""
    valid = torch.arange(n, device=keep.device) < n_valid.unsqueeze(1)
    image = torch.arange(b, device=keep.device).unsqueeze(1).expand(b, n)
    key = (torch.zeros_like(keep, dtype=torch.float32) if ids is None
           else torch.where(ids == 0, torch.zeros_like(ids), ids))  # -0.0
    sel = valid & (key == key)
    _, inverse, count = torch.unique(torch.stack(
        [image[sel].double(), key[sel].double()], 1), dim=0,
        return_inverse=True, return_counts=True)
    count = count.double()
    kept = torch.zeros_like(count).index_add_(0, inverse, keep[sel].double())
    tests = float((kept * (kept - 1) / 2 + count - kept).sum())
    ops = 13.0 * tests + 5.0 * float(valid.sum())
    nbytes = b * n * (16 + (4 if ids is not None else 0) + 1) + 4 * b
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _kernel_ms(fn, keys, calls=5):
    """Device ms a launch of the kernel whose name holds each of ``keys``,
    from one torch.profiler session of ``calls`` calls of ``fn`` after a
    warm-up one (averaged over the launches the trace kept: it can lose
    its first events), and the device kernels a call in the trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = {}
    for key in keys:
        spans = [e.time_range.end - e.time_range.start for e in events
                 if key in e.name]
        ms[key] = sum(spans) / max(1, len(spans)) / 1e3
    return ms, len(events) / calls


# K7's cases besides MultiBoxDetection's shape: (name, images, rows,
# box_nms keywords, classes, share of invalid scores, how the rows are
# changed); each against the plain version on the card, and box_nms on the
# card against box_nms on the CPU at (2, 500).  The class-aware case of
# 24,564 rows (SSD512's anchors) takes the layouts past MultiBoxDetection's
# shape: the sort's buffers in the scratch (past 12,416 rows) and a class
# of about 13,900 rows walked by a block with its boxes read from the
# scratch (past 11,498 rows).  The last three lie past the 393,216 rows an
# image that the mask design took, with about 3,000 valid rows an image
# (the plain loop's length): the removed bits of the one segment in 50 KB
# of shared memory, then in the scratch (2,000,000 rows), and by class,
# each of the 66 walk blocks of an image with removed bits of its own in
# the scratch, the 80 % class (about 2,400 rows) a block's.
NMS_EDGE_CASES = [
    ("all ties", 8, 2000, dict(id_index=0), SSD_CLASSES, 0.3, "ties"),
    ("all suppressed", 8, 2000, dict(force_suppress=True, id_index=0),
     SSD_CLASSES, 0.3, "same box"),
    ("topk 400", 8, 2000, dict(id_index=0, topk=400), SSD_CLASSES, 0.3,
     None),
    ("force_suppress", 8, 2000, dict(id_index=0, force_suppress=True),
     SSD_CLASSES, 0.3, None),
    ("id_index -1", 8, 2000, dict(id_index=-1), SSD_CLASSES, 0.3, None),
    ("force_suppress full", SSD_BATCH, SSD_ANCHORS,
     dict(id_index=0, force_suppress=True), SSD_CLASSES, 0.3, None),
    ("skewed 80 %", SSD_BATCH, SSD_ANCHORS, dict(id_index=0), SSD_CLASSES,
     0.3, "skew"),
    ("80 classes", SSD_BATCH, SSD_ANCHORS, dict(id_index=0), 80, 0.3, None),
    ("NaN and signed-zero ids", 8, 2000, dict(id_index=0), SSD_CLASSES, 0.3,
     "nan ids"),
    ("24,564 rows, 80 %", 2, 24564, dict(id_index=0), SSD_CLASSES, 0.3,
     "skew"),
    ("400,000 rows", 2, 400000, dict(id_index=0, force_suppress=True),
     SSD_CLASSES, 1 - 3000 / 400000, None),
    ("2,000,000 rows", 2, 2000000, dict(id_index=0, force_suppress=True),
     SSD_CLASSES, 1 - 3000 / 2000000, None),
    ("2,000,000 rows, 80 %", 2, 2000000, dict(id_index=0), SSD_CLASSES,
     1 - 3000 / 2000000, "skew"),
]


def nms_kernels(seed):
    """Phase 3e, K7: box_nms's keep set at MultiBoxDetection's shape (32,
    8732) and at the other cases, each bitwise equal to the plain version
    on the card and across two launches, with its route, launch shapes,
    scratch bytes, time (and the scan's -- class keys, sort, segments --
    and the walk's device time, from a profiler trace), the plain
    version's and the bound (no library computes greedy NMS with the JAX
    package's rule: no library row).
    Returns the main shape's row."""
    from mxnet_tpu_torch.ops import box_nms as K
    from mxnet_tpu_torch.ops import contrib as Cb

    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    row = None
    cases = [("detect", SSD_BATCH, SSD_ANCHORS, dict(id_index=0),
              SSD_CLASSES, 0.3, None)] + NMS_EDGE_CASES
    for name, b, n, kw, classes, invalid, change in cases:
        data = _nms_rows(gen, b, n, classes=classes, invalid=invalid)
        if change == "ties":
            data[:, :, 1] = 0.5
        elif change == "same box":
            data[:, :, 2:] = data[:, :1, 2:]
        elif change == "skew":
            one = torch.rand((b, n), device="cuda", generator=gen) < 0.8
            data[:, :, 0] = torch.where(one, torch.zeros_like(data[:, :, 0]),
                                        data[:, :, 0])
        elif change == "nan ids":
            u = torch.rand((b, n), device="cuda", generator=gen)
            cls = data[:, :, 0]
            data[:, :, 0] = torch.where(
                u < 0.1, torch.full_like(cls, float("nan")),
                torch.where((cls == 0) & (u < 0.55), -torch.zeros_like(cls),
                            cls))
        _, boxes, n_valid, ids = Cb.nms_inputs(data, **kw)
        topk = kw.get("topk", -1)
        plan = K.launch_plan(b, n, topk, ids is not None,
                             K._sm_count(boxes.device.index))

        def fn():
            return K.nms_keep(boxes, n_valid, SSD_NMS, ids, topk)

        got, again = fn(), fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = K.nms_keep_plain(boxes, n_valid, SSD_NMS, ids)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        equal = torch.equal(got, ref)
        same = torch.equal(got, again)
        kept = got.sum(1).tolist()
        ms = time_ms(fn, iters=10)
        # the scan (class keys, sort, segments) and the walk apart
        part_ms, per_call = _kernel_ms(fn, ("nms_scan_kernel",
                                            "nms_walk_kernel"))
        bound, bound_by = nms_bound_ms(b, n, n_valid, ref, ids)
        cpu_equal = True
        if name != "detect":
            part = data[:2, :500].contiguous()
            cpu_equal = torch.allclose(  # equal, NaN ids in equal places
                Cb.box_nms(part, SSD_NMS, **kw).cpu(),
                Cb.box_nms(part.cpu(), SSD_NMS, **kw), rtol=0, atol=0,
                equal_nan=True)
        log("kernel box_nms [%s, (%d, %d) rows, %s]: keep set bitwise equal "
            "to the plain version %s, bitwise repeatable %s, box_nms on the "
            "card equal to the CPU's at (2, 500) %s; valid rows %d-%d, kept "
            "%d-%d an image; %s route: scan %d bytes of shared memory (sort "
            "%s), walk grid %s of %d threads, %d bytes of shared memory "
            "(removed bits %s, boxes %s); scratch %d bytes (the mask design: "
            "a %d-byte mask); kernel %.4f ms (%.2f %% of the bound): scan "
            "%.4f, walk %.4f ms of device time (torch.profiler, %.1f device "
            "kernels a call); plain (one call) %.1f ms, bound %.4f ms (%s)"
            % (
                name, b, n, kw, equal, same, cpu_equal,
                int(n_valid.min()), int(n_valid.max()), min(kept), max(kept),
                plan.route, plan.scan_smem,
                "in it" if plan.sort_in_smem else "in the scratch",
                plan.grid, plan.threads, plan.walk_smem,
                "in it" if plan.removed_in_smem else "in the scratch",
                "in it" if plan.boxes_in_smem else "not",
                plan.scratch_bytes,
                b * plan.limit * -(-plan.limit // 64) * 8, ms,
                100.0 * bound / ms, part_ms["nms_scan_kernel"],
                part_ms["nms_walk_kernel"], per_call, plain_ms, bound,
                bound_by))
        if not (equal and same and cpu_equal):
            raise AssertionError("box_nms's K7 disagrees with its plain "
                                 "version at %s" % name)
        if change == "same box" and max(kept) != 1:
            raise AssertionError("box_nms kept more than one of identical "
                                 "boxes")
        if name == "detect":
            row = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound, "bound_by": bound_by,
                   "library_ms": None}
        del data, boxes, n_valid, ids, got, again, ref
    torch.cuda.empty_cache()
    return row


def _ssd_counters():
    from mxnet_tpu_torch.ops import box_nms as K
    from mxnet_tpu_torch.ops import conv_dw as C
    from mxnet_tpu_torch.ops import pool_bwd as P

    return {"pertap": C.conv_dw_pertap, "im2col": C.conv_dw_im2col,
            "maxpool": P.maxpool_bwd, "box_nms": K.nms_keep}


def _ssd_record(net, data, label):
    """The example's train() step up to the loss: the forward, the targets
    (hard-negative mining at 3), the class loss and 5 times the L1 loss
    of the masked offsets.  Returns (the loss, the class loss, the box
    loss)."""
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import ssd as S
    from mxnet_tpu_torch.ops import contrib as Cb

    with autograd.record():
        anchor, cls_pred, loc_pred = net(data)
        loc_t, loc_m, cls_t = Cb.multibox_target(
            anchor, label, cls_pred.transpose(1, 2),
            negative_mining_ratio=3.0)
        lc = S.cls_loss(cls_pred, cls_t)
        ll = gluon.loss.L1Loss()(loc_pred * loc_m, loc_t * loc_m)
        loss = lc + SSD_LOC_WEIGHT * ll
    return loss, lc, ll


def ssd_card_vs_cpu(seed):
    """SSD300 at its published widths, batch 2: the outputs and every
    parameter gradient of one step on the card against the same weights
    on the CPU plain path (the targets of the CPU's outputs on both).
    Each output within GRAD_TOL of its largest magnitude.  The gradients
    at initialisation hinge on ReLU masks and max-pool windows that
    rounding alone flips: the CPU against itself under a relative input
    change of 1e-7 moves an element by up to 1.4e-3 of the largest
    gradient, and one draw's L2 change varies 700-fold over draws and
    seeds (PERF.md).  So the gradients are gated as phase 6's train mode
    is: their L2 distance from the CPU's within TRAIN_NOISE_RATIO times
    the CPU's own L2 change under a relative input change of
    SSD_INPUT_NOISE, the largest of SSD_NOISE_DRAWS draws; the worst
    element and each leaf's worst are logged."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.convert import load_mxnet_tpu_params
    from mxnet_tpu_torch.gluon.model_zoo import ssd as S
    from mxnet_tpu_torch.ops import contrib as Cb

    images, labels = S.synthetic_scenes(np.random.RandomState(seed + 7), 2,
                                        SSD_SIZE, SSD_CLASSES, max_objs=3)
    data = S.normalize(torch.from_numpy(images))
    draws = np.random.RandomState(seed + 8)
    t0 = time.perf_counter()
    cpu = S.SSD300(SSD_CLASSES, device="cpu")
    cpu.initialize(mx.init.Xavier(), seed=seed)
    targets = []

    def run(net, x):
        dev = next(net.parameters()).device
        with autograd.record():
            anchor, cls_pred, loc_pred = net(x.to(dev))
            if not targets:
                targets.extend(Cb.multibox_target(
                    anchor, torch.from_numpy(labels),
                    cls_pred.transpose(1, 2), negative_mining_ratio=3.0))
            loc_t, loc_m, cls_t = (t.to(dev) for t in targets)
            loss = S.cls_loss(cls_pred, cls_t) + SSD_LOC_WEIGHT * \
                gluon.loss.L1Loss()(loc_pred * loc_m, loc_t * loc_m)
        autograd.backward(loss)
        outs = dict(zip(("anchor", "cls_pred", "loc_pred", "loss"),
                        (t.detach().cpu() for t in (anchor, cls_pred,
                                                    loc_pred, loss))))
        grads = {k: p.grad.detach().to("cpu", copy=True)
                 for k, p in net.collect_params().items()}
        return outs, grads

    want, want_g = run(cpu, data)  # the first input materializes the widths
    card = load_mxnet_tpu_params(S.SSD300(SSD_CLASSES), {
        k: v.detach().numpy() for k, v in cpu.state_dict().items()})
    top = max(g.abs().max().item() for g in want_g.values())

    def per_leaf(got):
        return sorted((((got[k] - w).abs().max().item()
                        / max(w.abs().max().item(), GRAD_FLOOR * top)), k)
                      for k, w in want_g.items())[::-1]

    outs, grads = run(card, data)
    out_err = {k: (outs[k] - w).abs().max().item()
               / max(w.abs().max().item(), 1e-30) for k, w in want.items()}
    grad_err = max((grads[k] - w).abs().max().item()
                   for k, w in want_g.items()) / top
    l2 = _l2_rel(grads, want_g)
    floors, noisy = [], None
    for _ in range(SSD_NOISE_DRAWS):
        noise = torch.from_numpy(draws.uniform(-1, 1, data.shape).astype(
            np.float32))
        g = run(cpu, data * (1 + SSD_INPUT_NOISE * noise))[1]
        floors.append(_l2_rel(g, want_g))
        if floors[-1] == max(floors):
            noisy = g
    floor = max(floors)
    log("ssd: SSD300 (published widths, batch 2, float32) on the card "
        "against the CPU plain path: outputs %s of each largest magnitude "
        "(tol %.0e); %d parameter gradients: the worst element %.3g of the "
        "largest gradient (%.3g), L2 over all %.3g against the "
        "CPU's own under %d draws of a %.0e input change %s (ratio to the "
        "largest %.2f, limit %.1f); each leaf's worst of its own largest "
        "magnitude: the card %s, the CPU under the largest draw %s; the "
        "largest logit %.1f; %.1f s" % (
            ", ".join("%s %.3g" % kv for kv in out_err.items()), GRAD_TOL,
            len(want_g), grad_err, top, l2, SSD_NOISE_DRAWS,
            SSD_INPUT_NOISE, ", ".join("%.3g" % f for f in floors),
            l2 / floor, TRAIN_NOISE_RATIO,
            ", ".join("%.3g (%s)" % e for e in per_leaf(grads)[:3]),
            ", ".join("%.3g (%s)" % e for e in per_leaf(noisy)[:3]),
            want["cls_pred"].abs().max().item(), time.perf_counter() - t0))
    if not max(out_err.values()) <= GRAD_TOL:
        raise AssertionError("ssd: the card's outputs disagree with the CPU "
                             "plain path")
    if not l2 <= TRAIN_NOISE_RATIO * floor:
        raise AssertionError("ssd: the card's gradients are farther from the "
                             "CPU's than rounding noise explains")
    del cpu, card
    torch.cuda.empty_cache()


def _detection_accuracy(det, labels):
    """The example's evaluate(): the share of single-box scenes whose best
    detection has the box's class at an IoU of at least 0.5."""
    hits = 0
    for rows, gt in zip(det, labels[:, 0]):
        rows = rows[rows[:, 0] >= 0]
        if not len(rows):
            continue
        best = rows[rows[:, 1].argmax()]
        ix1, iy1 = max(best[2], gt[1]), max(best[3], gt[2])
        ix2, iy2 = min(best[4], gt[3]), min(best[5], gt[4])
        inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
        a1 = (best[4] - best[2]) * (best[5] - best[3])
        a2 = (gt[3] - gt[1]) * (gt[4] - gt[2])
        iou = inter / max(a1 + a2 - inter, 1e-9)
        hits += int(best[0]) == int(gt[0]) and iou >= 0.5
    return hits / len(labels)


def ssd(seed, smi):
    """Phase 11: SSD300-VGG16 trained by the JAX example's loop at its
    published widths, then its detections.  Returns the wrappers' launch
    counts over the training path and over the detection."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, gluon
    from mxnet_tpu_torch.gluon.model_zoo import ssd as S
    from mxnet_tpu_torch.ops import contrib as Cb

    ssd_card_vs_cpu(seed)
    card = torch.device("cuda", 0)
    np.random.seed(seed)  # NDArrayIter's shuffle
    t0 = time.perf_counter()
    images, labels = S.synthetic_scenes(np.random.RandomState(seed),
                                        SSD_SCENES, SSD_SIZE, SSD_CLASSES,
                                        max_objs=3)
    val_images, val_labels = S.synthetic_scenes(
        np.random.RandomState(seed + 99), SSD_VAL, SSD_SIZE, SSD_CLASSES)
    it = mx.io.NDArrayIter(images, labels, batch_size=SSD_BATCH,
                           shuffle=True, last_batch_handle="discard",
                           label_name="label")
    log("ssd: %d training scenes (1-3 boxes of %d classes) and %d held-out "
        "ones (one box) of %d x %d in %.1f s, batches of %d through "
        "mx.io.NDArrayIter" % (SSD_SCENES, SSD_CLASSES, SSD_VAL, SSD_SIZE,
                               SSD_SIZE, time.perf_counter() - t0,
                               SSD_BATCH))

    def batches():
        while True:
            it.reset()
            for b in it:
                yield (S.normalize(b.data[0].data_torch.to(card)),
                       b.label[0].data_torch.to(card))

    net = S.SSD300(SSD_CLASSES, device=card)
    net.initialize(mx.init.Xavier(), seed=seed)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": SSD_LR})
    feed = batches()

    def step():
        data, label = next(feed)
        loss, lc, ll = _ssd_record(net, data, label)
        autograd.backward(loss)
        trainer.step(SSD_BATCH)
        return lc.detach(), ll.detach().mean()

    counters = _ssd_counters()
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(SSD_STEPS + 1)]
    losses = []
    t0 = time.perf_counter()
    events[0].record()
    for i in range(SSD_STEPS):
        losses.append(step())
        events[i + 1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    # ---- end of the training path
    step_ms = np.array([a.elapsed_time(b) for a, b in zip(events,
                                                          events[1:])])
    cls_l = np.array([float(a) for a, _ in losses])
    loc_l = np.array([float(b) for _, b in losses])
    total = cls_l + SSD_LOC_WEIGHT * loc_l
    first, last = total[:SSD_WINDOW].mean(), total[-SSD_WINDOW:].mean()
    steady = float(np.median(step_ms[5:]))
    log("ssd: %d Adam steps (lr %g) of SSD300 at (%d, 3, %d, %d) on %s in "
        "%.1f s wall: step %.2f ms (median after 5; CUDA events), %.1f "
        "images/s; loss (class + %g x box) of the first %d batches %.4f "
        "(class %.4f, box %.4f), of the last %d %.4f (class %.4f, box "
        "%.4f); peak memory %.2f GB" % (
            SSD_STEPS, SSD_LR, SSD_BATCH, SSD_SIZE, SSD_SIZE, smi, wall,
            steady, SSD_BATCH / steady * 1e3, SSD_LOC_WEIGHT, SSD_WINDOW,
            first, cls_l[:SSD_WINDOW].mean(), loc_l[:SSD_WINDOW].mean(),
            SSD_WINDOW, last, cls_l[-SSD_WINDOW:].mean(),
            loc_l[-SSD_WINDOW:].mean(), peak / 1e9))
    log("ssd: loss by window of 25 steps: %s" % ", ".join(
        "%.3f" % total[i:i + 25].mean() for i in range(0, len(total), 25)))
    want = {"pertap": SSD_K1A * SSD_STEPS, "im2col": SSD_K1B * SSD_STEPS,
            "maxpool": SSD_K2 * SSD_STEPS, "box_nms": 0}
    log("ssd: wrapper launches over the training path: %s (expected %s)"
        % (launched, want))
    if not np.all(np.isfinite(total)) or not last < first:
        raise AssertionError("ssd: the loss is not finite or did not fall")
    if launched != want:
        raise AssertionError("ssd: the training path did not launch K1a, "
                             "K1b and K2 once a convolution and pool a step")
    profile_steps(step, smi, steady, steps=3, groups=SSD_GROUPS, tag="ssd",
                  count=())
    # evaluate(): the held-out scenes through MultiBoxDetection
    data = S.normalize(torch.from_numpy(val_images).to(card))

    def detect():
        anchor, cls_pred, loc_pred = net(data)
        probs = torch.softmax(cls_pred, dim=-1).transpose(1, 2)
        return Cb.multibox_detection(probs, loc_pred, anchor,
                                     nms_threshold=SSD_NMS)

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    det = detect()
    torch.cuda.synchronize()
    det_ms = (time.perf_counter() - t0) * 1e3
    det_peak = torch.cuda.max_memory_allocated()
    detected = {k: fn.launches for k, fn in counters.items()}
    # ---- end of the detection path
    det = det.cpu().numpy()
    acc = _detection_accuracy(det, val_labels)
    det_time = time_ms(detect, iters=5)
    log("ssd: MultiBoxDetection (nms %.2f) on the %d held-out scenes: %d "
        "rows of %d anchors kept, top-1 class at IoU >= 0.5 accuracy %.3f; "
        "the first call %.2f ms (host clock), a call %.3f ms (CUDA events, "
        "the forward included); peak memory %.3f GB, %.1f MB above the "
        "%.3f GB held before the call; wrapper launches %s" % (
            SSD_NMS, SSD_VAL, int((det[..., 0] >= 0).sum()), SSD_ANCHORS,
            acc, det_ms, det_time, det_peak / 1e9, (det_peak - base) / 1e6,
            base / 1e9, detected))
    if det.shape != (SSD_VAL, SSD_ANCHORS, 6) or not np.isfinite(det).all():
        raise AssertionError("ssd: the detections are not finite rows of "
                             "the expected shape")
    if detected != {"pertap": 0, "im2col": 0, "maxpool": 0, "box_nms": 1}:
        raise AssertionError("ssd: the detection did not launch K7 once")
    del net, trainer
    torch.cuda.empty_cache()
    return launched, detected


# ---------------------------------------------------------------- module family

# phase 12: the SequentialModule's trajectory against the single Module
# (batches), its accuracy floor, and the Monitor's interval
MF_BATCHES, MF_TOL, MF_MONITOR = 20, 1e-5, 100
# the reshaped Module's outputs against a fresh bind, within this share
# of their largest magnitude
MF_RESHAPE_TOL = 1e-6


def _lenet_split():
    """train_mnist.py's LeNet cut at its Flatten: the trunk (the
    convolutions and pools) and the head, named as _mnist_net's."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.name import NameManager

    sym = mx.sym
    with NameManager():
        net = sym.Variable("data")
        for i, filters in ((1, 20), (2, 50)):
            net = sym.Convolution(net, kernel=(5, 5), num_filter=filters,
                                  name="conv%d" % i)
            net = sym.Activation(net, act_type="tanh")
            net = sym.Pooling(net, pool_type="max", kernel=(2, 2),
                              stride=(2, 2))
        trunk = net
        net = sym.FullyConnected(sym.Flatten(sym.Variable("data")),
                                 num_hidden=500, name="fc1")
        net = sym.Activation(net, act_type="tanh")
        net = sym.FullyConnected(net, num_hidden=10, name="fc2")
        return trunk, sym.SoftmaxOutput(net, name="softmax")


def _sequential_lenet(device):
    import mxnet_tpu_torch as mx

    trunk, head = _lenet_split()
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(trunk, label_names=[], context=device))
    seq.add(mx.mod.Module(head, context=device), take_labels=True)
    return seq


def _bound_sequential(device, params):
    it = _mnist_iter(True, False)
    seq = _sequential_lenet(device)
    seq.bind(it.provide_data, it.provide_label)
    seq.init_params(arg_params=params[0], aux_params=params[1])
    seq.init_optimizer(optimizer="sgd", optimizer_params=_fit_params())
    return seq


def _train_seq(mod, batches, n, events=None):
    """``n`` batches of forward, a read of the outputs (the metric's),
    backward and update, as a manual loop runs them."""
    for i in range(n):
        b = batches[i % len(batches)]
        if events is not None:
            events[i][0].record()
        mod.forward(b, is_train=True)
        mod.get_outputs()
        mod.backward()
        mod.update()
        if events is not None:
            events[i][1].record()


def _lenet_initial(seed):
    """Phase 8's LeNet start: a seeded Xavier draw on the host."""
    import mxnet_tpu_torch as mx

    mx.random.seed(seed)
    first = mx.mod.Module(_mnist_net("lenet"), context=mx.cpu())
    it = _mnist_iter(True, False)
    first.bind(it.provide_data, it.provide_label)
    first.init_params(mx.init.Xavier(rnd_type="gaussian", factor_type="in",
                                     magnitude=2))
    return tuple({k: v.copy() for k, v in d.items()}
                 for d in first.get_params())


def mf_dropout_once(seed):
    """Phase 12a's first check: a Dropout(0.5) Module read before its
    backward (the split graphs) keeps one mask for its output and its
    input gradient, runs its forward once a batch, and draws a new mask
    each batch."""
    import mxnet_tpu_torch as mx

    card = torch.device("cuda", 0)
    mx.random.seed(seed)
    shape = (SYM_BATCH, 1000)
    mod = mx.mod.Module(mx.sym.Dropout(mx.sym.Variable("data"), p=0.5),
                        label_names=[], context=card)
    mod.bind([("data", shape)], inputs_need_grad=True)
    mod.init_params()
    x = mx.nd.ones(shape, ctx=card)
    masks = []
    for _ in range(3):
        mod.forward(mx.io.DataBatch([x]), is_train=True)
        out = mod.get_outputs()[0].asnumpy()
        mod.backward([mx.nd.ones(shape, ctx=card)])
        grad = mod.get_input_grads()[0].asnumpy()
        masks.append((out != 0, grad != 0))
    ex = mod._exec_group.execs[0]
    same = all(np.array_equal(o, g) for o, g in masks)
    keep = [float(o.mean()) for o, _ in masks]
    log("module family: Dropout(0.5) read before backward on the card, 3 "
        "batches: route %r, forward runs %d, output and input-gradient "
        "masks equal %s, keep shares %s, a new mask each batch %s" % (
            ex.route, ex.forward_runs, same, keep,
            not np.array_equal(masks[0][0], masks[1][0])))
    if ex.route != "split graphs" or ex.forward_runs != 3 or not same or \
            np.array_equal(masks[0][0], masks[1][0]) or \
            any(abs(k - 0.5) > 0.01 for k in keep):
        raise AssertionError("the read-then-backward Dropout did not keep "
                             "one mask a batch")


def mf_sequential(seed, smi):
    """Phase 12a: LeNet as a SequentialModule (trunk, head)."""
    import mxnet_tpu_torch as mx

    mf_dropout_once(seed)

    from mxnet_tpu_torch.ops import conv_dw as C
    from mxnet_tpu_torch.ops import pool_bwd as P

    card = torch.device("cuda", 0)
    counters = {"im2col": C.conv_dw_im2col, "maxpool": P.maxpool_bwd}
    params = _lenet_initial(seed)
    it = _mnist_iter(True, False)
    batches = [next(it) for _ in range(MF_BATCHES)]

    # 1. 20 batches of the SequentialModule against phase 8's single
    # Module from the same parameters on the same batches
    single = _bound_module("lenet", card, params)
    _train_batches(single, batches, MF_BATCHES)
    seq = _bound_sequential(card, params)
    _train_seq(seq, batches, MF_BATCHES)
    want, _ = single.get_params()
    got, _ = seq.get_params()
    errs = {k: float(np.abs(got[k].asnumpy() - w.asnumpy()).max())
            / max(float(np.abs(w.asnumpy()).max()), 1e-30)
            for k, w in want.items()}
    worst = max((e, k) for k, e in errs.items())
    trunk_ex = seq._modules[0]._exec_group.execs[0]
    head_ex = seq._modules[1]._exec_group.execs[0]
    log("module family: LeNet as a SequentialModule (trunk to the pools, "
        "head from the Flatten) vs the single Module after %d batches "
        "(forward, outputs read, backward, update): worst parameter %.3g "
        "of its largest magnitude (%s; tol %.0e); the trunk's route %r, "
        "%d forward runs, the head's route %r, %d forward runs" % (
            MF_BATCHES, worst[0], worst[1], MF_TOL, trunk_ex.route,
            trunk_ex.forward_runs, head_ex.route, head_ex.forward_runs))
    if not worst[0] <= MF_TOL:
        raise AssertionError("the SequentialModule's LeNet left the single "
                             "Module's trajectory")
    if trunk_ex.forward_runs != MF_BATCHES or \
            head_ex.forward_runs != MF_BATCHES:
        raise AssertionError("a module's forward did not run once a batch")
    if trunk_ex.route != "split graphs":
        raise AssertionError("the trunk's read-then-backward did not run "
                             "its split graphs")

    # 2. the captured batch's time, the single Module's and the
    # SequentialModule's in turns, and the sequential batch's host time
    # by call
    steps, warm = 20, 3
    step_ms = {}
    for tag, run, mod in (("single", _train_batches, single),
                          ("sequential", _train_seq, seq),
                          ("sequential again", _train_seq, seq),
                          ("single again", _train_batches, single)):
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(steps)]
        run(mod, batches, steps, ev)
        torch.cuda.synchronize()
        step_ms[tag] = float(np.mean([a.elapsed_time(b)
                                      for a, b in ev[warm:]]))
    log("module family: a captured LeNet batch on %s (CUDA events, mean of "
        "%d after %d, in turns): %s" % (smi, steps - warm, warm, ", ".join(
            "%s %.4f ms" % kv for kv in step_ms.items())))
    parts = {"forward (the trunk's forward graph, the head's copy in)": [],
             "backward (the head's fused graph, the trunk's backward "
             "graph)": [], "update": [], "update_metric": []}
    metric = mx.metric.create("accuracy")
    for i in range(steps):
        b = batches[i % len(batches)]
        t = [time.perf_counter()]
        seq.forward(b, is_train=True)
        t.append(time.perf_counter())
        seq.backward()
        t.append(time.perf_counter())
        seq.update()
        t.append(time.perf_counter())
        seq.update_metric(metric, b.label)
        t.append(time.perf_counter())
        for part, a, z in zip(parts, t, t[1:]):
            parts[part].append((z - a) * 1e3)
    log("module family: a captured sequential batch's host time by call "
        "(median of %d after %d): %s" % (steps - warm, warm, ", ".join(
            "%s %.4f ms" % (k, float(np.median(v[warm:])))
            for k, v in parts.items())))
    del single
    torch.cuda.empty_cache()

    # 3. the main path: SequentialModule.fit with a Monitor
    np.random.seed(seed)  # MNISTIter's shuffle
    train, val = _mnist_iter(True, True), _mnist_iter(False, False)
    main = _sequential_lenet(card)
    mon = mx.mon.Monitor(MF_MONITOR)
    runs, syncs = [], []

    def batch_end(p):
        t_ex = main._modules[0]._exec_group.execs[0]
        h_ex = main._modules[1]._exec_group.execs[0]
        runs.append((t_ex.forward_runs, h_ex.forward_runs))
        syncs.append(mon.syncs)

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    main.fit(train, eval_data=None, eval_metric=["accuracy"], num_epoch=1,
             optimizer="sgd", optimizer_params=_fit_params(),
             kvstore="device", arg_params=params[0], aux_params=params[1],
             batch_end_callback=batch_end, monitor=mon)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    # ---- end of the main path
    acc = dict(main.score(val, "accuracy"))["accuracy"]
    nb = len(runs)
    watched = (nb + MF_MONITOR - 1) // MF_MONITOR
    trunk_ex = main._modules[0]._exec_group.execs[0]
    (split,) = trunk_ex.split_graphs.values()
    log("module family: SequentialModule.fit 1 epoch of %d batches on %s in "
        "%.2f s wall; validation accuracy %.4f; forward runs a module after "
        "the last batch %s (one a batch: %d); wrapper counts %s over the "
        "main path (the trunk's eager warm-up + its capture; the trunk's "
        "forward graph %d replays, its backward graphs %d (%d signature)); "
        "the Monitor(%d): %d syncs, after each batch %s" % (
            nb, smi, wall, acc, runs[-1], nb, launches, split.replays,
            split.bwd_replays, len(split.bwd), MF_MONITOR, mon.syncs,
            syncs[:3] + ["..."] + syncs[-2:]))
    if not acc > 0.9:
        raise AssertionError("module family: validation accuracy %.4f is "
                             "not above 0.9" % acc)
    if runs[-1] != (nb, nb):
        raise AssertionError("module family: a module's forward did not run "
                             "once a batch on the main path")
    if launches != {k: 2 * v for k, v in LENET_LAUNCHES.items()}:
        raise AssertionError("module family: the main path did not launch "
                             "K1b and K2 at the trunk's warm-up and capture")
    if mon.syncs != watched or any(
            s != (i // MF_MONITOR + 1) for i, s in enumerate(syncs)):
        raise AssertionError("module family: the Monitor synced on a batch "
                             "it does not watch, or more than once a toc")

    # 4. 3 batches under the profiler: K1b and K2 in the trunk's backward
    # graph, twice each a batch
    traced = 3
    seen = profile_steps(lambda: (main.forward_backward(batches[0]),
                                  main.update()), smi,
                         step_ms["sequential"], steps=traced,
                         groups=SYM_GROUPS, tag="module family sequential",
                         count=LENET_KERNELS)
    if seen is not None:
        want = {k: n * traced for k, _, n in LENET_KERNELS}
        log("module family: launches in the trace of %d sequential "
            "batches %s; expected %s" % (traced, seen, want))
        if seen != want:
            raise AssertionError("the sequential LeNet batch does not "
                                 "launch K1b and K2 twice each")
    del main, seq
    torch.cuda.empty_cache()
    return {k: dict(launches=n, traced_replays=traced,
                    launches_in_traced_replays=None if seen is None
                    else seen[k]) for k, n in launches.items()}


def _numpy_softmax(mx):
    """example/numpy-ops/custom_softmax.py's op, for the port: a softmax
    on the host, its backward p - onehot(label)."""

    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        mx.nd.array(e / e.sum(axis=1, keepdims=True),
                                    ctx=in_data[0].context))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            label = in_data[1].asnumpy().ravel().astype(np.int64)
            p = out_data[0].asnumpy().copy()
            p[np.arange(label.shape[0]), label] -= 1.0
            self.assign(in_grad[0], req[0],
                        mx.nd.array(p, ctx=in_data[0].context))

    @mx.operator.register("numpy_softmax")
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()

    return NumpySoftmaxProp


def _custom_mlp(custom):
    """custom_softmax.py's build_mlp (or the same MLP with SoftmaxOutput)."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.name import NameManager

    sym = mx.sym
    with NameManager():
        h = sym.Flatten(sym.Variable("data"))
        h = sym.Activation(sym.FullyConnected(h, num_hidden=128,
                                              name="fc1"), act_type="relu")
        h = sym.Activation(sym.FullyConnected(h, num_hidden=64,
                                              name="fc2"), act_type="relu")
        h = sym.FullyConnected(h, num_hidden=10, name="fc3")
        if custom:
            return sym.Custom(data=h, name="softmax",
                              op_type="numpy_softmax")
        return sym.SoftmaxOutput(h, name="softmax")


def mf_custom(seed, smi):
    """Phase 12b: custom_softmax.py's MLP through Module.fit."""
    import mxnet_tpu_torch as mx

    card = torch.device("cuda", 0)
    _numpy_softmax(mx)
    opt = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5}
    mx.random.seed(seed)
    np.random.seed(seed)
    train, val = _mnist_iter(True, True), _mnist_iter(False, False)
    mod = mx.mod.Module(_custom_mlp(True), context=card)
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, optimizer="sgd", optimizer_params=opt,
            num_epoch=1, initializer=mx.init.Xavier())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = dict(mod.score(val, "accuracy"))["accuracy"]
    ex = mod._exec_group.execs[0]
    # a batch's time beside the same MLP with SoftmaxOutput (captured)
    ref = mx.mod.Module(_custom_mlp(False), context=card)
    ref.bind(train.provide_data, train.provide_label)
    ref.init_params(arg_params=mod.get_params()[0])
    ref.init_optimizer(optimizer="sgd", optimizer_params=opt)
    train.reset()
    batches = [next(train) for _ in range(5)]
    host_ms = {}
    for tag, m in (("Custom (eager)", mod), ("SoftmaxOutput (captured)", ref),
                   ("Custom again", mod), ("SoftmaxOutput again", ref)):
        _train_batches(m, batches, 3)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _train_batches(m, batches, 20)
        torch.cuda.synchronize()
        host_ms[tag] = (time.perf_counter() - t) / 20 * 1e3
    ref_ex = ref._exec_group.execs[0]
    log("module family: custom_softmax.py's MLP (NumpySoftmax on the host, "
        "need_top_grad False) through Module.fit 1 epoch on %s in %.2f s: "
        "validation accuracy %.4f; its executor captures %s, route %r; a "
        "batch's forward_backward + update, host clock to a sync (mean of "
        "20 after 3, in turns): %s; the SoftmaxOutput MLP's route %r" % (
            smi, wall, acc, ex.capture, ex.route, ", ".join(
                "%s %.4f ms" % kv for kv in host_ms.items()), ref_ex.route))
    if not acc > 0.9:
        raise AssertionError("the Custom-op MLP's accuracy %.4f is not above "
                             "0.9" % acc)
    if ex.capture or ex.route != "eager, fused" or \
            ref_ex.route != "fused graph":
        raise AssertionError("the Custom-op graph was captured, or the "
                             "SoftmaxOutput one was not")


def mf_reshape(seed, smi):
    """Phase 12c: Module.reshape of a trained MLP to 1 and 100 samples,
    and back to 64."""
    import mxnet_tpu_torch as mx

    card = torch.device("cuda", 0)
    mx.random.seed(seed)
    train, val = _mnist_iter(True, False), _mnist_iter(False, False)
    mod = mx.mod.Module(_mnist_net("mlp"), context=card)
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=_fit_params())
    batches = [next(train) for _ in range(10)]
    _train_batches(mod, batches, 10)
    first = mod._exec_group.execs[0]
    (graph,) = first.graphs.values()
    trained = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    data = val.next().data[0].asnumpy()
    worst, kept = 0.0, True
    for n in (1, 100):
        x = np.concatenate([data] * 2)[:n]
        mod.reshape([("data", (n, 1, 28, 28))], [("softmax_label", (n,))])
        mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=card)]),
                    is_train=False)
        got = mod.get_outputs()[0].asnumpy()
        fresh = mx.mod.Module(_mnist_net("mlp"), context=card)
        fresh.bind([("data", (n, 1, 28, 28))], for_training=False)
        fresh.set_params(*mod.get_params())
        fresh.forward(mx.io.DataBatch([mx.nd.array(x, ctx=card)]),
                      is_train=False)
        want = fresh.get_outputs()[0].asnumpy()
        worst = max(worst, float(np.abs(got - want).max())
                    / float(np.abs(want).max()))
        kept &= all(np.array_equal(v.asnumpy(), trained[k])
                    for k, v in mod.get_params()[0].items())
    replays = graph.replays
    mod.reshape([("data", (SYM_BATCH, 1, 28, 28))],
                [("softmax_label", (SYM_BATCH,))])
    _train_batches(mod, batches, 5)
    torch.cuda.synchronize()
    back = mod._exec_group.execs[0]
    log("module family: Module.reshape of the trained MLP to 1 and 100 "
        "samples on %s: outputs vs a fresh bind from get_params() worst %.3g "
        "of the largest (tol %.0e), trained weights kept %s; back at %d: "
        "the first executor %s, its graph replayed %d more times, %d graph "
        "in all" % (smi, worst, MF_RESHAPE_TOL, kept, SYM_BATCH,
                    "taken back" if back is first else "NOT taken back",
                    graph.replays - replays, len(back.graphs)))
    if not worst <= MF_RESHAPE_TOL or not kept:
        raise AssertionError("the reshaped Module disagrees with a fresh "
                             "bind, or lost its trained weights")
    if back is not first or graph.replays - replays != 5 or \
            len(back.graphs) != 1:
        raise AssertionError("the first shape's graph was not replayed")


def mf_feedforward(seed, smi):
    """Phase 12d: model.FeedForward on numpy arrays."""
    import shutil
    import tempfile
    import warnings

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.io.io import _synthetic_mnist

    card = torch.device("cuda", 0)
    imgs, labels = _synthetic_mnist(6000, seed=0)
    x = imgs.astype(np.float32).reshape(-1, 1, 28, 28) / 255.0
    y = labels.astype(np.float32)
    vimgs, vlabels = _synthetic_mnist(1000, seed=1)
    vx = vimgs.astype(np.float32).reshape(-1, 1, 28, 28) / 255.0
    vy = vlabels.astype(np.float32)
    mx.random.seed(seed)
    np.random.seed(seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ff_")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            t0 = time.perf_counter()
            model = mx.model.FeedForward(
                _mnist_net("mlp"), ctx=card, num_epoch=2,
                numpy_batch_size=SYM_BATCH, learning_rate=0.05,
                momentum=0.9, wd=1e-4, initializer=mx.init.Xavier())
            model.fit(x, y)
            pred = model.predict(vx)
            acc = model.score(mx.io.NDArrayIter(vx, vy,
                                                batch_size=SYM_BATCH))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            model.save(tmp + "/ff")
            again = mx.model.FeedForward.load(tmp + "/ff", 2, ctx=card,
                                              numpy_batch_size=SYM_BATCH)
            pred2 = again.predict(vx)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    top1 = float((pred.argmax(1) == vy).mean())
    log("module family: FeedForward(mlp).fit 2 epochs on numpy arrays on %s "
        "in %.2f s (predict and score included): predict %s, finite %s, "
        "top-1 %.4f, score %.4f; save/load round trip predicts bitwise "
        "equal %s" % (smi, wall, pred.shape, bool(np.isfinite(pred).all()),
                      top1, acc, np.array_equal(pred, pred2)))
    if pred.shape != (1000, 10) or not np.isfinite(pred).all() or \
            not acc > 0.9 or abs(top1 - acc) > 1e-9 or \
            not np.array_equal(pred, pred2):
        raise AssertionError("FeedForward: wrong predictions, accuracy or "
                             "round trip")


def module_family(seed, smi):
    """Phase 12: the Module family (SequentialModule with a Monitor, a
    Custom op, reshape, FeedForward).  Returns the SequentialModule's
    launch counts."""
    launches = mf_sequential(seed, smi)
    mf_custom(seed, smi)
    mf_reshape(seed, smi)
    mf_feedforward(seed, smi)
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t0 = time.perf_counter()

    def phase(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        log("phase %s done in %.1f s (%.1f s in all)" % (
            name, time.perf_counter() - t, time.perf_counter() - t0))
        return out

    smi = environment()
    phase("build", build)
    fwd_rows = phase("3 attention forward", kernels, args.seed)
    bwd_rows = phase("3b attention backward", backward_kernels, args.seed)
    dw_rows, dw_lenet, dw_convlstm = phase("3c conv dW", conv_kernels,
                                           args.seed)
    dw_grouped = phase("3c grouped and transposed conv dW",
                       grouped_conv_kernels, args.seed)
    pool_row, pool_lenet = phase("3c max-pool backward", pool_kernels,
                                 args.seed)
    ssd_rows = phase("3c SSD300 conv dW and max-pool backward",
                     ssd_conv_kernels, args.seed)
    bn_rows, bn_rows_v2 = phase("3d batch norm", bn_kernels, args.seed)
    nms_row = phase("3e box_nms", nms_kernels, args.seed)
    serve_row = phase("4 serve", serve, args.seed, smi)
    phase("4b predictor", predictor_serve, args.seed, smi)
    train_launches = phase("5 train", train, args.seed, smi)
    compiled_launches = phase("5b compiled LM train", compiled_train,
                              args.seed, smi)
    resnet_launches = phase("6 resnet", resnet_train, args.seed, smi)
    v2 = phase("6b resnet v2", resnet_v2, args.seed, smi)
    rtc_row, rtc_launches = phase("7 imperative", imperative, args.seed, smi)
    lenet_launches = phase("8 symbolic", symbolic, args.seed, smi)
    phase("9 word LM", word_lm, args.seed, smi)
    convlstm_launches = phase("10 bucketing", bucketing, args.seed, smi)
    ssd_train, ssd_detect = phase("11 SSD300", ssd, args.seed, smi)
    seq_launches = phase("12 module family", module_family, args.seed, smi)
    # one entry per kernel per main path, each with that path's own count;
    # the served buckets are captured graphs, so "launches" is the
    # wrapper's count over the eager warm-up and capture of each bucket,
    # and the kernels the replays ran are counted in a profiler trace of
    # a served burst (as the ResNet entries below)
    k3 = dict(name="flash_attn_fwd", route="cuda",
              plan_route=fwd_kernel_plan(UNITS // HEADS,
                                         torch.float32).route,
              source="mxnet_tpu_torch/csrc/flash_attn_fwd.cu",
              replaces="mxnet_tpu/ops/attention.py:63")
    entries = [dict(k3, path="serve",
                    launches_counted_over="eager warm-up + capture of each "
                                          "bucket", **serve_row,
                    **fwd_rows["bucket 8"]),
               dict(k3, path="train", launches=train_launches["fwd"],
                    **fwd_rows["bucket 8"])]
    for kern, line in (("dq", 163), ("dkv", 206)):
        entries.append(dict(name="flash_attn_bwd_" + kern, path="train",
                            route="cuda",
                            source="mxnet_tpu_torch/csrc/flash_attn_bwd.cu",
                            replaces="mxnet_tpu/ops/attention.py:%d" % line,
                            launches=train_launches[kern], **bwd_rows[kern]))
    # the compiled float16 step (phase 5b) is captured: "launches" is the
    # wrappers' count over the main path (its warm-up and capture), and the
    # replays' launches are counted in a profiler trace, as ResNet's below
    for kern, line, row in (("fwd", 63, fwd_rows["f16"]),
                            ("dq", 163, bwd_rows["f16"]["dq"]),
                            ("dkv", 206, bwd_rows["f16"]["dkv"])):
        entries.append(dict(
            name="flash_attn_" + ("fwd" if kern == "fwd" else "bwd_" + kern),
            path="lm_compiled_train", route="cuda", dtype="float16",
            source="mxnet_tpu_torch/csrc/flash_attn_%s.cu"
                   % ("fwd" if kern == "fwd" else "bwd"),
            replaces="mxnet_tpu/ops/attention.py:%d" % line,
            launches_counted_over="eager warm-up step + capture",
            **compiled_launches[kern], **row))
    # the ResNet step is captured: "launches" is the wrappers' count over
    # the main path, which launches in the eager warm-up step and into the
    # graph at capture (2 x a step); the replays launch no wrapper, so the
    # kernels that ran are counted in the profiler's trace of replays
    # ("launches_in_traced_replays" over "traced_replays" replays, null if
    # the trace saw no kernel)
    def resnet_entry(name, key, source, replaces, row):
        return dict(name=name, path="resnet_train", route="cuda",
                    source=source, replaces=replaces,
                    launches_counted_over="eager warm-up step + capture",
                    **resnet_launches[key], **row)

    # conv dW's route on each path: bf16 on 16-bit wgmma (ResNet-50), else
    # float32 by 3xTF32
    for form, line in (("pertap", 111), ("im2col", 133)):
        entries.append(resnet_entry(
            "conv_dw_" + form, form, "mxnet_tpu_torch/csrc/conv_dw.cu",
            "mxnet_tpu/ops/pallas_conv.py:%d" % line,
            dict(dw_rows[form], plan_route="wgmma")))
    entries.append(resnet_entry(
        "maxpool_bwd", "maxpool", "mxnet_tpu_torch/csrc/maxpool_bwd.cu",
        "mxnet_tpu/ops/pallas_pool.py:55", pool_row))
    # no Pallas kernel: the JAX op, which XLA fuses inside the step
    for kern in ("fwd", "bwd"):
        entries.append(resnet_entry(
            "batch_norm_" + kern, "batch_norm_" + kern,
            "mxnet_tpu_torch/csrc/batch_norm.cu", "mxnet_tpu/ops/nn.py:462",
            bn_rows[kern]))
    # ResNet-50 v2 through GluonTrainStep(optimizer=SGD) (phase 6b's main
    # path) and resnet50_v1 with the space-to-depth stem, both captured as
    # the ResNet step: K1 summed over each path's own convolutions, K2 at
    # the same stem pool, K6 over v2's BatchNorms (v1's for the s2d net)
    for path, launches, dw, bn in (
            ("resnet_v2_train", v2["v2_launches"], v2["v2_rows"], bn_rows_v2),
            ("resnet_s2d_train", v2["s2d_launches"], v2["s2d_rows"],
             bn_rows)):
        common = dict(path=path, route="cuda",
                      launches_counted_over="eager warm-up step + capture")
        for form, line in (("pertap", 111), ("im2col", 133)):
            entries.append(dict(
                common, name="conv_dw_" + form,
                source="mxnet_tpu_torch/csrc/conv_dw.cu",
                replaces="mxnet_tpu/ops/pallas_conv.py:%d" % line,
                plan_route="wgmma", **launches[form], **dw[form]))
        entries.append(dict(
            common, name="maxpool_bwd",
            source="mxnet_tpu_torch/csrc/maxpool_bwd.cu",
            replaces="mxnet_tpu/ops/pallas_pool.py:55",
            **launches["maxpool"], **pool_row))
        for kern in ("fwd", "bwd"):
            entries.append(dict(
                common, name="batch_norm_" + kern,
                source="mxnet_tpu_torch/csrc/batch_norm.cu",
                replaces="mxnet_tpu/ops/nn.py:462",
                **launches["batch_norm_" + kern], **bn[kern]))
    # K1 grouped (the ResNeXt-style and depthwise convolutions) and with the
    # roles swapped (the transposed convolution), bf16, eager
    for form, line, what in (
            ("im2col", 133, "grouped and depthwise"),
            ("pertap", 111, "transposed convolution (roles swapped)")):
        entries.append(dict(
            name="conv_dw_" + form, path="grouped_conv", route="cuda",
            source="mxnet_tpu_torch/csrc/conv_dw.cu",
            replaces="mxnet_tpu/ops/pallas_conv.py:%d" % line,
            plan_route="wgmma", what=what, **dw_grouped[form]))
    # the symbolic LeNet: captured as the ResNet step, float32
    for key, name, line, row in (
            ("im2col", "conv_dw_im2col", "mxnet_tpu/ops/pallas_conv.py:133",
             dict(dw_lenet, plan_route="tf32x3")),
            ("maxpool", "maxpool_bwd", "mxnet_tpu/ops/pallas_pool.py:55",
             pool_lenet)):
        entries.append(dict(
            name=name, path="symbolic_lenet", route="cuda",
            source="mxnet_tpu_torch/csrc/%s.cu" % (
                "conv_dw" if key == "im2col" else "maxpool_bwd"),
            replaces=line,
            launches_counted_over="eager warm-up batch + capture",
            **lenet_launches[key], **row))
    # the LeNet trunk of phase 12's SequentialModule: its read-then-
    # backward route, split into a captured forward and backward graph
    for key, name, line, row in (
            ("im2col", "conv_dw_im2col", "mxnet_tpu/ops/pallas_conv.py:133",
             dict(dw_lenet, plan_route="tf32x3")),
            ("maxpool", "maxpool_bwd", "mxnet_tpu/ops/pallas_pool.py:55",
             pool_lenet)):
        entries.append(dict(
            name=name, path="sequential_lenet", route="cuda",
            source="mxnet_tpu_torch/csrc/%s.cu" % (
                "conv_dw" if key == "im2col" else "maxpool_bwd"),
            replaces=line,
            launches_counted_over="eager warm-up batch + capture",
            **seq_launches[key], **row))
    # the ConvLSTM cell's unroll through a captured executor, float32
    entries.append(dict(
        name="conv_dw_im2col", path="bucketing_convlstm", route="cuda",
        source="mxnet_tpu_torch/csrc/conv_dw.cu",
        replaces="mxnet_tpu/ops/pallas_conv.py:133",
        launches_counted_over="eager warm-up backward + capture",
        plan_route="tf32x3", **convlstm_launches, **dw_convlstm))
    # SSD300 (float32, eager): the training path's dW and max-pool backward
    # at SSD300's shapes (phase 3c's sums over one step), and K7 in the
    # detection (phase 3e's row at MultiBoxDetection's shape)
    for key, name, source, line in (
            ("pertap", "conv_dw_pertap", "conv_dw", "pallas_conv.py:111"),
            ("im2col", "conv_dw_im2col", "conv_dw", "pallas_conv.py:133"),
            ("maxpool", "maxpool_bwd", "maxpool_bwd", "pallas_pool.py:55")):
        entries.append(dict(
            name=name, path="ssd_train", route="cuda",
            source="mxnet_tpu_torch/csrc/%s.cu" % source,
            replaces="mxnet_tpu/ops/" + line, launches=ssd_train[key],
            **dict(ssd_rows[key], **({} if key == "maxpool"
                                     else {"plan_route": "tf32x3"}))))
    # no Pallas kernel: the JAX op's greedy loop, a lax.fori_loop
    entries.append(dict(
        name="box_nms", path="ssd_detect", route="cuda",
        source="mxnet_tpu_torch/csrc/box_nms.cu",
        replaces="mxnet_tpu/ops/contrib.py:62",
        launches=ssd_detect["box_nms"], **nms_row))
    entries.append(dict(
        name="rtc_cuda_module", path="imperative", route="cuda",
        compiled_by="nvrtc",
        source="mxnet_tpu_torch/rtc.py, mxnet_tpu_torch/_nvrtc.py, "
               "mxnet_tpu_torch/csrc/rtc/{axpy,sgd_mom,scale_tmpl}.cu",
        replaces="mxnet_tpu/rtc.py:67", launches=rtc_launches, **rtc_row))
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

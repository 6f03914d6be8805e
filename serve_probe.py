"""Run chip_smoke.py's serving phase (4) under PyTorch's pinned-memory
allocator settings, each in a fresh process on one NVIDIA GPU.

    python3 serve_probe.py [--seed N] [--conf SETTING ...]

The server hands each caller views of pinned host memory, and a caller
that holds its results makes the next batch allocate a new pinned block.
PyTorch reads ``PYTORCH_CUDA_ALLOC_CONF`` once, when CUDA starts, so
each setting runs in a process of its own, in turns (the default, each
``--conf``, then the same in reverse order).  Every run prints phase 4's
lines: the latency of the burst whose callers hold every result, the
caching host allocator's blocks and cudaHostAlloc time, and the rest.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

DEFAULT_CONFS = ("pinned_use_cuda_host_register:True,"
                 "pinned_num_register_threads:8",)

CHILD = """
import sys
sys.path.insert(0, %r)
import chip_smoke as cs
from mxnet_tpu_torch import _kernels
smi = cs.environment()
_kernels.library("flash_attn_fwd")
cs.serve(%d, smi)
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--conf", action="append",
                    help="a PYTORCH_CUDA_ALLOC_CONF value to run beside the "
                         "default (repeatable; default: cudaHostRegister "
                         "on 8 threads)")
    args = ap.parse_args()
    confs = [""] + list(args.conf or DEFAULT_CONFS)
    here = os.path.dirname(os.path.abspath(__file__))
    for conf in confs + confs[::-1]:
        env = dict(os.environ)
        env.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        if conf:
            env["PYTORCH_CUDA_ALLOC_CONF"] = conf
        print("serve_probe: PYTORCH_CUDA_ALLOC_CONF=%r" % conf, flush=True)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CHILD % (here, args.seed)],
                              cwd=here, env=env, timeout=900)
        print("serve_probe: exit %d in %.1f s" % (
            proc.returncode, time.perf_counter() - t0), flush=True)
        if proc.returncode:
            sys.exit(proc.returncode)


if __name__ == "__main__":
    main()

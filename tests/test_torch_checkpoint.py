"""The port's checkpoints (``mxnet_tpu_torch/checkpoint.py``) on the CPU:
the cases of tests/test_checkpoint.py that need neither health, ZeRO nor
the parameter server, on a small TransformerLM (2 layers, units 32), and
checkpoints crossing between the packages in both directions.

A port-to-port resume is held bit for bit (parameters, Adam's states and
counts, the losses, Dropout's draws).  Across the packages the trajectory
after a resume is held as tests/test_torch_compiled_step.py holds the two
packages' trajectories: the per-sample losses within 1e-5 relative, every
parameter within 1e-5 of its largest magnitude (float32 Adam, epsilon
1e-4, each ``qkv.bias`` held fixed: its true gradient is 0, see that
file); float16 with ``multi_precision``, the losses and the float32
masters within 2e-3 of their largest magnitude, 2e-2 for the parameters
that start at 0.  What the file carries is held exactly: the restored
parameters, states and update counts equal the writer's.
"""

import json
import os
import pickle
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import checkpoint as jckpt
from mxnet_tpu import gluon as jgl
from mxnet_tpu.gluon.nn.transformer import TransformerLM as JaxLM
from mxnet_tpu_torch import MXNetError, autograd, checkpoint, gluon
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch import runtime_stats
from mxnet_tpu_torch.convert import load_mxnet_tpu_params
from mxnet_tpu_torch.gluon.nn import TransformerLM
from mxnet_tpu_torch.parallel.gluon_step import _leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, U, L, H, S, B = 50, 32, 2, 2, 16, 4
ADAM = {"learning_rate": 1e-3, "epsilon": 1e-4}


@pytest.fixture(autouse=True)
def _no_global_manager():
    checkpoint.reset()
    yield
    checkpoint.reset()


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [(torch.from_numpy(rng.randint(0, V, (B, S)).astype(np.float32)),
             torch.from_numpy(rng.randint(0, V, (B, S)).astype(np.float32)))
            for _ in range(n)]


def _frozen(net):
    for k, p in net._collect_params_with_prefix().items():
        if k.endswith("attn.qkv.bias"):
            p.grad_req = "null"
    return net


def _lm(dropout=0.0, seed=0, prefix="ck_"):
    return _frozen(TransformerLM(V, units=U, num_layers=L, num_heads=H,
                                 max_length=S, dropout=dropout, prefix=prefix,
                                 device="cpu").initialize(seed=seed))


class _Run:
    """A net, its Trainer and a way to step: eager record / backward /
    ``trainer.step``, or ``trainer.compile``."""

    def __init__(self, compiled=False, dropout=0.0, seed=0,
                 optimizer="adam", kw=None, dtype=None):
        self.net = _lm(dropout, seed)
        if dtype is not None:
            self.net.cast(dtype)
        self.trainer = gluon.Trainer(self.net.collect_params(), optimizer,
                                     dict(kw or ADAM))
        self.loss = gluon.loss.SoftmaxCrossEntropyLoss()
        self.cs = self.trainer.compile(self.net, self.loss) \
            if compiled else None

    def step(self, x, y):
        if self.cs is not None:
            return self.cs.step(x, y).detach().clone()
        with autograd.record():
            loss = self.loss(self.net(x), y)
        autograd.backward(loss)
        self.trainer.step(x.shape[0])
        return loss.detach().clone()

    def steps(self, batches):
        return [self.step(x, y) for x, y in batches]

    def state(self):
        """Every parameter, then every state tensor (a restored state not
        yet moved to its weight is numpy)."""
        out = [p.detach().clone() for p in self.net.parameters()]
        for i in sorted(self.trainer._updaters[0].states):
            out += [t.clone() for t in _leaves(checkpoint._tree_map(
                _numpy_as_tensors(self.trainer._updaters[0].states[i]),
                lambda t: t))]
        return out


def _numpy_as_tensors(obj):
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_numpy_as_tensors(v) for v in obj)
    return obj


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------ port only


def test_round_trip_is_bitwise(tmp_path):
    """Parameters, Adam's states and counts, the random state and the step
    come back bit for bit into the objects that diverged after the save."""
    data = _batches(6)
    run = _Run()
    run.steps(data[:3])
    trandom.seed(123)
    trandom.generator("cpu")
    rng_before = trandom.get_state()
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=3,
                                       async_write=False)
    mgr.save_trainer(run.trainer, step=3)
    saved = run.state()
    counts = dict(run.trainer._optimizer._index_update_count)
    run.steps(data[3:])
    torch.rand(3, generator=trandom.generator("cpu"))
    manifest = mgr.restore(trainer=run.trainer)
    assert manifest["step"] == 3 and mgr.step_clock == 3
    assert manifest["lineage"]["previous"] is None
    _equal(run.state(), saved)
    assert run.trainer._optimizer._index_update_count == counts
    assert trandom.get_state() == rng_before
    assert json.loads(json.dumps(manifest["rng"])) == rng_before


@pytest.mark.parametrize("compiled", [False, True])
def test_restore_into_fresh_objects_continues_bitwise(tmp_path, compiled):
    """New net, Trainer (and compiled step) take the checkpoint and the
    next steps exactly as the run that wrote it."""
    data = _batches(6)
    run = _Run(compiled)
    run.steps(data[:4])
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save_trainer(run.trainer, step=4)
    want = run.steps(data[4:])
    fresh = _Run(compiled, seed=9)
    manifest = checkpoint.CheckpointManager(str(tmp_path)).restore(
        trainer=fresh.trainer)
    assert manifest["step"] == 4
    got = fresh.steps(data[4:])
    _equal(got, want)
    _equal(fresh.state(), run.state())
    counts = fresh.trainer._optimizer._index_update_count
    assert set(counts.values()) == {6}


def test_restore_drops_the_captured_step_graphs(tmp_path):
    """A compiled step restored in place keeps its parameters' storage
    (copied in place) and drops its entries for the new state tensors."""
    data = _batches(4)
    run = _Run(compiled=True)
    run.steps(data[:2])
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save_trainer(run.trainer, step=2)
    want = run.steps(data[2:])
    storages = [p.data_ptr() for p in run.net.parameters()]
    generation = run.trainer._updaters[0].generation
    mgr.restore(trainer=run.trainer)
    assert [p.data_ptr() for p in run.net.parameters()] == storages
    assert run.trainer._updaters[0].generation == generation + 1
    _equal(run.steps(data[2:]), want)


def test_keep_last_n_retention(tmp_path):
    run = _Run()
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2,
                                       async_write=False)
    for s in range(1, 6):
        mgr.save_trainer(run.trainer, step=s)
    assert sorted(d for d in os.listdir(str(tmp_path))
                  if d.startswith("ckpt-")) == ["ckpt-00000004",
                                                "ckpt-00000005"]
    assert mgr.latest()["step"] == 5


def _flip(path):
    blob = bytearray(path.read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))  # the same size, another content


def test_corrupt_checkpoint_skipped_with_fallback(tmp_path):
    run = _Run()
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save_trainer(run.trainer, step=1)
    mgr.save_trainer(run.trainer, step=2)
    _flip(tmp_path / "ckpt-00000002" / "params.npz")
    assert mgr.latest()["step"] == 1
    assert mgr.totals["corrupt_skipped"] == 1
    assert [n for n in os.listdir(str(tmp_path))
            if n.startswith("ckpt-00000002.corrupt-")]
    assert mgr.restore(trainer=run.trainer)["step"] == 1
    assert mgr.totals["corrupt_skipped"] == 1  # quarantined: not re-counted


def test_torn_checkpoint_without_manifest_skipped(tmp_path):
    run = _Run()
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save_trainer(run.trainer, step=1)
    torn = tmp_path / "ckpt-00000009"
    torn.mkdir()
    (torn / "params.npz").write_bytes(b"half a file")
    assert mgr.latest()["step"] == 1


def test_async_saves_do_not_block_coalesce_and_spare_the_writers_slot(
        tmp_path):
    """With the writer held on the first snapshot, five more saves return
    at once and coalesce to the newest; the staging is allocated once, the
    slot the writer reads is never written (the first checkpoint holds the
    first step's values), and the newest snapshot wins."""
    data = _batches(6)
    run = _Run()
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=10,
                                       async_write=True)
    gate, started = threading.Event(), threading.Event()
    write = mgr._write

    def held(snap):
        started.set()
        gate.wait(60)
        return write(snap)

    mgr._write = held
    expect = {}
    t0 = time.perf_counter()
    for s, (x, y) in enumerate(data, 1):
        run.step(x, y)
        mgr.save_trainer(run.trainer, step=s)
        expect[s] = [p.detach().clone() for p in run.trainer._params]
        if s == 1:
            assert started.wait(30)
    assert time.perf_counter() - t0 < 30, "a save blocked on the writer"
    assert mgr.latest() is None  # nothing committed while held
    gate.set()
    assert mgr.wait(60)
    assert mgr.totals["saves"] == 6 and mgr.totals["written"] == 2
    assert mgr.totals["coalesced"] == 4
    assert mgr.totals["staging_allocs"] == 1
    assert mgr.latest()["step"] == 6
    for s in (1, 6):
        m = dict(json.load(open(tmp_path / ("ckpt-%08d" % s)
                                / "MANIFEST.json")),
                 path=str(tmp_path / ("ckpt-%08d" % s)))
        params = mgr.load_params(m, ctx="cpu")
        names = [checkpoint._param_name(p, i)
                 for i, p in enumerate(run.trainer._params)]
        for name, want in zip(names, expect[s]):
            assert torch.equal(params[name].data_torch, want), (s, name)
    mgr.close()


@pytest.mark.parametrize("compiled", [False, True])
def test_trainer_hook_saves_and_auto_resumes(tmp_path, compiled):
    """``checkpoint.enable`` arms the hook of ``Trainer.step`` (eager) and
    ``CompiledStep.step``; ``lineage`` names the last commit, and
    ``auto_resume`` puts it back into new objects."""
    data = _batches(4)
    mgr = checkpoint.enable(str(tmp_path), interval=2, async_write=False)
    run = _Run(compiled)
    run.steps(data)
    assert mgr.totals["written"] == 2 and mgr.latest()["step"] == 4
    lin = checkpoint.lineage()
    assert lin["step"] == 4
    assert lin["last_good_path"].endswith("ckpt-00000004")
    assert checkpoint.snapshot()["enabled"]
    fresh = _Run(compiled, seed=5)
    assert checkpoint.auto_resume(trainer=fresh.trainer) == 4
    _equal(fresh.state(), run.state())
    checkpoint.disable()
    assert checkpoint.manager() is None and checkpoint.lineage() is None


def test_hook_off_reads_one_dict_entry(monkeypatch):
    """Off, a step never reaches ``on_step``: the guard is the one read of
    ``checkpoint._state["on"]``."""
    def boom(*a, **k):
        raise AssertionError("on_step called while checkpointing is off")

    monkeypatch.setattr(checkpoint, "on_step", boom)
    for compiled in (False, True):
        _Run(compiled).steps(_batches(1))


def test_env_arms_the_hook(tmp_path):
    """``MXNET_TPU_CKPT`` (with ``_INTERVAL``, ``_KEEP`` and ``_ASYNC``)
    arms the port's auto-checkpoint at import, as the JAX package's."""
    code = textwrap.dedent("""
        import numpy as np, torch
        from mxnet_tpu_torch import checkpoint, gluon
        from mxnet_tpu_torch.gluon import nn
        mgr = checkpoint.manager()
        assert checkpoint.is_enabled() and mgr is not None
        assert (mgr.interval, mgr.keep, mgr.async_write) == (3, 1, False)
        net = nn.Dense(2, in_units=3, device="cpu").initialize()
        tr = gluon.Trainer(net.collect_params(), "sgd")
        for _ in range(6):
            tr.step(1)
        print(sorted(n for n in __import__("os").listdir(mgr.directory)))
    """)
    env = dict(os.environ, PYTHONPATH=REPO, MXNET_TPU_CKPT=str(tmp_path),
               MXNET_TPU_CKPT_INTERVAL="3", MXNET_TPU_CKPT_KEEP="1",
               MXNET_TPU_CKPT_ASYNC="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "['ckpt-00000006']" in proc.stdout


def test_trainer_states_versioned_and_atomic(tmp_path, monkeypatch):
    """``save_states`` writes its header through ``atomic_write``; a write
    that fails leaves the earlier file whole and no temporary file."""
    run = _Run()
    run.steps(_batches(1))
    path = tmp_path / "t.states"
    run.trainer.save_states(str(path))
    assert path.read_bytes().startswith(checkpoint.TRAINER_STATES_MAGIC)
    before = path.read_bytes()
    monkeypatch.setattr(run.trainer._updaters[0], "get_states",
                        lambda dump_optimizer=False: b"x" * 10)
    real = checkpoint._fsync

    def failing(p):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_fsync", failing)
    with pytest.raises(OSError):
        run.trainer.save_states(str(path))
    monkeypatch.setattr(checkpoint, "_fsync", real)
    assert path.read_bytes() == before
    assert os.listdir(str(tmp_path)) == ["t.states"]


def test_persistence_paths_write_through_atomic_write(tmp_path,
                                                      monkeypatch):
    """``save_parameters``, ``save_optimizer_states`` and
    ``save_checkpoint`` all write through ``checkpoint.atomic_write``."""
    mx = tmx
    seen = []
    real = checkpoint.atomic_write

    def spy(path):
        seen.append(os.path.basename(path))
        return real(path)

    monkeypatch.setattr(checkpoint, "atomic_write", spy)
    _lm().save_parameters(str(tmp_path / "net.params"))
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.bind([("data", (4, 5))], [("softmax_label", (4,))])
    mod.init_params()
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    mod.save_optimizer_states(str(tmp_path / "m.states"))
    mod.save_checkpoint(str(tmp_path / "m"), 1)
    assert seen == ["net.params", "m.states", "m-symbol.json",
                    "m-0001.params", "m-0001.manifest.json"]
    assert not [n for n in os.listdir(str(tmp_path)) if ".tmp" in n]


def _mlp(pkg):
    return pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
        pkg.sym.Variable("data"), num_hidden=3, name="fc"), name="softmax")


def _fit_module(pkg, ctx):
    mod = pkg.mod.Module(_mlp(pkg), context=ctx)
    rs = np.random.RandomState(0)
    it = pkg.io.NDArrayIter(rs.rand(16, 5).astype(np.float32),
                            np.zeros(16, np.float32), batch_size=16,
                            label_name="softmax_label")
    mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1})
    return mod


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_legacy_checkpoint_manifest_crosses_and_detects_corruption(
        tmp_path, writer):
    """``save_checkpoint`` writes the sidecar manifest in the JAX
    package's format; each package checks the other's, and a corrupt
    ``.params`` raises MXNetError in both."""
    prefix = str(tmp_path / "m")
    if writer == "port":
        _fit_module(tmx, tmx.cpu()).save_checkpoint(prefix, 1)
    else:
        _fit_module(jmx, jmx.cpu()).save_checkpoint(prefix, 1)
    manifest = json.load(open(prefix + "-0001.manifest.json"))
    assert sorted(manifest["files"]) == ["m-0001.params", "m-symbol.json"]
    _, jarg, _ = jmx.model.load_checkpoint(prefix, 1)
    _, targ, _ = tmx.model.load_checkpoint(prefix, 1, ctx=tmx.cpu())
    for k in jarg:
        np.testing.assert_array_equal(targ[k].asnumpy(), jarg[k].asnumpy())
    _flip(tmp_path / "m-0001.params")
    with pytest.raises(jmx.base.MXNetError, match="checksum"):
        jmx.model.load_checkpoint(prefix, 1)
    with pytest.raises(MXNetError, match="checksum"):
        tmx.model.load_checkpoint(prefix, 1, ctx=tmx.cpu())


def test_retired_checkpoint_recovered_after_crash(tmp_path):
    run = _Run()
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save_trainer(run.trainer, step=3)
    mgr.save_trainer(run.trainer, step=3)  # a same-step overwrite
    assert os.listdir(str(tmp_path)) == ["ckpt-00000003"]
    os.rename(str(tmp_path / "ckpt-00000003"),
              str(tmp_path / "ckpt-00000003.retire-999-1"))
    mgr2 = checkpoint.CheckpointManager(str(tmp_path))
    assert os.listdir(str(tmp_path)) == ["ckpt-00000003"]
    assert mgr2.latest()["step"] == 3


def test_quarantined_checkpoints_bounded(tmp_path):
    run = _Run()
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=2,
                                       async_write=False)
    mgr.save_trainer(run.trainer, step=1)
    for s in range(2, 8):
        mgr.save_trainer(run.trainer, step=s)
        _flip(tmp_path / ("ckpt-%08d" % s) / "params.npz")
        assert mgr.latest()["step"] == 1
    mgr.save_trainer(run.trainer, step=8)  # the commit prunes
    assert len([n for n in os.listdir(str(tmp_path))
                if ".corrupt-" in n]) <= 2


def test_save_and_load_aux_and_the_multi_device_paths_raise(tmp_path):
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(5, {"w": np.arange(4, dtype=np.float32),
                 "b": torch.ones(2)}, extra={"epoch": 1},
             aux={"cursor": 17})
    m = mgr.latest()
    assert m["extra"] == {"epoch": 1} and not m["has_trainer"]
    assert checkpoint.load_aux(m) == mgr.load_aux(m) == {"cursor": 17}
    p = mgr.load_params(m, ctx="cpu")
    assert p["w"].asnumpy().tolist() == [0, 1, 2, 3]
    with pytest.raises(MXNetError, match="item 9"):
        mgr.save_sharded(6, {"shard-0-of-2": {}})
    checkpoint.enable(str(tmp_path))
    with pytest.raises(MXNetError, match="item 9"):
        checkpoint.auto_resume(zero_step=object())


@pytest.mark.parametrize("compiled", [False, True])
def test_dropout_resume_continues_the_draws_bitwise(tmp_path, compiled):
    """With Dropout 0.1 the resumed run draws the masks the uninterrupted
    one drew: the generator's state comes back with the checkpoint."""
    data = _batches(6)
    trandom.seed(11)
    run = _Run(compiled, dropout=0.1)
    run.steps(data[:4])
    checkpoint.CheckpointManager(str(tmp_path), async_write=False) \
        .save_trainer(run.trainer, step=4)
    want = run.steps(data[4:])
    trandom.seed(99)
    fresh = _Run(compiled, dropout=0.1, seed=3)
    checkpoint.CheckpointManager(str(tmp_path)).restore(
        trainer=fresh.trainer)
    _equal(fresh.steps(data[4:]), want)
    _equal(fresh.state(), run.state())
    # and a resume without the random state draws other masks
    fresh = _Run(compiled, dropout=0.1, seed=3)
    m = checkpoint.CheckpointManager(str(tmp_path)).latest()
    checkpoint.CheckpointManager(str(tmp_path)).restore(
        trainer=fresh.trainer, manifest=dict(m, rng=None))
    assert not torch.equal(fresh.steps(data[4:5])[0], want[0])


def test_random_state_is_json_and_a_jax_state_restores_the_seed():
    trandom.seed(5)
    a = torch.rand(4, generator=trandom.generator("cpu"))
    trandom.host_rng().rand(3)
    st = json.loads(json.dumps(trandom.get_state()))
    b = torch.rand(4, generator=trandom.generator("cpu"))
    h = trandom.host_rng().rand(3)
    trandom.set_state(st)
    assert torch.equal(torch.rand(4, generator=trandom.generator("cpu")), b)
    np.testing.assert_array_equal(trandom.host_rng().rand(3), h)
    # the JAX package's {"seed", "counter"}: its key chain cannot be
    # continued by a PyTorch generator, so the seed alone comes back
    trandom.set_state({"seed": 5, "counter": 42})
    assert torch.equal(torch.rand(4, generator=trandom.generator("cpu")), a)
    jmx.random.set_state(dict(st))  # the JAX package reads the port's
    assert jmx.random.get_state()["seed"] == 5


def test_bf16_states_are_widened_in_the_file_and_come_back(tmp_path):
    data = _batches(3)
    run = _Run(dtype="bfloat16", optimizer="sgd",
               kw={"learning_rate": 0.1, "momentum": 0.9})
    run.steps(data[:2])
    mgr = checkpoint.CheckpointManager(str(tmp_path), async_write=False)
    mgr.save_trainer(run.trainer, step=2)
    with np.load(tmp_path / "ckpt-00000002" / "params.npz") as f:
        assert {f[k].dtype for k in f.files} == {np.dtype(np.float32)}
    want = run.steps(data[2:])
    fresh = _Run(dtype="bfloat16", optimizer="sgd",
                 kw={"learning_rate": 0.1, "momentum": 0.9}, seed=4)
    mgr.restore(trainer=fresh.trainer)
    _equal(fresh.steps(data[2:]), want)
    _equal(fresh.state(), run.state())


_CRASH_CHILD = r"""
import sys, time
import numpy as np, torch
from mxnet_tpu_torch import autograd, checkpoint, gluon
from mxnet_tpu_torch.gluon.nn import TransformerLM

ckdir, mode, out = sys.argv[1], sys.argv[2], sys.argv[3]
TOTAL, AT = 12, 6
rng = np.random.RandomState(5)
X = torch.from_numpy(rng.randint(0, 50, (TOTAL, 4, 16)).astype(np.float32))
net = TransformerLM(50, units=32, num_layers=2, num_heads=2, max_length=16,
                    prefix="cr_", device="cpu").initialize(seed=2)
tr = gluon.Trainer(net.collect_params(), "adam", {"learning_rate": 1e-3})
loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

def steps(lo, hi):
    for i in range(lo, hi):
        with autograd.record():
            loss = loss_fn(net(X[i]), X[(i + 1) % TOTAL])
        autograd.backward(loss)
        tr.step(4)

mgr = checkpoint.CheckpointManager(ckdir, keep=5, async_write=False)
if mode == "full":
    steps(0, TOTAL)
elif mode == "kill":
    steps(0, AT)
    mgr.save_trainer(tr, step=AT)
    steps(AT, AT + 1)
    real = checkpoint._sha256
    def stall(path, chunk=1 << 20):
        open(out, "w").write("mid-write")
        time.sleep(300)
        return real(path, chunk)
    checkpoint._sha256 = stall
    mgr.save_trainer(tr, step=AT + 1)  # killed in here
else:
    m = mgr.restore(trainer=tr)
    assert m is not None and m["step"] == AT, m
    steps(m["step"], TOTAL)
np.savez(out, **{k: v.detach().numpy()
                 for k, v in net._collect_params_with_prefix().items()})
"""


def test_sigkill_mid_checkpoint_then_bitwise_resume(tmp_path):
    """A child killed while it writes its second checkpoint leaves a torn
    staging directory; a new manager removes it, the newest valid
    checkpoint is the first, and a child that resumes from it finishes
    with the parameters of an uninterrupted run, bit for bit."""
    script = tmp_path / "child.py"
    script.write_text(_CRASH_CHILD)
    ckdir = tmp_path / "ckpts"
    ckdir.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO)

    def run(mode, out, wait=True):
        proc = subprocess.Popen([sys.executable, str(script), str(ckdir),
                                 mode, str(out)], cwd=REPO, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        if wait:
            text, _ = proc.communicate(timeout=240)
            assert proc.returncode == 0, text.decode()
        return proc

    run("full", tmp_path / "full.npz")
    marker = tmp_path / "marker"
    proc = run("kill", marker, wait=False)
    deadline = time.monotonic() + 240
    while not marker.exists():
        assert proc.poll() is None, proc.stdout.read().decode()
        assert time.monotonic() < deadline, "the child never stalled"
        time.sleep(0.1)
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    assert any(".tmp-" in n for n in os.listdir(str(ckdir)))
    mgr = checkpoint.CheckpointManager(str(ckdir))
    assert not any(".tmp-" in n for n in os.listdir(str(ckdir)))
    assert mgr.latest()["step"] == 6
    run("resume", tmp_path / "resume.npz")
    with np.load(tmp_path / "full.npz") as a, \
            np.load(tmp_path / "resume.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]), k


# ------------------------------------------------- across the packages


@pytest.fixture(scope="module")
def start():
    """Seeded weights made by the JAX package's LM, and the batches."""
    jmx.random.seed(7)
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S,
                prefix="x_")
    net.initialize()
    data = _batches(5, seed=3)
    net(jmx.nd.array(data[0][0].numpy()))
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}, data


def _jax_side(params, dtype=None):
    net = JaxLM(V, units=U, num_layers=L, num_heads=H, max_length=S,
                prefix="x_")
    net.initialize()
    net(jmx.nd.array(np.zeros((B, S), np.float32)))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(params[k]))
        if k.endswith("attn.qkv.bias"):
            p.grad_req = "null"
    if dtype is not None:
        net.cast(dtype)
    kw = dict(ADAM, multi_precision=dtype is not None)
    trainer = jgl.Trainer(net.collect_params(), "adam", kw)
    cs = trainer.compile(net, jgl.loss.SoftmaxCrossEntropyLoss())
    return net, trainer, lambda batches: [
        cs.step(jmx.nd.array(x.numpy()), jmx.nd.array(y.numpy()))
        .asnumpy().astype(np.float32) for x, y in batches]


def _port_side(params, dtype=None):
    net = _frozen(load_mxnet_tpu_params(
        TransformerLM(V, units=U, num_layers=L, num_heads=H, max_length=S,
                      prefix="x_", device="cpu"), params))
    if dtype is not None:
        net.cast(dtype)
    kw = dict(ADAM, multi_precision=dtype is not None)
    trainer = gluon.Trainer(net.collect_params(), "adam", kw)
    cs = trainer.compile(net, gluon.loss.SoftmaxCrossEntropyLoss())
    return net, trainer, lambda batches: [
        cs.step(x, y).float().numpy() for x, y in batches]


def _params_np(net):
    out = {}
    for k, p in net._collect_params_with_prefix().items():
        v = p.data().asnumpy() if hasattr(p, "data") and callable(p.data) \
            else p.detach().float().numpy()
        out[k] = v.astype(np.float32)
    return out


def _masters(trainer, net, port):
    """Each trainable parameter's float32 master, by structural name."""
    states = trainer._updaters[0].states
    out = {}
    for i, (k, p) in enumerate(net._collect_params_with_prefix().items()):
        if p.grad_req == "null" or i not in states:
            continue
        m = states[i][0]
        out[k] = np.asarray(m) if port else m.asnumpy()
    return out


def _hold(got_losses, want_losses, got, want, params, fp16):
    for g, w in zip(got_losses, want_losses):
        if fp16:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=2e-3 * np.abs(w).max())
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5)
    for k, w in want.items():
        tol = (2e-2 if not params[k].any() else 2e-3) if fp16 else 1e-5
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("dtype", [None, "float16"])
def test_jax_checkpoint_resumes_in_the_port(start, tmp_path, dtype):
    """The JAX package's CheckpointManager writes after 3 compiled Adam
    steps; the port's ``auto_resume`` loads it into a new compiled
    Trainer (the parameters, states and counts exactly), and both take 2
    more steps."""
    params, data = start
    fp16 = dtype is not None
    jnet, jtr, jstep = _jax_side(params, dtype)
    jstep(data[:3])
    jckpt.CheckpointManager(str(tmp_path), async_write=False) \
        .save_trainer(jtr, step=3)
    at3 = _params_np(jnet)
    counts3 = dict(jtr._optimizer._index_update_count)
    masters3 = _masters(jtr, jnet, port=False) if fp16 else None
    want_losses = jstep(data[3:])
    net, trainer, step = _port_side(
        {k: np.zeros_like(v) for k, v in params.items()}, dtype)
    checkpoint.enable(str(tmp_path), async_write=False)
    assert checkpoint.auto_resume(trainer=trainer) == 3
    for k, v in _params_np(net).items():
        np.testing.assert_array_equal(v, at3[k], err_msg=k)
    if fp16:
        for k, v in _masters(trainer, net, port=True).items():
            np.testing.assert_array_equal(v, masters3[k], err_msg=k)
    assert trainer._optimizer._index_update_count == counts3
    got_losses = step(data[3:])
    if fp16:
        got = _masters(trainer, net, port=True)
        want = _masters(jtr, jnet, port=False)
    else:
        got, want = _params_np(net), _params_np(jnet)
    _hold(got_losses, want_losses, got, want, params, fp16)


@pytest.mark.parametrize("dtype", [None, "float16"])
def test_port_checkpoint_resumes_in_jax(start, tmp_path, dtype):
    """The port writes after 3 compiled Adam steps; the JAX package's
    ``CheckpointManager.restore`` loads it into a new compiled Trainer
    (with its own classes: the port names them), and both take 2 more
    steps."""
    params, data = start
    fp16 = dtype is not None
    net, trainer, step = _port_side(params, dtype)
    step(data[:3])
    checkpoint.CheckpointManager(str(tmp_path), async_write=False) \
        .save_trainer(trainer, step=3)
    at3 = _params_np(net)
    counts3 = dict(trainer._optimizer._index_update_count)
    got_losses = step(data[3:])
    with open(tmp_path / "ckpt-00000003" / "trainer.pkl", "rb") as f:
        raw = pickle.load(f)  # the JAX package's classes, numpy leaves
    assert isinstance(raw["states"][1][0], jckpt._NDLeaf)
    jnet, jtr, jstep = _jax_side(
        {k: np.zeros_like(v) for k, v in params.items()}, dtype)
    m = jckpt.CheckpointManager(str(tmp_path)).restore(trainer=jtr)
    assert m["step"] == 3
    for k, v in _params_np(jnet).items():
        np.testing.assert_array_equal(v, at3[k], err_msg=k)
    assert jtr._optimizer._index_update_count == counts3
    assert type(jtr._optimizer).__module__ == "mxnet_tpu.optimizer.optimizer"
    want_losses = jstep(data[3:])
    if fp16:
        got = _masters(trainer, net, port=True)
        want = _masters(jtr, jnet, port=False)
    else:
        got, want = _params_np(net), _params_np(jnet)
    _hold(got_losses, want_losses, got, want, params, fp16)


def test_runtime_stats_count_the_manager():
    runtime_stats.reset()
    probe = runtime_stats.health_probe()
    assert probe["checkpoint_writes"] == 0 and probe["live_bytes"] == 0


_OPTIMIZERS = {
    "sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
    "nag": {"learning_rate": 0.1, "momentum": 0.9},
    "signum": {"learning_rate": 0.01, "momentum": 0.9},
    "adam": {},
    "adamax": {},
    "ftml": {},
    "ftrl": {},
    "rmsprop": {},
    "rmsprop/centered": {"centered": True},
    "adagrad": {},
    "adadelta": {},
}


def _dense_run(pkg, name, kw, x, params=None):
    """A Dense(3) on 5 inputs and its Trainer after two steps (or none,
    with ``params`` None: to be restored into)."""
    if pkg is jmx:
        net = jmx.gluon.nn.Dense(3, in_units=5, prefix="tree_")
        net.initialize(ctx=jmx.cpu())
        arr, rec = jmx.nd.array, jmx.autograd.record
    else:
        net = gluon.nn.Dense(3, in_units=5, prefix="tree_",
                             device="cpu").initialize()
        arr, rec = (lambda v: torch.from_numpy(np.asarray(v))), \
            autograd.record
    tr = pkg.gluon.Trainer(net.collect_params(), name.split("/")[0],
                           dict(kw))
    if params is not None:
        for k, p in net.collect_params().items():
            p.set_data(arr(params[k]))
        for _ in range(2):
            with rec():
                loss = (net(arr(x)) ** 2).sum()
            loss.backward() if pkg is jmx else autograd.backward(loss)
            tr.step(4)
    return net, tr


def _state_arrays(states):
    """``{index: [numpy leaves]}`` of either package's updater states."""
    def leaves(s):
        if s is None:
            return []
        if isinstance(s, (tuple, list)):
            return [v for t in s for v in leaves(t)]
        return [np.asarray(s.asnumpy() if hasattr(s, "asnumpy")
                           else (s.numpy() if isinstance(s, torch.Tensor)
                                 else s))]
    return {i: leaves(s) for i, s in states.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_every_optimizers_state_tree_crosses_both_ways(tmp_path, name,
                                                       writer):
    """Each compile-safe optimizer's Trainer checkpoint, written by one
    package after two steps and restored by the other's manager: the
    parameters, every state leaf (the JAX layout: a tuple where the JAX
    optimizer keeps one, None where it keeps none) and the update counts
    arrive exactly."""
    rs = np.random.RandomState(4)
    x = rs.rand(4, 5).astype(np.float32)
    params = {"tree_weight": rs.randn(3, 5).astype(np.float32),
              "tree_bias": rs.randn(3).astype(np.float32)}
    src_pkg, dst_pkg = (tmx, jmx) if writer == "port" else (jmx, tmx)
    kw = _OPTIMIZERS[name]
    net, tr = _dense_run(src_pkg, name, kw, x, params)
    (jckpt if writer == "jax" else checkpoint).CheckpointManager(
        str(tmp_path), async_write=False).save_trainer(tr, step=2)
    net2, tr2 = _dense_run(dst_pkg, name, kw, x)
    m = (checkpoint if writer == "jax" else jckpt).CheckpointManager(
        str(tmp_path)).restore(trainer=tr2)
    assert m["step"] == 2
    for k, p in net.collect_params().items():
        np.testing.assert_array_equal(
            net2.collect_params()[k].data().asnumpy(), p.data().asnumpy())
    got = _state_arrays(tr2._updaters[0].states)
    want = _state_arrays(tr._updaters[0].states)
    assert sorted(got) == sorted(want) == [0, 1]
    for i in want:
        assert len(got[i]) == len(want[i]), (i, len(got[i]), len(want[i]))
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)
    assert tr2._optimizer._index_update_count == \
        tr._optimizer._index_update_count == {0: 2, 1: 2}

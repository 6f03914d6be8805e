"""``example/image-classification/train_imagenet.py`` on the port, on the
CPU: the script and its ``common/fit.py`` and ``common/data.py`` are read
with ``mxnet_tpu`` replaced by ``mxnet_tpu_torch`` and nothing else, and
``main`` runs under ``with mx.cpu():`` (the port's entry points default
to the card).  The script writes its synthetic JPEG record file, traces
the zoo's resnet18_v1 into a Symbol through
``contrib.quantization._trace_block``, and trains it by ``Module.fit``
over ``mx.io.ImageRecordIter`` through ``mx.kv.create(args.kv_store)``
(the default, ``"tpu"``, one store here) on ``fit.py``'s context:
``mx.tpu()`` when ``mx.context.num_tpus()`` counts a card, else the CPU.
``example/`` is read, never edited.
"""

import logging
import math
import os
import re
import sys
import types

import numpy as np

import mxnet_tpu_torch as mx

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "example", "image-classification")


def _load(name, path, package=None):
    with open(path) as f:
        src = f.read().replace("mxnet_tpu", "mxnet_tpu_torch")
    mod = types.ModuleType(name)
    mod.__file__ = path
    if package is not None:
        mod.__package__ = package
    exec(compile(src, "%s (on the port)" % path, "exec"), mod.__dict__)
    return mod


def test_train_imagenet_main_runs_on_the_port(monkeypatch, tmp_path,
                                              caplog):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    common = types.ModuleType("common")
    common.__path__ = []
    monkeypatch.setitem(sys.modules, "common", common)
    for part in ("data", "fit"):
        mod = _load("common." + part,
                    os.path.join(ROOT, "common", part + ".py"), "common")
        monkeypatch.setitem(sys.modules, "common." + part, mod)
        setattr(common, part, mod)
    script = _load("train_imagenet_on_the_port",
                   os.path.join(ROOT, "train_imagenet.py"))
    monkeypatch.setattr(sys, "path", list(sys.path))
    caplog.set_level(logging.INFO)
    with mx.cpu():
        mod = script.main(["--network", "resnet18_v1", "--image-shape",
                           "3,32,32", "--batch-size", "8", "--num-examples",
                           "32", "--num-epochs", "1", "--disp-batches",
                           "1"])
    assert os.path.exists(tmp_path / "synthetic_train.rec")
    assert isinstance(mod, mx.mod.Module)
    assert mod._context == [mx.cpu()]
    assert mod._update_on_kvstore and mod._kvstore.type == "tpu"
    speed = [r.getMessage() for r in caplog.records
             if "samples/sec" in r.getMessage()]
    assert len(speed) >= 2, [r.getMessage() for r in caplog.records]
    for line in speed:
        m = re.search(r"Speed: ([0-9.]+) samples/sec", line)
        assert m and float(m.group(1)) > 0, line
    train = [r.getMessage() for r in caplog.records
             if "Train-accuracy" in r.getMessage()]
    assert train, [r.getMessage() for r in caplog.records]
    outputs = mod.get_outputs()[0].asnumpy()
    assert outputs.shape == (8, 10) and np.isfinite(outputs).all()
    loss = -np.log(outputs[np.arange(8), mod._exec_group.execs[0]
                           .arg_dict["softmax_label"].asnumpy()
                           .astype(int)]).mean()
    assert math.isfinite(loss)
    for name, arr in mod.get_params()[0].items():
        assert np.isfinite(arr.asnumpy()).all(), name

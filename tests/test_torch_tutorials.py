"""The JAX package's nine runnable Gluon tutorials on the PyTorch port.

Each ``docs/tutorials/gluon/*.py`` is read with ``mxnet_tpu`` replaced by
``mxnet_tpu_torch`` and nothing else, and run under ``with mx.cpu():``
(the port's entry points default to the card); it must print its ``OK``.
``docs/`` is read, never edited.
"""

import contextlib
import io
import os

import pytest

import mxnet_tpu_torch as mx

ROOT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "docs", "tutorials", "gluon")
TUTORIALS = ["autograd", "custom_layer", "datasets", "gluon", "hybrid",
             "learning_rate_schedules", "mnist", "naming",
             "save_load_params"]


def test_the_list_is_every_gluon_tutorial():
    assert sorted(f[:-3] for f in os.listdir(ROOT) if f.endswith(".py")) \
        == TUTORIALS


@pytest.mark.parametrize("name", TUTORIALS)
def test_tutorial_runs_on_the_port(name):
    with open(os.path.join(ROOT, name + ".py")) as f:
        src = f.read().replace("mxnet_tpu", "mxnet_tpu_torch")
    out = io.StringIO()
    with mx.cpu(), contextlib.redirect_stdout(out):
        exec(compile(src, "%s.py (on the port)" % name, "exec"),
             {"__name__": "__main__"})
    assert "OK" in out.getvalue(), out.getvalue()

"""Names the JAX package exports, in the port: the top-level aliases of
``mxnet_tpu/__init__.py`` (``mx.NDArray``, ``mx.Module``,
``mx.save_checkpoint``, ...) and every alias under which
``mx.nd.contrib`` installs a contrib op (``register.populate``: the
canonical name, each alias, each ``_contrib_`` name).  Each name must
exist in both packages and be the same kind of object; the aliases of one
op must be one function."""

import inspect

import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOP_LEVEL = ["NDArray", "Symbol", "Module", "Executor", "DataIter",
             "DataBatch", "NameManager", "save_checkpoint",
             "load_checkpoint", "do_checkpoint", "predictor", "test_utils",
             "log"]

# canonical name: its aliases, as both registries list them
CONTRIB = {
    "MultiBoxPrior": ("multibox_prior", "_contrib_MultiBoxPrior"),
    "MultiBoxTarget": ("multibox_target", "_contrib_MultiBoxTarget"),
    "MultiBoxDetection": ("multibox_detection",
                          "_contrib_MultiBoxDetection"),
    "box_nms": ("_contrib_box_nms",),
    "box_iou": ("_contrib_box_iou",),
}


def _kind(obj):
    if inspect.isclass(obj):
        return "class"
    if inspect.ismodule(obj):
        return "module"
    if callable(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("where,name",
                         [("top", n) for n in TOP_LEVEL]
                         + [("contrib", n) for c, al in sorted(CONTRIB.items())
                            for n in (c,) + al])
def test_name_exists_in_both_packages_as_the_same_kind(where, name):
    def get(mx):
        return getattr(mx.nd.contrib if where == "contrib" else mx, name)

    jobj, tobj = get(jmx), get(tmx)
    assert _kind(tobj) == _kind(jobj)
    if where == "top":
        assert name in tmx.__all__
        if inspect.isclass(tobj):
            assert tobj.__name__ == jobj.__name__
    else:
        canonical = next(c for c, al in CONTRIB.items()
                         if name == c or name in al)
        # one function under every name, in each package
        assert tobj is getattr(tmx.nd.contrib, canonical)
        assert jobj is getattr(jmx.nd.contrib, canonical)
        assert name in tmx.nd.contrib.__all__


def test_aliases_name_the_port_classes():
    from mxnet_tpu_torch import executor, io, model, module, name, ndarray
    from mxnet_tpu_torch import symbol

    assert tmx.NDArray is ndarray.NDArray
    assert tmx.Symbol is symbol.Symbol
    assert tmx.Module is module.Module
    assert tmx.Executor is executor.Executor
    assert tmx.DataIter is io.DataIter and tmx.DataBatch is io.DataBatch
    assert tmx.NameManager is name.NameManager
    assert tmx.save_checkpoint is model.save_checkpoint
    assert tmx.load_checkpoint is model.load_checkpoint


@pytest.mark.parametrize("name", ["CRITICAL", "ERROR", "WARNING", "INFO",
                                  "DEBUG", "NOTSET"])
def test_log_level_constants_equal_jax(name):
    assert getattr(tmx.log, name) == getattr(jmx.log, name)
    assert name in tmx.log.__all__


def test_deprecated_get_logger_warns_as_jax():
    for mx in (jmx, tmx):
        with pytest.warns(DeprecationWarning, match="get_logger"):
            logger = mx.log.getLogger("mxt_exports_test", level=mx.log.INFO)
        assert logger.level == mx.log.INFO

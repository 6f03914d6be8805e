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


# ------------------------------------------------------------------- F1


def _jax_model_table():
    """The names of the JAX package's ``get_model`` table, from the error
    it raises on an unknown name."""
    import ast

    with pytest.raises(ValueError) as err:
        jmx.gluon.model_zoo.get_model("no-such-net")
    return set(ast.literal_eval(str(err.value).split("Available: ")[1]))


@pytest.mark.parametrize("where", ["model_zoo", "model_zoo.vision"])
@pytest.mark.parametrize("name", ["resnet18_v1", "ResNet50_v2", "vgg11",
                                  "vgg16_bn"])
def test_get_model_builds_the_jax_tables_nets(where, name):
    """Every ResNet and VGG of the table builds the JAX package's network:
    the same class and the same parameters by structural name."""
    def zoo(pkg):
        mod = pkg.gluon.model_zoo
        return mod.vision if where.endswith("vision") else mod

    kw = {"classes": 10}
    j = zoo(jmx).get_model(name, **kw)
    t = zoo(tmx).get_model(name, device="cpu", **kw)
    assert type(t).__name__ == type(j).__name__
    assert sorted(t._collect_params_with_prefix()) == \
        sorted(j._collect_params_with_prefix())


def test_get_model_table_equals_jax_and_the_rest_raise():
    """The port's table is the JAX package's; a net not ported yet raises
    MXNetError naming ROADMAP's item, an unknown name ValueError in both."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    table = _jax_model_table()
    assert set(vision._MODELS) | set(vision._NOT_PORTED) == table
    for name in vision._NOT_PORTED:
        assert callable(jmx.gluon.model_zoo.vision.get_model)
        with pytest.raises(tmx.MXNetError, match="item 8"):
            tmx.gluon.model_zoo.get_model(name)
    jmx.gluon.model_zoo.get_model("alexnet")  # the JAX package builds it
    with pytest.raises(ValueError):
        tmx.gluon.model_zoo.get_model("no-such-net")


def test_ndarray_diag_pad_dlpack_onehot_and_load_frombuffer(tmp_path):
    import numpy as np
    import torch

    cpu = tmx.cpu()
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    j, t = jmx.nd.array(x), tmx.nd.array(x, ctx=cpu)
    for k in (-1, 0, 2):
        np.testing.assert_array_equal(t.diag(k).asnumpy(),
                                      j.diag(k).asnumpy())
    v = jmx.nd.array(x[0]), tmx.nd.array(x[0], ctx=cpu)
    np.testing.assert_array_equal(v[1].diag(1).asnumpy(),
                                  v[0].diag(1).asnumpy())
    x4 = x.reshape(1, 1, 3, 4)
    for mode in ("constant", "edge", "reflect"):
        kw = dict(mode=mode, pad_width=(0, 0, 0, 0, 1, 2, 2, 1),
                  constant_value=1.5)
        np.testing.assert_array_equal(
            tmx.nd.array(x4, ctx=cpu).pad(**kw).asnumpy(),
            jmx.nd.array(x4).pad(**kw).asnumpy())
    for read in ("to_dlpack_for_read", "to_dlpack_for_write"):
        got = torch.utils.dlpack.from_dlpack(getattr(t, read)())
        want = torch.utils.dlpack.from_dlpack(getattr(j, read)())
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    got = torch.utils.dlpack.from_dlpack(t.to_dlpack_for_write())
    got[0, 0] = 7.0  # no copy: a write shows in the array
    assert t.asnumpy()[0, 0] == 7.0
    idx = np.array([2, 0, 1, 2], np.float32)
    outs = [pkg.nd.onehot_encode(pkg.nd.array(idx, **kw),
                                 pkg.nd.zeros((4, 3), **kw))
            for pkg, kw in ((jmx, {}), (tmx, {"ctx": cpu}))]
    np.testing.assert_array_equal(outs[1].asnumpy(), outs[0].asnumpy())
    for save in (jmx.nd.save, tmx.nd.save):
        fname = str(tmp_path / "blob")
        save(fname, {"a": x, "b": x[:1]} if save is tmx.nd.save
             else {"a": jmx.nd.array(x), "b": jmx.nd.array(x[:1])})
        with open(fname, "rb") as f:
            buf = f.read()
        got = tmx.nd.load_frombuffer(buf, ctx=cpu)
        want = jmx.nd.load_frombuffer(buf)
        assert sorted(got) == sorted(want) == ["a", "b"]
        for k in got:
            np.testing.assert_array_equal(got[k].asnumpy(),
                                          want[k].asnumpy())


def test_download_returns_a_present_file_and_never_fetches(tmp_path):
    url = "https://example.com/data/weights.params"
    for pkg in (jmx, tmx):
        with pytest.raises(RuntimeError):
            pkg.gluon.utils.download(url, path=str(tmp_path))
    (tmp_path / "weights.params").write_bytes(b"abc")
    want = jmx.gluon.utils.download(url, path=str(tmp_path))
    assert tmx.gluon.utils.download(url, path=str(tmp_path)) == want
    sha = "a9993e364706816aba3e25717850c26c9cd0d89d"  # of b"abc"
    assert tmx.gluon.utils.download(url, path=str(tmp_path),
                                    sha1_hash=sha) == want
    for pkg in (jmx, tmx):
        with pytest.raises(RuntimeError):
            pkg.gluon.utils.download(url, path=str(tmp_path),
                                     sha1_hash="0" * 40)
        with pytest.raises(RuntimeError):
            pkg.gluon.utils.download(url, path=str(tmp_path),
                                     overwrite=True)


def test_debug_str_verbosity_empty_cache_and_symbol_grad():
    from mxnet_tpu.base import NameManager as JaxNameManager

    strs = []
    for pkg, scope, ctx in ((jmx, JaxNameManager, jmx.cpu()),
                            (tmx, tmx.name.NameManager, tmx.cpu())):
        with scope():
            net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
                pkg.sym.Variable("data"), num_hidden=3, name="fc"),
                name="softmax")
        ex = net.simple_bind(ctx, data=(2, 5), softmax_label=(2,))
        strs.append(ex.debug_str())
        init = pkg.init.Xavier()
        assert init.set_verbosity(True, print) is init
        assert (init._verbose, init._print_func) == (True, print)
        assert ctx.empty_cache() is None
        with pytest.raises(pkg.base.MXNetError, match="deprecated"):
            net.grad("data")
    assert strs[0] == strs[1]
    assert strs[1].startswith("Symbol outputs: softmax_output")

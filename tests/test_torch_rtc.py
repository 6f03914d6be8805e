"""rtc.CudaModule of the port on the CPU: the signature parser, every check
``launch`` makes before it touches CUDA, the lookup of libnvrtc, the
port's PallasModule error, and the plain versions of the three user
kernels under ``mxnet_tpu_torch/csrc/rtc`` against the JAX package's K5
(``mxnet_tpu.rtc.PallasModule`` running the same function as a Pallas
kernel, in interpret mode on the CPU).  The kernels themselves compile
and run only on the card (chip_smoke.py phase 7)."""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import _nvrtc, rtc
from mxnet_tpu_torch import nd as tnd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTC_DIR = os.path.join(REPO, "mxnet_tpu_torch", "csrc", "rtc")
CPU = tmx.cpu()
SGD_SIG = ("float *weight, const float *grad, float *mom, float lr, "
           "float momentum, float wd, float rescale_grad, "
           "float clip_gradient, int n")


@pytest.mark.parametrize("sig,want", [
    ("const float *x, float *y, float alpha",
     [(True, True, "float"), (True, False, "float"), (False, False, "float")]),
    ("const float *, double *, int",
     [(True, True, "float"), (True, False, "double"), (False, False, "int")]),
    ("__half *h, uint8_t u, int32_t  *  i, int8_t c, char d, int64_t n",
     [(True, False, "__half"), (False, False, "uint8_t"),
      (True, False, "int32_t"), (False, False, "int8_t"),
      (False, False, "char"), (False, False, "int64_t")]),
    (SGD_SIG, [(True, False, "float"), (True, True, "float"),
               (True, False, "float")] + [(False, False, "float")] * 5
     + [(False, False, "int")]),
])
def test_signature_parsing(sig, want):
    assert rtc.parse_signature(sig) == want


@pytest.mark.parametrize("sig,err", [
    ("const *x", ValueError), ("float **x", ValueError),
    ("float x y z", ValueError), ("const const float *x", ValueError),
    ("unsigned *x", TypeError), ("float16 *x", TypeError),
    ("float *x, size_t n", TypeError)])
def test_signature_errors(sig, err):
    with pytest.raises(err):
        rtc.parse_signature(sig)


@pytest.fixture()
def kernel(monkeypatch):
    """A CudaKernel of a module whose compile is skipped, with CUDA
    reported present: only the checks ``launch`` makes before CUDA run;
    reaching CUDA fails the test."""
    monkeypatch.setattr(_nvrtc, "compile_cubin",
                        lambda src, opts, exports: ("key", b"", {}, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def no_cuda(*args):
        raise AssertionError("launch reached CUDA")

    monkeypatch.setattr(_nvrtc, "load_function", no_cuda)
    mod = rtc.CudaModule(open(os.path.join(RTC_DIR, "axpy.cu")).read())
    return mod.get_kernel("axpy", "const float *x, float *y, float alpha, "
                                  "int n")


def _args(n=10, dtype="float32", ctx=CPU):
    return [tnd.ones((n,), ctx=ctx, dtype=dtype),
            tnd.zeros((n,), ctx=ctx), 3.0, n]


@pytest.mark.parametrize("case,match", [
    ("cpu context", "GPU context"),
    ("cpu array", "lies on cpu"),
    ("count", "expects 4 arguments but got 3"),
    ("dtype", "must have dtype float32, got float16"),
    ("non-contiguous", "not contiguous"),
    ("not an array", "must be an NDArray"),
    ("not a number", "must be a number"),
    ("threads", "1025 threads a block"),
    ("dims", "3 integers"),
    ("zero dim", "positive"),
])
def test_launch_errors(kernel, case, match):
    """Every refused launch raises MXNetError before anything reaches the
    card; a CPU context or a CPU array never falls back to a CPU path.
    The arrays lie on the CPU: the checks of kind, dtype and layout come
    before the check of the device."""
    args, ctx, grid, block = _args(), tmx.gpu(0), (1, 1, 1), (10, 1, 1)
    if case == "cpu context":
        ctx = CPU
    elif case == "count":
        args = args[:3]
    elif case == "dtype":
        args[0] = args[0].astype("float16")
    elif case == "non-contiguous":
        args[0] = tnd.NDArray(torch.ones(20)[::2])
    elif case == "not an array":
        args[1] = torch.zeros(10)
    elif case == "not a number":
        args[2] = tnd.ones((1,), ctx=CPU)
    elif case == "threads":
        block = (1025, 1, 1)
    elif case == "dims":
        grid = (1, 1)
    elif case == "zero dim":
        block = (0, 1, 1)
    with pytest.raises(tmx.MXNetError, match=match):
        kernel.launch(args, ctx, grid, block)
    assert rtc.CudaKernel.launches == 0


def test_launch_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(_nvrtc, "compile_cubin",
                        lambda src, opts, exports: ("key", b"", {}, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = rtc.CudaModule("").get_kernel("axpy", "float *y")
    with pytest.raises(tmx.MXNetError, match="no CUDA device"):
        k.launch([tnd.zeros((2,), ctx=CPU)], tmx.gpu(0), (1, 1, 1),
                 (2, 1, 1))


def test_options_and_exports(monkeypatch):
    seen = {}

    def fake(src, opts, exports):
        seen.update(opts=opts, exports=exports)
        return ("key", b"", {"ns::scale<float>": "_ZN2ns5scaleIfEEvPKT_PS1_S1_i"},
                "")

    monkeypatch.setattr(_nvrtc, "compile_cubin", fake)
    mod = rtc.CudaModule("src", exports=["ns::scale<float>"])
    assert "--gpu-architecture=sm_90a" in seen["opts"]
    assert "-std=c++17" in seen["opts"]
    assert seen["exports"] == ["ns::scale<float>"]
    k = mod.get_kernel("ns::scale<float>", "const float *x, float *y, "
                                           "float s, int n")
    assert k._symbol.startswith("_ZN2ns5scale") and k.name == "ns::scale<float>"
    assert mod.get_kernel("axpy", "float *y")._symbol == "axpy"
    rtc.CudaModule("src", options=["-arch=sm_90", "--std=c++14"])
    assert "--gpu-architecture=sm_90a" not in seen["opts"]
    assert "-std=c++17" not in seen["opts"]


def test_missing_nvrtc_names_the_paths(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvrtc, "_search_dirs", lambda: [str(tmp_path)])
    monkeypatch.setattr(_nvrtc, "_libs", {})
    monkeypatch.setattr(_nvrtc, "_compiled", {})
    with pytest.raises(tmx.MXNetError, match="no libnvrtc was found in: %s"
                       % tmp_path):
        rtc.CudaModule("extern \"C\" __global__ void f() {}")


def test_search_dirs_include_the_toolkit_and_torch():
    dirs = _nvrtc._search_dirs()
    assert os.path.join(os.path.dirname(torch.__file__), "lib") in dirs
    assert any(d.endswith(os.path.join("nvidia", "cuda_nvrtc", "lib"))
               for d in dirs)


def test_pallas_module_raises_naming_cuda_module():
    with pytest.raises(tmx.MXNetError, match="CudaModule"):
        rtc.PallasModule(lambda x_ref, o_ref: None, lambda x: x)
    # the JAX package raises the other way round
    with pytest.raises(jmx.MXNetError, match="PallasModule"):
        jmx.rtc.CudaModule("__global__ void axpy() {}")


def test_import_loads_no_cuda_library():
    code = textwrap.dedent("""
        import mxnet_tpu_torch.rtc, mxnet_tpu_torch._nvrtc as n
        maps = open("/proc/self/maps").read()
        assert "libnvrtc" not in maps and "libcuda.so" not in maps, maps
        assert n._libs == {}
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_hold_the_kernels():
    """The three user kernels are plain text for CudaModule, outside the
    csrc/*.cu that nvcc builds."""
    from mxnet_tpu_torch import _kernels

    names = sorted(os.listdir(RTC_DIR))
    assert names == ["axpy.cu", "scale_tmpl.cu", "sgd_mom.cu"]
    assert not any("rtc" in p for p in _kernels._sources())
    src = {n: open(os.path.join(RTC_DIR, n)).read() for n in names}
    assert 'extern "C" __global__ void axpy(' in src["axpy.cu"]
    assert 'extern "C" __global__ void sgd_mom(' in src["sgd_mom.cu"]
    assert "namespace ns" in src["scale_tmpl.cu"]
    assert not any(line.startswith("extern")
                   for line in src["scale_tmpl.cu"].splitlines())


# ----------------------------------------- plain versions against JAX's K5


def _pallas(kern, out_shape, *arrays):
    mod = jmx.rtc.PallasModule(kern, out_shape)
    return mod.get_kernel().launch([jmx.nd.array(a) for a in arrays]) \
        .asnumpy()


def test_axpy_plain_matches_pallas():
    rng = np.random.RandomState(0)
    x, y = rng.randn(2, 4, 4, 8).astype(np.float32), \
        rng.randn(2, 4, 4, 8).astype(np.float32)
    alpha = 3.0

    def kern(x_ref, y_ref, o_ref):
        o_ref[...] = y_ref[...] + alpha * x_ref[...]

    want = _pallas(kern, lambda x, y: jax.ShapeDtypeStruct(y.shape, y.dtype),
                   x, y)
    got = (tnd.array(y, ctx=CPU) + alpha * tnd.array(x, ctx=CPU)).asnumpy()
    # XLA may fuse the product and the sum into one FMA: one rounding apart
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scale_plain_matches_pallas():
    x = np.random.RandomState(1).randn(64).astype(np.float32)

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.5

    want = _pallas(kern, lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), x)
    np.testing.assert_array_equal((tnd.array(x, ctx=CPU) * 2.5).asnumpy(),
                                  want)


@pytest.mark.parametrize("clip", [-1.0, 0.5])
def test_sgd_mom_plain_matches_pallas_and_jax(clip):
    """mx.nd.sgd_mom_update (the plain version of sgd_mom.cu) against the
    same arithmetic as a Pallas kernel through the JAX package's
    PallasModule, and against the JAX package's mx.nd.sgd_mom_update."""
    rng = np.random.RandomState(2)
    w, g, m = (rng.randn(256).astype(np.float32) for _ in range(3))
    hp = dict(lr=0.1, momentum=0.9, wd=1e-4, rescale_grad=0.5,
              clip_gradient=clip)

    def kern(w_ref, g_ref, m_ref, o_ref):
        gg = hp["rescale_grad"] * g_ref[...]
        if clip >= 0:
            gg = jax.numpy.clip(gg, -clip, clip)
        gg = gg + hp["wd"] * w_ref[...]
        mom = hp["momentum"] * m_ref[...] - hp["lr"] * gg
        o_ref[0, :] = mom
        o_ref[1, :] = w_ref[...] + mom

    want_m, want_w = _pallas(
        kern, lambda w, g, m: jax.ShapeDtypeStruct((2,) + w.shape, w.dtype),
        w, g, m)
    jw, jm = jmx.nd.sgd_mom_update(jmx.nd.array(w), jmx.nd.array(g),
                                   jmx.nd.array(m), **hp)
    tw, tm = tnd.array(w, ctx=CPU), tnd.array(m, ctx=CPU)
    out = tnd.sgd_mom_update(tw, tnd.array(g, ctx=CPU), tm, **hp)
    assert out is tw  # updated in place, as MXNet's out=weight
    for got, want in ((tw, want_w), (tm, want_m), (tw, jw.asnumpy()),
                      (tm, jm.asnumpy())):
        np.testing.assert_allclose(got.asnumpy(), want, rtol=1e-6,
                                   atol=1e-7)

"""rtc.CudaModule of the port on the CPU: the signature parser, every check
``launch`` makes before it touches CUDA, the lookup of libnvrtc, the
port's PallasModule error, and the plain versions of the three user
kernels under ``mxnet_tpu_torch/csrc/rtc`` against the JAX package's K5
(``mxnet_tpu.rtc.PallasModule`` running the same function as a Pallas
kernel, in interpret mode on the CPU).  The kernels themselves compile
and run only on the card (chip_smoke.py phase 7)."""

import ctypes
import os
import struct
import subprocess
import sys
import textwrap
import threading

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


# ------------------------------------------------- K5's launch template

# each C type as a ctypes member of a struct (a __half as its 16 bits)
_CTYPES = {"float": ctypes.c_float, "double": ctypes.c_double,
           "__half": ctypes.c_uint16, "uint8_t": ctypes.c_uint8,
           "int": ctypes.c_int32, "int32_t": ctypes.c_int32,
           "int8_t": ctypes.c_int8, "char": ctypes.c_int8,
           "int64_t": ctypes.c_int64}


def _structure(params):
    fields = [("a%d" % i, ctypes.c_void_p if is_ptr else _CTYPES[t])
              for i, (is_ptr, _c, t) in enumerate(params)]
    return type("Args", (ctypes.Structure,), {"_fields_": fields})


def _ctypes_bytes(params, values):
    """The bytes of each argument as the per-argument ctypes objects of
    the earlier launch path held them: a c_void_p of the data pointer, a
    scalar through numpy's cast to the C type."""
    out = []
    for (is_ptr, _c, t), v in zip(params, values):
        if is_ptr:
            out.append(bytes(ctypes.c_void_p(v)))
        else:
            ndt = rtc._C_TYPES[t][1]
            out.append(bytes(_CTYPES[t].from_buffer_copy(
                np.array(v, ndt).tobytes())))
    return out


@pytest.mark.parametrize("sig", [
    "float a", "double a", "__half a", "uint8_t a", "int a", "int32_t a",
    "int8_t a", "char a", "int64_t a", "const float *p",
    "int a, int64_t b",                       # 4 bytes of padding
    "char c, __half h, double d, int8_t i",   # padding before h and d
    "__half *h, uint8_t u, int32_t *i, int8_t c, char d, int64_t n",
    "uint8_t a, __half b, float c",
    SGD_SIG,
])
def test_launch_template_lays_out_a_c_struct(sig):
    """Offsets, size and bytes of the argument block equal a
    ctypes.Structure of the same C types."""
    params = rtc.parse_signature(sig)
    tmpl = rtc.launch_template(params)
    st = _structure(params)
    assert tmpl.offsets == tuple(getattr(st, f).offset
                                 for f, _ in st._fields_)
    assert tmpl.size == ctypes.sizeof(st)
    rng = np.random.RandomState(len(sig))
    values = []
    for is_ptr, _c, t in params:
        if is_ptr:
            values.append(int(rng.randint(1, 2 ** 40)) * 256)
        elif t in ("float", "double", "__half"):
            values.append(float(rng.randn()))
        else:
            values.append(int(rng.randint(0, 100)))
    block = struct.pack(tmpl.format, *values)
    ref = st(*[v if is_ptr else _CTYPES[t].from_buffer_copy(
        np.array(v, rtc._C_TYPES[t][1]).tobytes()).value
        for v, (is_ptr, _c, t) in zip(values, params)])
    assert block == bytes(ref)


@pytest.fixture()
def sgd_kernel(monkeypatch):
    monkeypatch.setattr(_nvrtc, "compile_cubin",
                        lambda src, opts, exports: ("key", b"", {}, ""))
    mod = rtc.CudaModule(open(os.path.join(RTC_DIR, "sgd_mom.cu")).read())
    return mod.get_kernel("sgd_mom", SGD_SIG)


@pytest.mark.parametrize("scalars", [
    (0.1, 0.9, 1e-4, 1.0, -1.0, 25_575_912),                # the main path's
    (np.float32(0.1), np.float64(0.9), 1, True, -1, np.int64(7)),
    (1e39, -1e-46, 3.0000001, 2.0 ** -149, float("inf"), 7.9),  # numpy casts
])
def test_sgd_mom_block_equals_the_per_argument_ctypes_bytes(sgd_kernel,
                                                           scalars):
    """The packed block of sgd_mom's 9 arguments holds, at each argument's
    offset, the bytes of the earlier path's ctypes object: the same float
    rounding, the same cast of a float to an int, inf past float32."""
    values = [0x7F00_0000_1000, 0x7F00_0020_0000, 0x7F00_0040_0000,
              *scalars]
    ptrs = sgd_kernel._pack(values)
    params = sgd_kernel._params
    with np.errstate(over="ignore"):
        want = _ctypes_bytes(params, values)
    for p, w in zip(ptrs, want):
        assert ctypes.string_at(p, len(w)) == w
    tmpl = sgd_kernel.template
    assert list(ptrs) == [ctypes.addressof(sgd_kernel._block.buf) + o
                          for o in tmpl.offsets]
    assert tmpl.size == 48 and tmpl.offsets[3:] == (24, 28, 32, 36, 40, 44)


def test_half_scalars_round_as_numpy():
    k = rtc.CudaKernel(None, "f", "f", rtc.parse_signature("__half h"))
    for v in (1.0, 2049.0, 2051.0, 1e-8, 6e-8, -0.0, 65504.0, 65520.0,
              1e6, float("nan"), float("-inf"), 0.333333):
        with np.errstate(over="ignore"):
            want = np.array(v, np.float16).tobytes()
        assert ctypes.string_at(k._pack([v])[0], 2) == want, v


def test_each_thread_packs_its_own_block(sgd_kernel):
    mine = ctypes.addressof(sgd_kernel._block.buf)
    seen = []
    t = threading.Thread(target=lambda: seen.append(
        ctypes.addressof(sgd_kernel._block.buf)))
    t.start()
    t.join()
    assert seen and seen[0] != mine


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
def test_launch_errors_after_the_device_is_cached(kernel, monkeypatch, case,
                                                  match):
    """With gpu(0)'s device and function already kept from an earlier
    launch (the fast path), every refused launch raises the same message
    and the driver is never called."""
    def no_driver(*args):
        raise AssertionError("launch reached the driver")

    monkeypatch.setattr(_nvrtc, "launch", no_driver)
    kernel._resolved[tmx.gpu(0)] = (0, ctypes.c_void_p(1))
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
    before = rtc.CudaKernel.launches
    with pytest.raises(tmx.MXNetError, match=match):
        kernel.launch(args, ctx, grid, block)
    assert rtc.CudaKernel.launches == before


def test_a_launch_resolves_once_and_passes_the_packed_block(monkeypatch):
    """The first launch at a ctx checks everything and loads the function;
    later ones reuse both, pack the block and hand the driver its
    void*[] with the current stream."""
    monkeypatch.setattr(_nvrtc, "compile_cubin",
                        lambda src, opts, exports: ("key", b"", {}, ""))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 77}))
    monkeypatch.setattr(_nvrtc, "current_stream", lambda index: 77)
    loads, calls = [], []
    monkeypatch.setattr(_nvrtc, "load_function", lambda *a: (
        loads.append(a), ctypes.c_void_p(0x1234))[1])

    def fake_launch(func, device, grid, block, smem, stream, params):
        calls.append((func.value, device, tuple(grid), tuple(block), smem,
                      stream,
                      [ctypes.string_at(params[i], n)
                       for i, n in enumerate((4, 8, 2))]))

    monkeypatch.setattr(_nvrtc, "launch", fake_launch)
    k = rtc.CudaModule("src").get_kernel("f", "int n, int64_t m, __half h")
    before = rtc.CudaKernel.launches
    k.launch([3, 2 ** 40, 1.5], tmx.gpu(0), (2, 1, 1), (32, 1, 1))
    k.launch([4, -1, 2.0], tmx.gpu(0), [5, 1, 1], [64, 2, 1], 100)
    assert len(loads) == 1 and rtc.CudaKernel.launches == before + 2
    assert calls[0][:6] == (0x1234, 0, (2, 1, 1), (32, 1, 1), 0, 77)
    assert calls[1][:6] == (0x1234, 0, (5, 1, 1), (64, 2, 1), 100, 77)
    assert calls[0][6] == [struct.pack("<i", 3), struct.pack("<q", 2 ** 40),
                           np.float16(1.5).tobytes()]
    assert calls[1][6] == [struct.pack("<i", 4), struct.pack("<q", -1),
                           np.float16(2.0).tobytes()]


def test_checker_returns_the_block_values_or_none(sgd_kernel):
    """The checker written out for sgd_mom's signature: the data pointers
    and the scalars as given where every check passes (CPU arrays at
    device index -1), None where one fails."""
    w, g, m = (tnd.ones((8,), ctx=CPU) for _ in range(3))
    scalars = [0.1, 0.9, 1e-4, 1.0, -1.0, 8]
    got = sgd_kernel._values([w, g, m] + scalars, -1)
    assert got == tuple([a.data_torch.data_ptr() for a in (w, g, m)]
                        + scalars)
    assert sgd_kernel._values([w, g, m] + scalars, 0) is None  # the device
    assert sgd_kernel._values([w, g, m] + scalars[:-1], -1) is None
    assert sgd_kernel._values([w, g, m.astype("float16")] + scalars,
                              -1) is None
    assert sgd_kernel._values([w, g, m, "0.1"] + scalars[1:], -1) is None


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("grid,block", [
    ((2.5, 1, 1), (32, 1, 1)),
    ((1, 1, 1), (32, 1.0, 1)),
    ((1, 1, 1), ("32", 1, 1)),
])
def test_a_dimension_that_is_not_an_integer_is_refused(kernel, monkeypatch,
                                                       cached, grid, block):
    """A fractional or non-numeric dimension raises the "3 integers" error
    on both paths; it is never cut to an integer and launched.  The cached
    case keeps device index -1, so that the CPU arrays pass the checker
    and only the dimensions stand between the call and the driver."""
    def no_driver(*args):
        raise AssertionError("launch reached the driver")

    monkeypatch.setattr(_nvrtc, "launch", no_driver)
    if cached:
        kernel._resolved[tmx.gpu(0)] = (-1, ctypes.c_void_p(1))
    before = rtc.CudaKernel.launches
    with pytest.raises(tmx.MXNetError, match="3 integers"):
        kernel.launch(_args(), tmx.gpu(0), grid, block)
    assert rtc.CudaKernel.launches == before


@pytest.mark.parametrize("rc,current,pushed", [
    (0, 0x99, False),   # the primary context is current: launched as is
    (0, 0x55, True),    # another context is current
    (0, None, True),    # no context is current
    (201, 0x99, True),  # the query failed: its slot says nothing
])
def test_the_primary_context_is_pushed_unless_it_is_current(monkeypatch, rc,
                                                            current, pushed):
    events = []

    class Driver:
        def cuCtxPushCurrent_v2(self, ctx):
            events.append(("push", ctx.value))
            return 0

        def cuCtxPopCurrent_v2(self, out):
            events.append(("pop",))
            return 0

    def get_current(slot):
        slot.contents.value = current
        return rc

    def launch_kernel(*args):
        events.append(("launch", args[1:7]))
        return 0

    monkeypatch.setattr(_nvrtc, "_calls", (get_current, launch_kernel))
    monkeypatch.setattr(_nvrtc, "_cuda", Driver)
    monkeypatch.setitem(_nvrtc._contexts, 0, ctypes.c_void_p(0x99))
    _nvrtc.launch(ctypes.c_void_p(1), 0, (3, 1, 1), (32, 1, 1), 0, 0, None)
    launched = ("launch", (3, 1, 1, 32, 1, 1))
    assert events == ([("push", 0x99), launched, ("pop",)] if pushed
                      else [launched])

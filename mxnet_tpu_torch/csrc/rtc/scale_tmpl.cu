// y[i] = x[i] * s for any element type T: a templated kernel in a
// namespace, which has no extern "C" name.  mxnet_tpu_torch.rtc.CudaModule
// reaches it only through exports=["ns::scale<float>"]: NVRTC instantiates
// the name expression and gives its lowered (mangled) name, which the
// module looks up.  Its plain version is x * s.
//
// A user's kernel for rtc.CudaModule (compiled from this text through NVRTC
// for sm_90a); the facility replaces the JAX package's PallasModule
// (mxnet_tpu/rtc.py:67, K5).
//
// Bound: bytes (x read once, y written once).  Design: one element per
// thread in a grid-stride loop with a 64-bit index.
namespace ns {

template <typename T>
__global__ void scale(const T *x, T *y, T s, int n) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] = x[i] * s;
  }
}

}  // namespace ns

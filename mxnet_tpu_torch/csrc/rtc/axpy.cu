// y[i] += alpha * x[i]: MXNet's documented rtc.CudaModule example
// (python/mxnet/rtc.py), with an element count n so that any size is safe.
//
// A user's kernel for mxnet_tpu_torch.rtc.CudaModule, which compiles this
// file as text through NVRTC for sm_90a; it is not built by nvcc with the
// kernels under csrc/.  The facility replaces the JAX package's
// PallasModule (mxnet_tpu/rtc.py:67, K5).
//
// Bound: bytes.  x and y are read once and y written once, 12 bytes an
// element, against 2 flops: at 3.35 TB/s, (128, 112, 112, 64) floats take
// 0.368 ms.  Design: one element per thread in a grid-stride loop, neighbour
// threads on neighbour addresses (coalesced 4-byte accesses); the index is
// 64-bit so that the stride never overflows.
extern "C" __global__ void axpy(const float *x, float *y, float alpha, int n) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    y[i] += alpha * x[i];
  }
}

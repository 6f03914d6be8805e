// A user's fused SGD-momentum update of one parameter tensor, in place,
// with MXNet's arithmetic (src/operator/optimizer_op.cc sgd_mom_update):
//   g = rescale_grad * grad, clipped to [-clip_gradient, clip_gradient]
//       when clip_gradient >= 0;  g += wd * weight;
//   mom = momentum * mom - lr * g;  weight += mom.
// Its plain version is mxnet_tpu_torch.ops.optimizer_ops.sgd_mom_update
// (mx.nd.sgd_mom_update); NVRTC may contract a product and a sum into one
// FMA, so the two agree to a rounding, not bit for bit.
//
// A user's kernel for mxnet_tpu_torch.rtc.CudaModule (compiled from this
// text through NVRTC for sm_90a, one launch per tensor); the facility
// replaces the JAX package's PallasModule (mxnet_tpu/rtc.py:67, K5).
//
// Bound: bytes.  weight, grad and mom are read once, weight and mom written
// once: 20 bytes an element.  Design: one element per thread in a
// grid-stride loop with a 64-bit index; a small tensor is one small launch,
// so an update of many small tensors is bound by the host's launches, not by
// the card.  It stays scalar: ResNet-50's 193-tensor update, captured in a
// CUDA graph on an H100 SXM, took 0.470 ms of device time with it and
// 0.478 ms with 16-byte loads of four elements a thread (its bound is
// 0.153 ms); each launch's fixed cost in the graph, about 2.4 us, sets it,
// not the loads.
extern "C" __global__ void sgd_mom(float *weight, const float *grad,
                                   float *mom, float lr, float momentum,
                                   float wd, float rescale_grad,
                                   float clip_gradient, int n) {
  const long long stride = (long long)blockDim.x * gridDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float w = weight[i];
    float g = rescale_grad * grad[i];
    if (clip_gradient >= 0.0f) {
      g = fminf(fmaxf(g, -clip_gradient), clip_gradient);
    }
    g = g + wd * w;
    const float m = momentum * mom[i] - lr * g;
    mom[i] = m;
    weight[i] = w + m;
  }
}

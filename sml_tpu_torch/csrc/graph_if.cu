// CUDA-graph IF nodes for the fused programs (train/graphs.py step_if).
//
// Not a port of a TPU kernel: the JAX package's scan_epoch skips an
// epoch's tail batches with lax.cond inside one compiled program; the port
// captures each step slot as the body of an IF node whose condition a
// one-thread kernel sets from a bool on the device, so one captured graph
// serves every period whatever its batch count. PyTorch 2.11 has no
// binding for conditional nodes (CUDAGraph.begin_capture_to_if_node came
// later), so the port makes them with the CUDA runtime (12.4 or later):
//
//   sml_if_begin(parent, body, pred, mode): on the capturing stream
//     `parent`, create a conditional handle on its graph, capture the
//     kernel that sets it from *pred, add the IF node after the stream's
//     current dependencies, make it the stream's only dependency, and
//     begin capturing stream `body` into the node's body graph;
//   sml_if_end(body): end that capture.
//
// Both return a cudaError_t (0 on success).

#include <cuda_runtime.h>

__global__ void sml_set_if_kernel(cudaGraphConditionalHandle handle,
                                  const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

extern "C" int sml_if_begin(void* parent, void* body, const void* pred,
                            int mode) {
  cudaStream_t ps = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph,
                                           &deps, &n_deps);
  if (e != cudaSuccess) return e;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return e;
  sml_set_if_kernel<<<1, 1, 0, ps>>>(handle, static_cast<const bool*>(pred));
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaStreamGetCaptureInfo(ps, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int sml_if_end(void* body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph);
}

// K9 — the split loop's condition, and the one-launch device loop it
// drives (sm_90a, CUDA 12.4+ conditional graph nodes).
//
//   go = k < limit && !stop          (stop may be null: never)
//   cudaGraphSetConditional(handle, go)
//
// Replaces no TPU kernel: the JAX package runs a whole split as one
// lax.while_loop whose condition `(epoch < limit) & ~stop` XLA evaluates
// on the device (acmgnn_tpu/train/trainer.py:296-298, :414-416).  CUDA
// graphs have no while loop of their own through PyTorch, so
// `acm_k9_loop_build` builds one around the captured loop body (a
// cudaGraph_t from torch.cuda.CUDAGraph(keep_graph=True)):
//
//   outer graph:  [K9 prologue] -> [while node: handle]
//   while body:   [child graph: the captured epoch] -> [K9]
//
// The prologue sets the condition before the first body (a segment that
// starts at its limit, or after a stop, runs none); K9 after each body
// reads the counter the body just advanced and the stop flag it just
// wrote.  One cudaGraphLaunch then runs the split (or the segment) to its
// end with no host read; the host reads k once afterwards.  k, limit and
// stop are device int64 / int64 / bool scalars the body and its caller
// update in place.  The child graph node clones the captured graph: the
// captured graph's private memory pool (torch's) must outlive the exec.
//
// What bounds K9: one thread reads 17 bytes; its cost is a launch inside
// the graph, which chip_smoke.py phase 12 times per iteration of a loop
// of empty bodies.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void loop_cond_kernel(cudaGraphConditionalHandle handle,
                                 const int64_t* k, const int64_t* limit,
                                 const bool* stop) {
  const bool go = *k < *limit && !(stop != nullptr && *stop);
  cudaGraphSetConditional(handle, go ? 1u : 0u);
}

int kernel_node(cudaGraphNode_t* node, cudaGraph_t graph,
                const cudaGraphNode_t* dep, size_t n_dep,
                cudaGraphConditionalHandle* handle, const int64_t** k,
                const int64_t** limit, const bool** stop) {
  void* args[] = {handle, k, limit, stop};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_cond_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  return static_cast<int>(cudaGraphAddKernelNode(node, graph, dep, n_dep, &p));
}

}  // namespace

// Builds and instantiates the outer graph around `inner` (a cudaGraph_t);
// returns the exec and the outer graph through the out pointers.
extern "C" int acm_k9_loop_build(void* inner, const void* k,
                                 const void* limit, const void* stop,
                                 void** exec_out, void** graph_out) {
  cudaGraph_t outer = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t prologue, loop, child, tail;
  auto kp = static_cast<const int64_t*>(k);
  auto lp = static_cast<const int64_t*>(limit);
  auto sp = static_cast<const bool*>(stop);
  int rc = static_cast<int>(cudaGraphCreate(&outer, 0));
  if (rc) return rc;
  rc = static_cast<int>(
      cudaGraphConditionalHandleCreate(&handle, outer, 0, 0));
  if (!rc) rc = kernel_node(&prologue, outer, nullptr, 0, &handle, &kp, &lp,
                            &sp);
  cudaGraph_t body = nullptr;
  if (!rc) {
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    rc = static_cast<int>(cudaGraphAddNode(&loop, outer, &prologue, 1, &cp));
    if (!rc) body = cp.conditional.phGraph_out[0];
  }
  if (!rc)
    rc = static_cast<int>(cudaGraphAddChildGraphNode(
        &child, body, nullptr, 0, static_cast<cudaGraph_t>(inner)));
  if (!rc) rc = kernel_node(&tail, body, &child, 1, &handle, &kp, &lp, &sp);
  if (!rc) rc = static_cast<int>(cudaGraphInstantiate(&exec, outer, 0));
  if (rc) {
    cudaGraphDestroy(outer);
    return rc;
  }
  *exec_out = exec;
  *graph_out = outer;
  return 0;
}

extern "C" int acm_k9_loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int acm_k9_loop_destroy(void* exec, void* graph) {
  cudaError_t a = cudaSuccess, b = cudaSuccess;
  if (exec != nullptr) a = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) b = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return static_cast<int>(a != cudaSuccess ? a : b);
}

// The node types (cudaGraphNodeType values) of `graph`, in the order
// cudaGraphGetNodes gives them, child graphs' nodes after a -1 marker and
// closed by -2; up to `cap` entries, the count through `n_out`.
extern "C" int acm_k9_node_types(void* graph, int* types, int cap,
                                 int* n_out) {
  size_t n = 0;
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  int rc = static_cast<int>(cudaGraphGetNodes(g, nullptr, &n));
  if (rc) return rc;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n > 0 ? n : 1];
  rc = static_cast<int>(cudaGraphGetNodes(g, nodes, &n));
  int m = *n_out;
  for (size_t i = 0; !rc && i < n; ++i) {
    cudaGraphNodeType t;
    rc = static_cast<int>(cudaGraphNodeGetType(nodes[i], &t));
    if (rc) break;
    if (m < cap) types[m] = static_cast<int>(t);
    ++m;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t sub = nullptr;
      rc = static_cast<int>(cudaGraphChildGraphNodeGetGraph(nodes[i], &sub));
      if (rc) break;
      if (m < cap) types[m] = -1;
      ++m;
      *n_out = m;
      rc = acm_k9_node_types(sub, types, cap, n_out);
      m = *n_out;
      if (m < cap) types[m] = -2;
      ++m;
    }
  }
  delete[] nodes;
  *n_out = m;
  return rc;
}

extern "C" const char* acm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

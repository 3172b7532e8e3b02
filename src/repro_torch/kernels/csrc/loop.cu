// The device-side round loop: a CUDA graph whose one conditional WHILE
// node replays a captured round body until the loop condition drops, so a
// chunk of rounds runs with no host round trip (CUDA 12.4 or later).
//
// Replaces the chunk loop of the reference's fused engine,
// src/repro/runtime/enginecore.py: fused_loop (a lax.while_loop).  Its
// condition is the reference's: a round runs while
//
//     occ > 0  &&  !oflow  &&  rounds < limit  [&&  !stop],
//
// read from four device words the round body keeps up to date (the
// occupancy, the overflow flag, the chunk's round count) and the chunk's
// limit, which the host writes before each launch.  The fifth word is
// optional (a null pointer leaves it out): a one-byte stop flag that the
// engine's round sets, the reference's ``_extra_cond`` hook.  The serving
// admission engine sets it at the first admission stall, which ends its
// tick inside the graph with no host round trip.  The loop never writes
// it: the engine clears it between chunks.  WHILE tests its condition
// before the first iteration, so the graph is
//
//     loop_init  ->  WHILE { body (a child graph)  ->  loop_cond }
//
// loop_init zeroes the chunk's round count and overflow flag and sets the
// condition; loop_cond, the body's last node, sets it again.  Both are
// one thread: the loop is a chain of dependent rounds, and what bounds it
// is the latency of the body's kernels, not these.
//
// The body is a graph captured by PyTorch (torch.cuda.graph, its own
// private memory pool), added as a child graph node: its kernels read and
// write the buffers it was captured on.  A conditional body may hold
// kernel, memcpy, memset, empty, child-graph and conditional nodes only;
// in particular no memory allocation nodes and no host nodes, so the body
// reads nothing back.
#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

__device__ __forceinline__ unsigned int loop_live(const int32_t* occ,
                                                  const uint8_t* oflow,
                                                  const int32_t* rounds,
                                                  const int32_t* limit,
                                                  const uint8_t* stop) {
  return (*occ > 0 && *oflow == 0 && *rounds < *limit &&
          (stop == nullptr || *stop == 0))
             ? 1u
             : 0u;
}

__global__ void loop_init(cudaGraphConditionalHandle handle,
                          const int32_t* occ, uint8_t* oflow,
                          int32_t* rounds, const int32_t* limit,
                          const uint8_t* stop) {
  *rounds = 0;
  *oflow = 0;
  cudaGraphSetConditional(handle, loop_live(occ, oflow, rounds, limit, stop));
}

__global__ void loop_cond(cudaGraphConditionalHandle handle,
                          const int32_t* occ, const uint8_t* oflow,
                          const int32_t* rounds, const int32_t* limit,
                          const uint8_t* stop) {
  cudaGraphSetConditional(handle,
                          loop_live(occ, oflow, rounds, limit, stop));
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph,
                       const cudaGraphNode_t* deps, size_t ndeps, void* fn,
                       void** args) {
  cudaKernelNodeParams kp = {};
  kp.func = fn;
  kp.gridDim = dim3(1, 1, 1);
  kp.blockDim = dim3(1, 1, 1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &kp);
}

}  // namespace repro

// body: the cudaGraph_t of the captured round (kept alive by its owner
// while the loop exists; the loop holds a copy of its nodes).  occ,
// rounds, limit: (1,) int32 device words; oflow: (1,) bool; stop: a bool
// device word, or null for a loop with no stop flag.  Writes the
// executable graph to *exec_out and its graph to *graph_out.  Returns a
// cudaError_t (0 on success).
extern "C" int repro_loop_create(void* body, const void* occ, void* oflow,
                                 void* rounds, const void* limit,
                                 const void* stop, void** graph_out,
                                 void** exec_out) {
  using namespace repro;
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  cudaError_t e = cudaGraphCreate(&graph, 0);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaGraphConditionalHandle handle;
  cudaGraphNode_t init = nullptr, loop = nullptr, child = nullptr,
                  cond = nullptr;
  cudaGraph_t inner = nullptr;
  do {
    e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (e != cudaSuccess) break;
    void* init_args[] = {&handle, const_cast<void**>(&occ), &oflow, &rounds,
                         const_cast<void**>(&limit),
                         const_cast<void**>(&stop)};
    e = add_kernel(&init, graph, nullptr, 0,
                   reinterpret_cast<void*>(loop_init), init_args);
    if (e != cudaSuccess) break;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeWhile;
    cp.conditional.size = 1;
    e = cudaGraphAddNode(&loop, graph, &init, 1, &cp);
    if (e != cudaSuccess) break;
    inner = cp.conditional.phGraph_out[0];
    e = cudaGraphAddChildGraphNode(&child, inner, nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
    if (e != cudaSuccess) break;
    void* cond_args[] = {&handle, const_cast<void**>(&occ), &oflow, &rounds,
                         const_cast<void**>(&limit),
                         const_cast<void**>(&stop)};
    e = add_kernel(&cond, inner, &child, 1,
                   reinterpret_cast<void*>(loop_cond), cond_args);
    if (e != cudaSuccess) break;
    e = cudaGraphInstantiate(&exec, graph, 0);
  } while (false);
  if (e != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(e);
  }
  *graph_out = graph;
  *exec_out = exec;
  return 0;
}

// Launches the loop on `stream` (asynchronous).  Returns a cudaError_t.
extern "C" int repro_loop_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

// Frees the loop's executable graph and graph.
extern "C" int repro_loop_destroy(void* graph, void* exec) {
  cudaError_t e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  const cudaError_t f = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
  return static_cast<int>(e != cudaSuccess ? e : f);
}

// The device program-counter machine of a conditional task graph: one CUDA
// graph with a WHILE node around one IF node per basic block.
//
// Replaces no TPU kernel. It is the mechanism of JaxGraph's PC machine in
// src/repro/core/jaxgraph.py (`_lower_pc`): `lax.while_loop` (:274) around
// `lax.switch` over the basic blocks (:271), which XLA compiles into one
// device program. Its plain version is `CondGraph.lower()`
// (src/repro_torch/core/condgraph.py), the same machine driven from the
// host, which reads each condition's index back to pick the next block.
//
// What bounds it on the H100: the blocks' own work, plus per iteration the
// two single-thread control kernels below and the device-side scheduling
// of the conditional nodes (a few microseconds, no host round trip). A
// loop of k iterations needs no unrolling: the program holds the same
// nodes for any k.
//
// Design:
//   outer graph:  init kernel -> WHILE(loop)
//   WHILE body:   dispatch kernel -> IF(b) for every block b -> advance
//   IF(b) body:   one child-graph node holding block b's graph, captured
//                 by torch (its kernels, copies and memsets; it copies its
//                 outputs back into the static state and, for a condition
//                 task, its successor index into ctrl[2])
// ctrl = (pc, blocks run, condition index, spare), int64 on the device (the
// index as the task computed it, any integer).
// init sets pc to the start block and the loop's condition; dispatch opens
// exactly the IF node of block pc; advance maps (pc, index) through the
// successor table (an index out of [0, k) or a STOP successor ends the
// machine at stop_pc = nblocks), counts the block and keeps the loop open
// while pc < stop_pc and blocks run < max_iters. The IF nodes hang side by
// side between dispatch and advance; one of them runs. Each control kernel
// is one thread: it only reads and writes a few integers and calls
// cudaGraphSetConditional. The IF nodes' handles reach dispatch by value
// (at most kMaxBlocks of them), so building the program copies nothing to
// the device.
//
// Nesting (a DeviceFlow that holds a compiled CondGraph): the same init ->
// WHILE pair is built into the graph that a stream is capturing, after the
// capture's current dependencies (cudaStreamGetCaptureInfo), with its
// handles created on that graph, and the capture continues after the WHILE
// node (cudaStreamUpdateCaptureDependencies). The outer graph's replay
// then runs the whole loop on the device. Nothing is launched: no
// cudaGraphLaunch is issued inside a capture.
//
// Conditional nodes need CUDA 12.4 (runtime and driver); with an older
// toolkit the entry points compile to stubs that return
// cudaErrorNotSupported, and the wrapper raises. A conditional body may
// hold kernel, memcpy, memset, empty, child-graph and conditional nodes
// only: repro_cond_graph_check names the first node of a block graph that
// is none of these, and the wrapper refuses the block with its tasks.
#include <vector>

#include <cuda_runtime.h>

#if CUDART_VERSION >= 12040

namespace {

__global__ void cg_init(long long* ctrl, int start, int stop_pc,
                        int max_iters,
                        cudaGraphConditionalHandle loop) {
  ctrl[0] = start;
  ctrl[1] = 0;
  ctrl[2] = 0;
  cudaGraphSetConditional(loop, (start < stop_pc && max_iters > 0) ? 1 : 0);
}

constexpr int kMaxBlocks = 256;

struct IfHandles {
  cudaGraphConditionalHandle h[kMaxBlocks];
};

__global__ void cg_dispatch(const long long* ctrl, IfHandles ifs, int n) {
  const long long pc = ctrl[0];
  for (int b = 0; b < n; ++b) cudaGraphSetConditional(ifs.h[b], pc == b);
}

// succ: (nblocks, width) successor pcs; meta: (nblocks, 2) = (k, is_cond)
__global__ void cg_advance(long long* ctrl, const int* succ, const int* meta,
                           int width, int stop_pc, int max_iters,
                           cudaGraphConditionalHandle loop) {
  const int pc = (int)ctrl[0];
  const int k = meta[2 * pc];
  const long long idx = meta[2 * pc + 1] ? ctrl[2] : 0;
  const int next = (idx >= 0 && idx < k) ? succ[pc * width + idx] : stop_pc;
  const long long it = ctrl[1] + 1;
  ctrl[0] = next;
  ctrl[1] = it;
  cudaGraphSetConditional(loop, (next < stop_pc && it < max_iters) ? 1 : 0);
}

struct Program {
  cudaGraph_t outer = nullptr;
  cudaGraphExec_t exec = nullptr;
  int device = 0;
  long long nodes = 0;   // counted while building, through every body
  // what build() needs again to nest the program into a capture
  std::vector<cudaGraph_t> blocks;
  int start = 0, max_iters = 0, width = 0;
  long long* ctrl = nullptr;
  const int* succ = nullptr;
  const int* meta = nullptr;
};

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t g,
                     const cudaGraphNode_t* deps, size_t ndeps,
                     cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, deps, nullptr, ndeps, p);
#else
  return cudaGraphAddNode(node, g, deps, ndeps, p);
#endif
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t g,
                       const cudaGraphNode_t* deps, size_t ndeps,
                       void* fn, void** args) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeKernel;
  p.kernel.func = fn;
  p.kernel.gridDim = dim3(1, 1, 1);
  p.kernel.blockDim = dim3(1, 1, 1);
  p.kernel.sharedMemBytes = 0;
  p.kernel.kernelParams = args;
  return add_node(node, g, deps, ndeps, &p);
}

// Adds a conditional node of `type` and returns its body graph.
cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t g,
                            const cudaGraphNode_t* deps, size_t ndeps,
                            cudaGraphConditionalHandle h,
                            cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = type;
  p.conditional.size = 1;
  cudaError_t err = add_node(node, g, deps, ndeps, &p);
  if (err == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return err;
}

cudaError_t nodes_of(cudaGraph_t g, std::vector<cudaGraphNode_t>* out) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return err;
  out->resize(n);
  return n ? cudaGraphGetNodes(g, out->data(), &n) : cudaSuccess;
}

// The type of the first node (depth first, through child graphs) that a
// conditional body cannot hold, or -1.
cudaError_t first_bad(cudaGraph_t g, int* bad) {
  std::vector<cudaGraphNode_t> nodes;
  cudaError_t err = nodes_of(g, &nodes);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t n : nodes) {
    cudaGraphNodeType t;
    if ((err = cudaGraphNodeGetType(n, &t)) != cudaSuccess) return err;
    switch (t) {
      case cudaGraphNodeTypeKernel:
      case cudaGraphNodeTypeMemcpy:
      case cudaGraphNodeTypeMemset:
      case cudaGraphNodeTypeEmpty:
      case cudaGraphNodeTypeConditional:
        break;
      case cudaGraphNodeTypeGraph: {
        cudaGraph_t child;
        if ((err = cudaGraphChildGraphNodeGetGraph(n, &child)) != cudaSuccess)
          return err;
        if ((err = first_bad(child, bad)) != cudaSuccess || *bad >= 0)
          return err;
        break;
      }
      default:
        *bad = (int)t;
        return cudaSuccess;
    }
  }
  return cudaSuccess;
}

// Nodes of g, counting through child graphs (a child-graph node counts
// itself and its graph's nodes).
cudaError_t count(cudaGraph_t g, long long* total) {
  std::vector<cudaGraphNode_t> nodes;
  cudaError_t err = nodes_of(g, &nodes);
  if (err != cudaSuccess) return err;
  for (cudaGraphNode_t n : nodes) {
    *total += 1;
    cudaGraphNodeType t;
    if ((err = cudaGraphNodeGetType(n, &t)) != cudaSuccess) return err;
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      if ((err = cudaGraphChildGraphNodeGetGraph(n, &child)) != cudaSuccess)
        return err;
      if ((err = count(child, total)) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

void destroy(Program* p) {
  if (p->exec) cudaGraphExecDestroy(p->exec);
  if (p->outer) cudaGraphDestroy(p->outer);
  delete p;
}

// Adds the program's init kernel and WHILE node to graph g after `deps`
// (its handles created on g) and returns the WHILE node in *last. Counts
// the nodes into p->nodes when `count_nodes` is set.
cudaError_t build(Program* p, cudaGraph_t g, const cudaGraphNode_t* deps,
                  size_t ndeps, cudaGraphNode_t* last, bool count_nodes) {
  const int nblocks = (int)p->blocks.size();
  int stop_pc = nblocks;
  long long* ctrl = p->ctrl;
  const int* succ = p->succ;
  const int* meta = p->meta;
  int start = p->start, max_iters = p->max_iters, width = p->width;
  IfHandles ifs = {};
  cudaGraphConditionalHandle loop;
  cudaGraphNode_t init, wnode, dispatch, advance;
  std::vector<cudaGraphNode_t> ifnodes(nblocks);
  void* init_args[] = {&ctrl, &start, &stop_pc, &max_iters, &loop};
  void* dispatch_args[] = {&ctrl, &ifs, &stop_pc};
  void* advance_args[] = {&ctrl, &succ, &meta, &width, &stop_pc,
                          &max_iters, &loop};
  cudaError_t err;
#define CG_TRY(call) \
  if ((err = (call)) != cudaSuccess) return err
  cudaGraph_t body;
  CG_TRY(cudaGraphConditionalHandleCreate(&loop, g, 0, 0));
  CG_TRY(add_kernel(&init, g, deps, ndeps, (void*)cg_init, init_args));
  CG_TRY(add_conditional(&wnode, g, &init, 1, loop, cudaGraphCondTypeWhile,
                         &body));
  for (int b = 0; b < nblocks; ++b)
    CG_TRY(cudaGraphConditionalHandleCreate(&ifs.h[b], body, 0, 0));
  // the kernel node copies its arguments, the handles among them
  CG_TRY(add_kernel(&dispatch, body, nullptr, 0, (void*)cg_dispatch,
                    dispatch_args));
  // init, WHILE, dispatch, advance; per block its IF node and child node
  if (count_nodes) p->nodes = 4 + 2LL * nblocks;
  for (int b = 0; b < nblocks; ++b) {
    cudaGraphNode_t child;
    cudaGraph_t if_body;
    CG_TRY(add_conditional(&ifnodes[b], body, &dispatch, 1, ifs.h[b],
                           cudaGraphCondTypeIf, &if_body));
    CG_TRY(cudaGraphAddChildGraphNode(&child, if_body, nullptr, 0,
                                      p->blocks[b]));
    if (count_nodes) CG_TRY(count(p->blocks[b], &p->nodes));
  }
  CG_TRY(add_kernel(&advance, body, ifnodes.data(), nblocks,
                    (void*)cg_advance, advance_args));
#undef CG_TRY
  *last = wnode;
  return cudaSuccess;
}

}  // namespace

// Versions: out[0] the toolkit the library was built with (CUDART_VERSION),
// out[1] the runtime it runs, out[2] the driver's.
extern "C" int repro_cond_graph_versions(int* out) {
  out[0] = CUDART_VERSION;
  cudaError_t err = cudaRuntimeGetVersion(&out[1]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDriverGetVersion(&out[2]);
}

extern "C" int repro_cond_graph_check(void* graph, int* bad) {
  *bad = -1;
  return (int)first_bad(static_cast<cudaGraph_t>(graph), bad);
}

extern "C" int repro_cond_graph_count(void* graph, long long* total) {
  *total = 0;
  return (int)count(static_cast<cudaGraph_t>(graph), total);
}

// Builds and instantiates the program over `nblocks` block graphs (each is
// cloned into its IF body; the caller keeps them alive while the program
// lives, for repro_cond_graph_nest). ctrl, succ and meta are device buffers
// the caller allocated and keeps alive: ctrl int64[4], succ
// int32[nblocks * width], meta int32[nblocks * 2].
extern "C" int repro_cond_graph_create(void* const* blocks, int nblocks,
                                       int start, int max_iters,
                                       long long* ctrl,
                                       const int* succ, const int* meta,
                                       int width, int device, void** out) {
  *out = nullptr;
  if (nblocks <= 0 || nblocks > kMaxBlocks || start < 0 ||
      start >= nblocks || width <= 0 || max_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Program* p = new Program;
  p->device = device;
  for (int b = 0; b < nblocks; ++b)
    p->blocks.push_back(static_cast<cudaGraph_t>(blocks[b]));
  p->start = start;
  p->max_iters = max_iters;
  p->width = width;
  p->ctrl = ctrl;
  p->succ = succ;
  p->meta = meta;
  cudaGraphNode_t last;
  if ((err = cudaGraphCreate(&p->outer, 0)) != cudaSuccess ||
      (err = build(p, p->outer, nullptr, 0, &last, true)) != cudaSuccess ||
      (err = cudaGraphInstantiate(&p->exec, p->outer, 0)) != cudaSuccess) {
    destroy(p);
    return (int)err;
  }
  *out = p;
  return (int)cudaSuccess;
}

extern "C" int repro_cond_graph_launch(void* prog, void* stream) {
  Program* p = static_cast<Program*>(prog);
  cudaError_t err = cudaSetDevice(p->device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGraphLaunch(p->exec, static_cast<cudaStream_t>(stream));
}

// Builds the program's nodes into the graph `stream` is capturing, after
// the capture's current dependencies, and continues the capture after the
// WHILE node. cudaErrorStreamCaptureImplicit when the stream is not
// capturing.
extern "C" int repro_cond_graph_nest(void* prog, void* stream) {
  Program* p = static_cast<Program*>(prog);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaGraph_t g;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &g, &deps,
                                             nullptr, &ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &g, &deps,
                                             &ndeps);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  // the dependency array is valid until the next call on the stream
  std::vector<cudaGraphNode_t> after(deps, deps + ndeps);
  cudaGraphNode_t last;
  err = build(p, g, after.data(), after.size(), &last, false);
  if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 13000
  return (int)cudaStreamUpdateCaptureDependencies(
      s, &last, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return (int)cudaStreamUpdateCaptureDependencies(
      s, &last, 1, cudaStreamSetCaptureDependencies);
#endif
}

// Nodes of the whole program: the outer graph, the WHILE body and every IF
// body, each through its child graphs (counted from the blocks' graphs
// while the program was built).
extern "C" int repro_cond_graph_nodes(void* prog, long long* total) {
  *total = static_cast<Program*>(prog)->nodes;
  return (int)cudaSuccess;
}

extern "C" int repro_cond_graph_destroy(void* prog) {
  destroy(static_cast<Program*>(prog));
  return (int)cudaSuccess;
}

#else  // CUDART_VERSION < 12040: no conditional nodes in this toolkit

extern "C" int repro_cond_graph_versions(int* out) {
  out[0] = CUDART_VERSION;
  cudaError_t err = cudaRuntimeGetVersion(&out[1]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDriverGetVersion(&out[2]);
}
extern "C" int repro_cond_graph_check(void*, int*) {
  return (int)cudaErrorNotSupported;
}
extern "C" int repro_cond_graph_count(void*, long long*) {
  return (int)cudaErrorNotSupported;
}
extern "C" int repro_cond_graph_create(void* const*, int, int, int,
                                       long long*,
                                       const int*, const int*, int, int,
                                       void**) {
  return (int)cudaErrorNotSupported;
}
extern "C" int repro_cond_graph_nest(void*, void*) {
  return (int)cudaErrorNotSupported;
}
extern "C" int repro_cond_graph_launch(void*, void*) {
  return (int)cudaErrorNotSupported;
}
extern "C" int repro_cond_graph_nodes(void*, long long*) {
  return (int)cudaErrorNotSupported;
}
extern "C" int repro_cond_graph_destroy(void*) {
  return (int)cudaErrorNotSupported;
}

#endif

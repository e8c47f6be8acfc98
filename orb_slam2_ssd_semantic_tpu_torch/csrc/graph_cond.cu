// Conditional nodes in a CUDA graph being captured: the card's half of
// `mapping/graph_cond.py::device_cond`, the port's `lax.cond`.
//
// `graph_cond(0, stream, pred, body)`, while `stream` is capturing into a
// graph (or into the body of another conditional node):
//   1. makes a conditional handle in that graph;
//   2. captures a one-thread kernel that sets the handle from the device
//      bool `*pred` when the graph runs;
//   3. adds an if-node on the handle after it, makes it the stream's only
//      capture dependency, and
//   4. starts capturing `body` into the node's body graph.
// `graph_cond(1, stream, pred, body)` ends the body's capture; the work
// captured on `stream` afterwards runs after the conditional node.
// `graph_cond(2, out, nullptr, nullptr)` makes a non-blocking stream on the
// current device and writes it to `*out`: a body's stream must be none
// that is capturing, and PyTorch hands out its pooled streams in turn.
//
// A body graph takes kernel, memset, device-to-device copy, empty, child
// graph and conditional nodes; anything else fails its capture, which the
// caller raises. Needs CUDA 12.4 (nested conditional nodes, capture into
// a given graph).

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

int begin_if(cudaStream_t stream, const bool* pred, cudaStream_t body) {
    cudaStreamCaptureStatus status;
    unsigned long long id;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps;
    size_t n_deps;
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (status != cudaStreamCaptureStatusActive)
        return static_cast<int>(cudaErrorIllegalState);
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_condition<<<1, 1, 0, stream>>>(handle, pred);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // The dependencies now end at the kernel just captured.
    err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeIf;
    params.conditional.size = 1;
    cudaGraphNode_t node;
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaStreamBeginCaptureToGraph(
        body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
        cudaStreamCaptureModeThreadLocal));
}

int end_if(cudaStream_t body) {
    cudaGraph_t graph;
    return static_cast<int>(cudaStreamEndCapture(body, &graph));
}

}  // namespace

extern "C" {

// op 0: begin an if-node on `*pred` (a device bool) in the graph `stream`
// captures, and capture `body` into its body; op 1: end that capture; op 2:
// make a stream for bodies into `*(cudaStream_t*)stream`. Returns the CUDA
// error code (0 = success).
int graph_cond(int op, void* stream, const void* pred, void* body) {
    if (op == 0)
        return begin_if(static_cast<cudaStream_t>(stream), static_cast<const bool*>(pred),
                        static_cast<cudaStream_t>(body));
    if (op == 1) return end_if(static_cast<cudaStream_t>(body));
    if (op == 2)
        return static_cast<int>(
            cudaStreamCreateWithFlags(static_cast<cudaStream_t*>(stream), cudaStreamNonBlocking));
    return static_cast<int>(cudaErrorInvalidValue);
}

const char* kernel_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

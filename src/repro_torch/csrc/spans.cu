// Replay markers and the capture-time count of a graph's device nodes: the
// two native pieces of the region map of a captured step
// (src/repro_torch/spans.py).
//
// Replaces no TPU kernel.  Host ranges do not reach the kernels of a
// replayed CUDA graph (the profiler ties each of them to the one graph
// launch), so the map is made at capture instead: at each region boundary
// the host asks how many device nodes (kernel, memcpy and memset nodes) the
// stream's capture holds so far.  The nodes of a single-stream capture
// form one chain and run in the order they were captured, so two empty
// kernels captured first and last, repro_replay_begin and repro_replay_end,
// lay the map onto a device trace on the trace's own clock.
//
// Cost: each marker is an empty <<<1, 1>>> launch, a few microseconds of a
// replay.  The count runs on the host only while a graph is captured: the
// graph's nodes are listed once a boundary (cudaGraphGetNodes copies the
// node handles) and only the nodes added since the last boundary are asked
// their type, so a capture stays linear in its node count.

#include <cuda_runtime.h>

#include <cstddef>
#include <mutex>
#include <vector>

extern "C" __global__ void repro_replay_begin() {}
extern "C" __global__ void repro_replay_end() {}

// Launches repro_replay_begin (which == 0) or repro_replay_end (which == 1)
// on ``stream``; returns cudaGetLastError().
extern "C" int spans_marker_launch(int which, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (which == 0)
    repro_replay_begin<<<1, 1, 0, st>>>();
  else
    repro_replay_end<<<1, 1, 0, st>>>();
  return (int)cudaGetLastError();
}

namespace {

std::mutex mu;
unsigned long long capture_id = 0;     // the capture the state below counts
size_t seen = 0;                       // its nodes already asked their type
long long device_nodes = 0;            // of them, kernel / memcpy / memset
cudaGraphNode_t last = nullptr;        // the last of them
std::vector<cudaGraphNode_t> nodes;

bool is_device(cudaGraphNodeType t) {
  return t == cudaGraphNodeTypeKernel || t == cudaGraphNodeTypeMemcpy ||
         t == cudaGraphNodeTypeMemset;
}

}  // namespace

// The number of device nodes (kernel, memcpy and memset) that the capture
// active on ``stream`` holds so far; -1 when the stream is not capturing,
// -2 - err when a CUDA call fails with err.
extern "C" long long spans_capture_device_nodes(void* stream) {
  std::lock_guard<std::mutex> lock(mu);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &id, &graph);
  if (err != cudaSuccess) return -2 - (long long)err;
  if (status != cudaStreamCaptureStatusActive) return -1;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return -2 - (long long)err;
  if (id != capture_id) {
    capture_id = id;
    seen = 0;
    device_nodes = 0;
    last = nullptr;
  }
  if (n == seen) return device_nodes;
  nodes.resize(n);
  err = cudaGraphGetNodes(graph, nodes.data(), &n);
  if (err != cudaSuccess) return -2 - (long long)err;
  // the list keeps the order of creation, so the new nodes are its tail;
  // where it did not (the last node counted moved), count them all again
  if (seen > 0 && (seen > n || nodes[seen - 1] != last)) {
    seen = 0;
    device_nodes = 0;
  }
  for (size_t i = seen; i < n; ++i) {
    cudaGraphNodeType t;
    err = cudaGraphNodeGetType(nodes[i], &t);
    if (err != cudaSuccess) return -2 - (long long)err;
    device_nodes += is_device(t);
  }
  seen = n;
  last = n > 0 ? nodes[n - 1] : nullptr;
  return device_nodes;
}

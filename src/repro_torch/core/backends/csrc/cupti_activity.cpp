// TALP's device records on the card straight from CUPTI's activity API:
// one row per kernel, memcpy and memset, read at a drain by a forced
// flush of CUPTI's buffers, with no profiler session to stop and no
// event tree to build. Host code only, with a plain C interface for
// ctypes (repro_torch/core/backends/cuda_runtime.py::CuptiActivity).
//
// The CUPTI library is not linked: talp_cupti_init() takes the path of
// the libcupti the process has already loaded (PyTorch's, for Kineto)
// and resolves the entry points from that copy, so that one CUPTI
// instance serves both. A record is read through the fields every
// version of its struct shares (kind, start, end, deviceId, streamId,
// correlationId); their offsets are checked against the header's structs
// at compile time.

#include <cupti.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

namespace {

struct Row {
  int64_t start, end, corr;
  uint32_t stream, device;
  uint8_t kind;  // 0 kernel, 1 memcpy or memset (DeviceActivity codes)
};

// The leading fields of CUpti_ActivityKernel4..9 and of the memcpy and
// memset records.
struct KernelHead {
  CUpti_ActivityKind kind;
  uint8_t cache_config, shared_memory_config;
  uint16_t registers_per_thread;
  uint32_t partitioned_requested, partitioned_executed;
  uint64_t start, end, completed;
  uint32_t device_id, context_id, stream_id;
  int32_t grid[3], block[3];
  int32_t static_shared, dynamic_shared;
  uint32_t local_per_thread, local_total;
  uint32_t correlation_id;
};
struct CopyHead {  // memcpy: copyKind, srcKind, dstKind, flags; memset: value
  CUpti_ActivityKind kind;
  uint32_t kinds_or_value;
  uint64_t bytes, start, end;
  uint32_t device_id, context_id, stream_id, correlation_id;
};
static_assert(offsetof(KernelHead, start) == offsetof(CUpti_ActivityKernel4, start), "kernel start");
static_assert(offsetof(KernelHead, end) == offsetof(CUpti_ActivityKernel4, end), "kernel end");
static_assert(offsetof(KernelHead, device_id) == offsetof(CUpti_ActivityKernel4, deviceId), "kernel device");
static_assert(offsetof(KernelHead, stream_id) == offsetof(CUpti_ActivityKernel4, streamId), "kernel stream");
static_assert(offsetof(KernelHead, correlation_id) == offsetof(CUpti_ActivityKernel4, correlationId), "kernel correlation");
static_assert(offsetof(CopyHead, start) == offsetof(CUpti_ActivityMemcpy, start), "memcpy start");
static_assert(offsetof(CopyHead, stream_id) == offsetof(CUpti_ActivityMemcpy, streamId), "memcpy stream");
static_assert(offsetof(CopyHead, correlation_id) == offsetof(CUpti_ActivityMemcpy, correlationId), "memcpy correlation");
static_assert(offsetof(CopyHead, start) == offsetof(CUpti_ActivityMemset, start), "memset start");
static_assert(offsetof(CopyHead, stream_id) == offsetof(CUpti_ActivityMemset, streamId), "memset stream");
static_assert(offsetof(CopyHead, correlation_id) == offsetof(CUpti_ActivityMemset, correlationId), "memset correlation");

const CUpti_ActivityKind kKinds[] = {CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL,
                                     CUPTI_ACTIVITY_KIND_MEMCPY,
                                     CUPTI_ACTIVITY_KIND_MEMSET};
constexpr size_t kBufferBytes = 8 << 20;

decltype(&cuptiActivityRegisterCallbacks) p_register = nullptr;
decltype(&cuptiActivityEnable) p_enable = nullptr;
decltype(&cuptiActivityDisable) p_disable = nullptr;
decltype(&cuptiActivityFlushAll) p_flush = nullptr;
decltype(&cuptiActivityGetNextRecord) p_next = nullptr;
decltype(&cuptiActivityGetNumDroppedRecords) p_dropped = nullptr;
decltype(&cuptiGetResultString) p_result_string = nullptr;
decltype(&cuptiGetTimestamp) p_timestamp = nullptr;

std::mutex mu;
std::vector<Row> rows;
uint64_t dropped = 0;

void CUPTIAPI buffer_requested(uint8_t** buffer, size_t* size,
                               size_t* max_records) {
  *buffer = static_cast<uint8_t*>(std::aligned_alloc(8, kBufferBytes));
  *size = *buffer ? kBufferBytes : 0;
  *max_records = 0;
}

void CUPTIAPI buffer_completed(CUcontext ctx, uint32_t stream,
                               uint8_t* buffer, size_t size,
                               size_t valid) {
  std::vector<Row> got;
  CUpti_Activity* rec = nullptr;
  while (valid && p_next(buffer, valid, &rec) == CUPTI_SUCCESS) {
    if (rec->kind == CUPTI_ACTIVITY_KIND_CONCURRENT_KERNEL ||
        rec->kind == CUPTI_ACTIVITY_KIND_KERNEL) {
      auto* k = reinterpret_cast<const KernelHead*>(rec);
      got.push_back({static_cast<int64_t>(k->start),
                     static_cast<int64_t>(k->end), k->correlation_id,
                     k->stream_id, k->device_id, 0});
    } else if (rec->kind == CUPTI_ACTIVITY_KIND_MEMCPY ||
               rec->kind == CUPTI_ACTIVITY_KIND_MEMSET) {
      auto* c = reinterpret_cast<const CopyHead*>(rec);
      got.push_back({static_cast<int64_t>(c->start),
                     static_cast<int64_t>(c->end), c->correlation_id,
                     c->stream_id, c->device_id, 1});
    }
  }
  size_t lost = 0;
  if (p_dropped) p_dropped(ctx, stream, &lost);
  std::free(buffer);
  std::lock_guard<std::mutex> lock(mu);
  rows.insert(rows.end(), got.begin(), got.end());
  dropped += lost;
}

}  // namespace

extern "C" {

// Resolve CUPTI's entry points from the copy at ``path`` (already loaded
// by the process: RTLD_NOLOAD, or loaded here). 0 on success; -1 when the
// library cannot be opened, -2 when an entry point is missing.
int talp_cupti_init(const char* path) {
  if (p_register) return 0;
  void* lib = dlopen(path, RTLD_NOW | RTLD_NOLOAD);
  if (!lib) lib = dlopen(path, RTLD_NOW);
  if (!lib) return -1;
  p_register = reinterpret_cast<decltype(p_register)>(dlsym(lib, "cuptiActivityRegisterCallbacks"));
  p_enable = reinterpret_cast<decltype(p_enable)>(dlsym(lib, "cuptiActivityEnable"));
  p_disable = reinterpret_cast<decltype(p_disable)>(dlsym(lib, "cuptiActivityDisable"));
  p_flush = reinterpret_cast<decltype(p_flush)>(dlsym(lib, "cuptiActivityFlushAll"));
  p_next = reinterpret_cast<decltype(p_next)>(dlsym(lib, "cuptiActivityGetNextRecord"));
  p_dropped = reinterpret_cast<decltype(p_dropped)>(dlsym(lib, "cuptiActivityGetNumDroppedRecords"));
  p_result_string = reinterpret_cast<decltype(p_result_string)>(dlsym(lib, "cuptiGetResultString"));
  p_timestamp = reinterpret_cast<decltype(p_timestamp)>(dlsym(lib, "cuptiGetTimestamp"));
  if (!p_register || !p_enable || !p_disable || !p_flush || !p_next ||
      !p_timestamp) {
    p_register = nullptr;
    return -2;
  }
  return 0;
}

// Register the buffer callbacks (another CUPTI client, such as Kineto,
// registers its own when it starts) and enable kernel, memcpy and memset
// records. A CUptiResult: 0 on success.
int talp_cupti_enable() {
  int err = p_register(buffer_requested, buffer_completed);
  for (CUpti_ActivityKind kind : kKinds)
    if (!err) err = p_enable(kind);
  return err;
}

// Deliver every record of the work finished so far (``forced``: also
// from buffers not yet full), then, with ``disable``, stop recording.
int talp_cupti_flush(int forced, int disable) {
  int err = p_flush(forced ? CUPTI_ACTIVITY_FLAG_FLUSH_FORCED : 0);
  if (disable)
    for (CUpti_ActivityKind kind : kKinds) {
      int e = p_disable(kind);
      if (!err) err = e;
    }
  return err;
}

int64_t talp_cupti_count() {
  std::lock_guard<std::mutex> lock(mu);
  return static_cast<int64_t>(rows.size());
}

// Move the first ``cap`` buffered rows into the columns; their number.
int64_t talp_cupti_take(uint8_t* kinds, int64_t* starts, int64_t* ends,
                        uint32_t* streams, int64_t* corrs,
                        uint32_t* devices, int64_t cap) {
  std::lock_guard<std::mutex> lock(mu);
  int64_t n = std::min<int64_t>(cap, static_cast<int64_t>(rows.size()));
  for (int64_t i = 0; i < n; ++i) {
    const Row& r = rows[i];
    kinds[i] = r.kind;
    starts[i] = r.start;
    ends[i] = r.end;
    streams[i] = r.stream;
    corrs[i] = r.corr;
    devices[i] = r.device;
  }
  rows.erase(rows.begin(), rows.begin() + n);
  return n;
}

// Records CUPTI dropped (buffers full before they were handed over).
uint64_t talp_cupti_dropped() {
  std::lock_guard<std::mutex> lock(mu);
  return dropped;
}

// CUPTI's clock now, in the units of its records.
uint64_t talp_cupti_timestamp() {
  uint64_t t = 0;
  p_timestamp(&t);
  return t;
}

const char* talp_cupti_error(int code) {
  const char* s = nullptr;
  if (p_result_string)
    p_result_string(static_cast<CUptiResult>(code), &s);
  return s ? s : "unknown CUPTI error";
}

}  // extern "C"

// Guard-page allocator for scripts/sanitize.py: every allocation PyTorch
// makes gets pages of its own, placed against a reserved page that is never
// mapped, so a kernel that reads or writes past the edge of a tensor faults
// (cudaErrorIllegalAddress) instead of landing in a neighbour's memory, as
// it may in the caching allocator's shared segments. Not a kernel port, and
// not part of the kernel library (csrc/*.cu): sanitize.py builds it alone
// and installs it with torch.cuda.memory.CUDAPluggableAllocator.
//
// SML_FENCE (read at the first allocation) picks the edge:
//   tail: the tensor ends where the guard page starts; its start is aligned
//         down to 16 bytes, so an over-run inside the last 16-byte chunk of a
//         tensor whose size is not a multiple of 16 is not caught;
//   head: the tensor starts where the guard page ends (an under-run faults).
// Every mapped byte is first set to 0xFF on the allocating stream, so a read
// of memory nothing wrote gives NaN (f32, bf16) or -1 (int) and shows in the
// comparison with the plain version. free() waits for the card before it
// unmaps. The virtual-memory calls come from the driver through
// cudaGetDriverEntryPoint, so nothing links libcuda.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <sys/types.h>

#include <mutex>
#include <unordered_map>

namespace {

struct Region {
  CUdeviceptr va;
  size_t reserved;
  CUdeviceptr mapped_at;
  size_t mapped;
  CUmemGenericAllocationHandle handle;
};

struct Api {
  decltype(&cuDeviceGet) device_get = nullptr;
  decltype(&cuMemGetAllocationGranularity) granularity = nullptr;
  decltype(&cuMemAddressReserve) reserve = nullptr;
  decltype(&cuMemAddressFree) address_free = nullptr;
  decltype(&cuMemCreate) create = nullptr;
  decltype(&cuMemRelease) release = nullptr;
  decltype(&cuMemMap) map = nullptr;
  decltype(&cuMemUnmap) unmap = nullptr;
  decltype(&cuMemSetAccess) set_access = nullptr;
  decltype(&cuMemsetD8Async) memset_async = nullptr;
  bool ok = false;
};

std::mutex mu;
std::unordered_map<uintptr_t, Region> regions;
long long n_allocs = 0, n_live = 0, n_failed = 0;
int mode = -1;  // 0 tail, 1 head

template <typename F>
bool entry(const char* name, F* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q) !=
          cudaSuccess ||
      q != cudaDriverEntryPointSuccess || p == nullptr) {
    std::fprintf(stderr, "fence_alloc: no driver entry point %s\n", name);
    return false;
  }
  *fn = reinterpret_cast<F>(p);
  return true;
}

Api& api() {
  static Api a = [] {
    Api x;
    x.ok = entry("cuDeviceGet", &x.device_get) &&
           entry("cuMemGetAllocationGranularity", &x.granularity) &&
           entry("cuMemAddressReserve", &x.reserve) &&
           entry("cuMemAddressFree", &x.address_free) &&
           entry("cuMemCreate", &x.create) &&
           entry("cuMemRelease", &x.release) &&
           entry("cuMemMap", &x.map) && entry("cuMemUnmap", &x.unmap) &&
           entry("cuMemSetAccess", &x.set_access) &&
           entry("cuMemsetD8Async", &x.memset_async);
    return x;
  }();
  return a;
}

void* fail(const char* what, int code) {
  std::fprintf(stderr, "fence_alloc: %s failed with %d\n", what, code);
  ++n_failed;
  return nullptr;
}

}  // namespace

extern "C" void* sml_fence_malloc(ssize_t size, int device,
                                  cudaStream_t stream) {
  if (size <= 0) return nullptr;
  std::lock_guard<std::mutex> lock(mu);
  if (mode < 0) {
    const char* m = std::getenv("SML_FENCE");
    mode = (m != nullptr && std::strcmp(m, "head") == 0) ? 1 : 0;
  }
  Api& a = api();
  if (!a.ok) return nullptr;
  if (cudaSetDevice(device) != cudaSuccess) return nullptr;
  CUdevice dev;
  CUresult r = a.device_get(&dev, device);
  if (r != CUDA_SUCCESS) return fail("cuDeviceGet", r);
  CUmemAllocationProp prop = {};
  prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  prop.location.id = dev;
  size_t gran = 0;
  r = a.granularity(&gran, &prop, CU_MEM_ALLOC_GRANULARITY_MINIMUM);
  if (r != CUDA_SUCCESS) return fail("granularity", r);
  const size_t bytes = static_cast<size_t>(size);
  const size_t mapped = (bytes + gran - 1) / gran * gran;
  Region g = {};
  g.reserved = mapped + gran;
  g.mapped = mapped;
  r = a.reserve(&g.va, g.reserved, gran, 0, 0);
  if (r != CUDA_SUCCESS) return fail("cuMemAddressReserve", r);
  // tail: [mapped | guard]; head: [guard | mapped]
  g.mapped_at = mode == 1 ? g.va + gran : g.va;
  r = a.create(&g.handle, mapped, &prop, 0);
  if (r != CUDA_SUCCESS) {
    a.address_free(g.va, g.reserved);
    return fail("cuMemCreate", r);
  }
  r = a.map(g.mapped_at, mapped, 0, g.handle, 0);
  if (r != CUDA_SUCCESS) {
    a.release(g.handle);
    a.address_free(g.va, g.reserved);
    return fail("cuMemMap", r);
  }
  CUmemAccessDesc desc = {};
  desc.location = prop.location;
  desc.flags = CU_MEM_ACCESS_FLAGS_PROT_READWRITE;
  r = a.set_access(g.mapped_at, mapped, &desc, 1);
  if (r == CUDA_SUCCESS)
    r = a.memset_async(g.mapped_at, 0xFF, mapped,
                       reinterpret_cast<CUstream>(stream));
  if (r != CUDA_SUCCESS) {
    a.unmap(g.mapped_at, mapped);
    a.release(g.handle);
    a.address_free(g.va, g.reserved);
    return fail("cuMemSetAccess/cuMemsetD8Async", r);
  }
  CUdeviceptr p = mode == 1 ? g.mapped_at
                            : (g.mapped_at + mapped - bytes) & ~CUdeviceptr(15);
  regions[static_cast<uintptr_t>(p)] = g;
  ++n_allocs;
  ++n_live;
  return reinterpret_cast<void*>(p);
}

extern "C" void sml_fence_free(void* ptr, ssize_t, int device,
                               cudaStream_t) {
  if (ptr == nullptr) return;
  std::lock_guard<std::mutex> lock(mu);
  auto it = regions.find(reinterpret_cast<uintptr_t>(ptr));
  if (it == regions.end()) {
    std::fprintf(stderr, "fence_alloc: free of unknown pointer %p\n", ptr);
    ++n_failed;
    return;
  }
  Region g = it->second;
  regions.erase(it);
  Api& a = api();
  cudaSetDevice(device);
  // the pages may still be read or written by work in flight on any stream
  cudaDeviceSynchronize();
  a.unmap(g.mapped_at, g.mapped);
  a.release(g.handle);
  a.address_free(g.va, g.reserved);
  --n_live;
}

// allocations made, live now, calls that failed; the fence's mode (0 tail,
// 1 head, -1 before the first allocation)
extern "C" void sml_fence_stats(long long* out) {
  std::lock_guard<std::mutex> lock(mu);
  out[0] = n_allocs;
  out[1] = n_live;
  out[2] = n_failed;
  out[3] = mode;
}

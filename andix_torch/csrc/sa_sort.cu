// The doubling loop's library sort: CUB's radix sort of (int64 key,
// int32 suffix) pairs, from the CUDA toolkit's headers.
//
// It takes the place of torch.sort around the loop's hand kernels
// (doubling.cu), as lax.sort sits between andix's passes: it is a
// library's sort, not a ported kernel.  Two things make it cheaper than
// torch.sort's, which sorts all 64 bits and carries int64 indices: the
// values are the suffixes themselves, int32 (sa_keys writes them), and
// the radix passes stop at the key's highest bit (a round's keys are
// below (n + 1)^2: 54 bits at 100,663,296 positions, 7 passes of 8 bits
// for torch.sort's 8).  The keys are non-negative, so they sort as
// unsigned.  The sort runs in place over two buffers of each (CUB's
// DoubleBuffer); which one holds the result is known on the host when
// the call returns.

#include <cub/device/device_radix_sort.cuh>

// the temporary bytes a sort of m pairs over end_bit bits needs
extern "C" long long andix_sa_sort_temp_bytes(long long m, int end_bit) {
  size_t bytes = 0;
  cub::DoubleBuffer<unsigned long long> keys(nullptr, nullptr);
  cub::DoubleBuffer<int> vals(nullptr, nullptr);
  cub::DeviceRadixSort::SortPairs(nullptr, bytes, keys, vals, (int)m, 0,
                                  end_bit);
  return (long long)bytes;
}

// Sorts m (keys[i], vals[i]) by the key's bits [0, end_bit), using
// keys_alt and vals_alt as the second buffers and `temp`
// (andix_sa_sort_temp_bytes) as CUB's scratch; *selector receives 0 when
// the result is in keys and vals, 1 when in keys_alt and vals_alt.
// Returns the CUDA error of the call, or cudaGetLastError.
extern "C" int andix_sa_sort(unsigned long long* keys,
                             unsigned long long* keys_alt, int* vals,
                             int* vals_alt, long long m, int end_bit,
                             void* temp, long long temp_bytes, int* selector,
                             void* stream) {
  cub::DoubleBuffer<unsigned long long> k(keys, keys_alt);
  cub::DoubleBuffer<int> v(vals, vals_alt);
  size_t bytes = (size_t)temp_bytes;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      temp, bytes, k, v, (int)m, 0, end_bit, (cudaStream_t)stream);
  *selector = k.selector;
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

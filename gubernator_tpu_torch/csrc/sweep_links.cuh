// sweep_links.cuh: group a window's entries by target inside one block.
//
// The TPU sweeps sum every window entry that names a target with one-hot
// matmuls. A Hopper block instead links the entries that share a target:
// key[j] is entry j's target in the block (-1: none), and after
// link_keys head[j] is 1 for the first entry of each target and nxt[j]
// is the next entry with the same target (-1 at the end). The head's
// thread then walks the chain and owns every store to that target, so no
// two threads write one address and the sums need no atomics.
//
// All three arrays live in shared memory; the caller syncs before and
// after. O(n^2) compares in the worst case, which is small next to the
// window's global loads at the windows these kernels take (n <= 2048).

#pragma once

__device__ inline void link_keys(const int* key, int* nxt, unsigned char* head, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int k = key[j];
    int nx = -1;
    unsigned char h = 0;
    if (k >= 0) {
      h = 1;
      for (int p = 0; p < j; ++p) {
        if (key[p] == k) {
          h = 0;
          break;
        }
      }
      for (int p = j + 1; p < n; ++p) {
        if (key[p] == k) {
          nx = p;
          break;
        }
      }
    }
    nxt[j] = nx;
    head[j] = h;
  }
}

// Dynamic shared memory for n entries: key and nxt (int32 each), then
// up to two more int32 arrays (`extra`), then head (bytes).
inline size_t link_smem_bytes(int n, int extra) {
  return (size_t)n * (2 + extra) * sizeof(int) + (size_t)n;
}
